"""Where the program runs: backend choice, caches, native builds and the
entry points' refusal to run without a GPU."""

import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from scalable_collaborative_zksnark_tpu import backend
from scalable_collaborative_zksnark_tpu.utils import benchlib

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("platform,ffi,unrolled,kernels,export", [
    ("cpu", True, False, False, "cpu"),
    ("gpu", False, True, True, "cuda"),
])
def test_backend_choices(monkeypatch, platform, ffi, unrolled, kernels,
                         export):
    monkeypatch.setattr(backend, "platform", lambda: platform)
    assert (backend.native_ffi() is not None) == ffi
    assert backend.unrolled_limbs() == unrolled
    assert backend.point_kernels() == kernels
    assert backend.export_platform() == export


def test_cache_dir_honours_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert benchlib.cache_dir() == tmp_path


def test_cache_dir_fallback_is_fixed_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert benchlib.cache_dir() == REPO / ".jax_cache"
    assert benchlib.cache_dir() == benchlib.cache_dir()


def test_native_build_rebuilds_on_foreign_stamp(tmp_path):
    """A library whose stamp records another source, command or host is
    rebuilt, never loaded as it is."""
    from scalable_collaborative_zksnark_tpu.native import build_library

    if shutil.which("g++") is None:
        pytest.skip("no C++ compiler")
    src = tmp_path / "k.cc"
    src.write_text('extern "C" int k() { return 7; }\n')
    so = tmp_path / "build" / "libk.so"
    cmd = ["g++", "-O1", "-fPIC", "-shared"]
    assert build_library(src, so, cmd)
    stamp = so.with_suffix(".stamp")
    good = stamp.read_text()
    so.write_bytes(b"not a library built here")
    assert build_library(src, so, cmd)  # stamp matches: reused as is
    assert so.read_bytes() == b"not a library built here"
    stamp.write_text("built-on-another-host")
    assert build_library(src, so, cmd)
    assert stamp.read_text() == good
    assert so.read_bytes().startswith(b"\x7fELF")


def _run(args, cwd):
    env = {"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu", "HOME": str(cwd)}
    return subprocess.run([sys.executable, *args], cwd=str(cwd), env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_fails_without_gpu(tmp_path, where):
    """No GPU (or no repository beside it): non-zero exit, no result."""
    if where == "alone":
        shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    else:
        cwd = REPO
    out = _run([str(cwd / "chip_smoke.py")], cwd)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_bench_fails_without_gpu():
    out = _run([str(REPO / "bench.py"), "--repeat", "1"], REPO)
    assert out.returncode != 0
    assert "no GPU" in out.stderr
    assert not [l for l in out.stdout.splitlines() if l.startswith("{")]
