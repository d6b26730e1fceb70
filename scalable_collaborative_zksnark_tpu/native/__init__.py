"""ctypes binding to the native BLS12-381 host oracle (native/bls12_381.cc).

Builds the shared library on first use (g++, no external deps) and
exposes the same vocabulary as curves/host_curve.py.  ``available()``
gates every call; callers keep the pure-Python oracle as fallback, so a
missing toolchain degrades gracefully.  All values cross the boundary as
standard-form little-endian u64 limbs (Fq: 6, scalars: byte strings).
"""

from __future__ import annotations

import ctypes
import functools
import subprocess
from pathlib import Path

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
_SRC = _ROOT / "native" / "bls12_381.cc"
_SO = _ROOT / "native" / "build" / "libsczk.so"

P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
FINAL_EXP = (P**12 - 1) // R
_FINAL_EXP_BYTES = FINAL_EXP.to_bytes((FINAL_EXP.bit_length() + 7) // 8, "little")


def _host_key() -> str:
    """Identity of the CPU a ``-march=native`` build targets."""
    import platform

    key = platform.machine()
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                if line.startswith(("model name", "flags", "Features")):
                    key += line
                    if line.startswith(("flags", "Features")):
                        break
    except OSError:
        pass
    return key


def build_library(src: Path, so: Path, cmd: list, required: bool = False,
                  deps=()) -> bool:
    """Build ``so`` from ``src`` with ``cmd`` (compiler argv without the
    ``-o`` output and the source) unless an existing build matches.

    A build is reused only when its stamp records the same source, the
    same command and the same host CPU: a ``-march=native`` library
    copied from another machine is rebuilt, never loaded.  The build
    goes to a temporary name and is renamed into place, so concurrent
    processes never load a half-written library.  ``deps``: headers the
    source includes (part of the stamp).  ``required``: raise with the
    compiler's message instead of returning False."""
    import hashlib
    import os

    h = hashlib.sha256()
    for f in (src, *deps):
        h.update(f.read_bytes())
    h.update(" ".join(cmd).encode())
    h.update(_host_key().encode())
    want = h.hexdigest()
    stamp = so.with_suffix(".stamp")
    if so.exists() and stamp.exists() and stamp.read_text() == want:
        return True
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(
            [*cmd, "-o", str(tmp), str(src)],
            check=True, capture_output=True, timeout=300,
        )
        os.replace(tmp, so)
        stamp.write_text(want)
    except (OSError, subprocess.SubprocessError) as e:
        tmp.unlink(missing_ok=True)
        if required:
            msg = getattr(e, "stderr", b"") or b""
            raise RuntimeError(
                f"building {so.name} failed: {' '.join(cmd)} {src}\n"
                + msg.decode(errors="replace")[-4000:]
            ) from e
        return False
    return True


@functools.lru_cache(maxsize=1)
def _lib():
    if not build_library(
        _SRC, _SO,
        ["g++", "-O2", "-fPIC", "-shared", "-std=c++17", "-march=native"],
    ):
        return None
    try:
        lib = ctypes.CDLL(str(_SO))
    except OSError:
        return None
    u64p = ctypes.POINTER(ctypes.c_uint64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.sczk_pairing_product_is_one.restype = ctypes.c_int
    lib.sczk_pairing_product_is_one.argtypes = [
        ctypes.c_size_t, u64p, u8p, u64p, u8p, u8p, ctypes.c_size_t
    ]
    lib.sczk_g1_add.argtypes = [u64p, ctypes.c_uint8, u64p, ctypes.c_uint8, u64p, u8p]
    lib.sczk_g1_scalar_mul.argtypes = [
        u64p, ctypes.c_uint8, u8p, ctypes.c_size_t, u64p, u8p
    ]
    lib.sczk_g2_add.argtypes = [u64p, ctypes.c_uint8, u64p, ctypes.c_uint8, u64p, u8p]
    lib.sczk_g2_scalar_mul.argtypes = [
        u64p, ctypes.c_uint8, u8p, ctypes.c_size_t, u64p, u8p
    ]
    lib.sczk_g1_msm.argtypes = [
        ctypes.c_size_t, u64p, u8p, u8p, u64p, u8p
    ]
    return lib


def available() -> bool:
    return _lib() is not None


# ---------------------------------------------------------------------------
# conversions: host_curve tuples <-> limb arrays
# ---------------------------------------------------------------------------
def _fq_limbs(x: int) -> np.ndarray:
    return np.frombuffer(int(x).to_bytes(48, "little"), dtype=np.uint64).copy()


def _limbs_fq(a: np.ndarray) -> int:
    return int.from_bytes(a.tobytes(), "little")


def _g1_arr(p):
    """host_curve G1 tuple (x, y) or None -> (12-u64 array, inf flag)."""
    if p is None:
        return np.zeros(12, np.uint64), 1
    return np.concatenate([_fq_limbs(p[0]), _fq_limbs(p[1])]), 0


def _arr_g1(a: np.ndarray, inf: int):
    if inf:
        return None
    return (_limbs_fq(a[:6]), _limbs_fq(a[6:12]))


def _g2_arr(p):
    if p is None:
        return np.zeros(24, np.uint64), 1
    (x0, x1), (y0, y1) = p
    return (
        np.concatenate([_fq_limbs(x0), _fq_limbs(x1), _fq_limbs(y0), _fq_limbs(y1)]),
        0,
    )


def _arr_g2(a: np.ndarray, inf: int):
    if inf:
        return None
    return (
        (_limbs_fq(a[0:6]), _limbs_fq(a[6:12])),
        (_limbs_fq(a[12:18]), _limbs_fq(a[18:24])),
    )


def _u64p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))


def _u8p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


# ---------------------------------------------------------------------------
# public API (host_curve-compatible semantics)
# ---------------------------------------------------------------------------
def pairing_product_is_one(pairs) -> bool:
    """prod e(P_i, Q_i) == 1 for host_curve-style affine tuples."""
    lib = _lib()
    assert lib is not None
    n = len(pairs)
    g1 = np.zeros((max(n, 1), 12), np.uint64)
    g1i = np.zeros(max(n, 1), np.uint8)
    g2 = np.zeros((max(n, 1), 24), np.uint64)
    g2i = np.zeros(max(n, 1), np.uint8)
    for i, (p, q) in enumerate(pairs):
        g1[i], g1i[i] = _g1_arr(p)
        g2[i], g2i[i] = _g2_arr(q)
    exp = np.frombuffer(_FINAL_EXP_BYTES, dtype=np.uint8)
    return bool(
        lib.sczk_pairing_product_is_one(
            n, _u64p(g1), _u8p(g1i), _u64p(g2), _u8p(g2i), _u8p(exp), len(exp)
        )
    )


def g1_add(p1, p2):
    lib = _lib()
    a, ai = _g1_arr(p1)
    b, bi = _g1_arr(p2)
    out = np.zeros(12, np.uint64)
    oi = np.zeros(1, np.uint8)
    lib.sczk_g1_add(_u64p(a), ai, _u64p(b), bi, _u64p(out), _u8p(oi))
    return _arr_g1(out, oi[0])


def g1_mul(p, k):
    lib = _lib()
    a, ai = _g1_arr(p)
    kb = np.frombuffer(int(k % R).to_bytes(32, "little"), dtype=np.uint8)
    out = np.zeros(12, np.uint64)
    oi = np.zeros(1, np.uint8)
    lib.sczk_g1_scalar_mul(_u64p(a), ai, _u8p(kb), 32, _u64p(out), _u8p(oi))
    return _arr_g1(out, oi[0])


def g2_add(p1, p2):
    lib = _lib()
    a, ai = _g2_arr(p1)
    b, bi = _g2_arr(p2)
    out = np.zeros(24, np.uint64)
    oi = np.zeros(1, np.uint8)
    lib.sczk_g2_add(_u64p(a), ai, _u64p(b), bi, _u64p(out), _u8p(oi))
    return _arr_g2(out, oi[0])


def g2_mul(p, k):
    lib = _lib()
    a, ai = _g2_arr(p)
    kb = np.frombuffer(int(k % R).to_bytes(32, "little"), dtype=np.uint8)
    out = np.zeros(24, np.uint64)
    oi = np.zeros(1, np.uint8)
    lib.sczk_g2_scalar_mul(_u64p(a), ai, _u8p(kb), 32, _u64p(out), _u8p(oi))
    return _arr_g2(out, oi[0])


def g1_msm(points, scalars):
    """sum_i k_i P_i over host tuples (test oracle)."""
    lib = _lib()
    n = len(points)
    pts = np.zeros((max(n, 1), 12), np.uint64)
    infs = np.zeros(max(n, 1), np.uint8)
    for i, p in enumerate(points):
        pts[i], infs[i] = _g1_arr(p)
    ks = np.zeros((max(n, 1), 32), np.uint8)
    for i, k in enumerate(scalars):
        ks[i] = np.frombuffer(int(k % R).to_bytes(32, "little"), dtype=np.uint8)
    out = np.zeros(12, np.uint64)
    oi = np.zeros(1, np.uint8)
    lib.sczk_g1_msm(n, _u64p(pts), _u8p(infs), _u8p(ks), _u64p(out), _u8p(oi))
    return _arr_g1(out, oi[0])
