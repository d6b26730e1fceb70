#!/usr/bin/env python
"""On-GPU smoke test of the collaborative HyperPlonk prover.

Drives the path ``bench.py`` drives — ``packed_proving_parameters`` ->
``precompile_phases`` -> ``dhyperplonk_phased`` -> ``proof_digest`` — in
one process on one GPU, and fails (non-zero exit, no result line) if any
phase fails or there is no GPU:

  1. device: platform, kind, count, JAX version, card name and power
     limit (read by nvidia-smi in a child that never imports JAX);
  2. card tests: the ``gpu``-marked tests, in this process;
  3. kernels: every CUDA kernel compiled at a real width — the point
     ops at the dense-MSM lane width, checked bit for bit against the
     plain jnp form and on a sample of lanes against the native CPU
     oracle; the Fr / Fq field ops at a flagship table size, bit for bit
     against the plain limb form and on a sample against Python ints;
  4. conformance: n = 6, l = 1 prove vs its CPU-pinned digest;
  5. flagship: n = 16, l = 8, leader mode, phased — cold split, three
     warm runs, peak device memory, digest vs its CPU pin.

The seeded SRS of both proves is generated on the CPU by
``scripts/pregen_srs.py`` in a child process (it never opens the card),
which runs while phases 1-3 use the card.

The last line of standard output is the JSON result.  ``--four`` runs
only the four-card check: the sharded sim-mode prove (n = 16, l = 2,
N = 16 parties) over ``Mesh(devices[:4], ("party",))`` against the same
prove on one card.

    python chip_smoke.py            # one GPU
    python chip_smoke.py --four     # four GPUs of one host
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
PKG = REPO / "scalable_collaborative_zksnark_tpu"


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def pregen_srs(configs) -> subprocess.Popen:
    """Seeded SRS for each (n, l), generated on the CPU in a child."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    cmd = " && ".join(
        f"{sys.executable} {REPO / 'scripts' / 'pregen_srs.py'} "
        f"--n {n} --l {l}"
        for n, l in configs
    )
    return subprocess.Popen(["/bin/sh", "-c", cmd], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def wait_srs(child: subprocess.Popen) -> float:
    t0 = time.time()
    out, _ = child.communicate()
    for line in out.splitlines():
        log(f"  srs: {line}")
    if child.returncode != 0:
        raise RuntimeError(f"pregen_srs failed (exit {child.returncode})")
    return time.time() - t0


def phase_device() -> dict:
    import jax

    from scalable_collaborative_zksnark_tpu.utils.benchlib import device_info

    dev = device_info()
    log(f"device: {dev}  jax {jax.__version__}")
    if dev["platform"] != "gpu":
        raise RuntimeError(f"no GPU: JAX computes on {dev['platform']}")
    log(f"nvidia-smi: {nvidia_smi()}")
    return dev


def phase_card_tests() -> None:
    import pytest

    rc = pytest.main([str(REPO / "tests" / "test_gpu.py"), "-m", "gpu",
                      "-q", "-p", "no:cacheprovider", "-p", "no:randomly"])
    if rc != 0:
        raise RuntimeError(f"gpu-marked tests failed (pytest exit {rc})")


def phase_kernels() -> None:
    import jax
    import numpy as np

    from scalable_collaborative_zksnark_tpu import cuda_kernels
    from scalable_collaborative_zksnark_tpu.curves.g1 import bls12_381_g1
    from scalable_collaborative_zksnark_tpu.fields.fr import get_field
    from scalable_collaborative_zksnark_tpu.primitives.msm import DENSE_LANES
    from scalable_collaborative_zksnark_tpu.utils import kernel_check

    cv = bls12_381_g1()
    p1, p2a, p2j, mask, h1, h2 = kernel_check.sample_points(cv, DENSE_LANES)
    for op in cuda_kernels.OPS:
        args = kernel_check.op_args(op, p1, p2a, p2j, mask)
        kern = jax.jit(lambda *a, _op=op: kernel_check.run_kernel(cv, _op, *a))
        plain = jax.jit(lambda *a, _op=op: kernel_check.run_plain(cv, _op, *a))
        t0 = time.time()
        compiled = kern.lower(*args).compile()
        t_compile = time.time() - t0
        got = jax.block_until_ready(compiled(*args))
        want = jax.block_until_ready(plain(*args))
        bad = kernel_check.mismatches(op, got, want)
        if bad:
            raise RuntimeError(f"{op}: kernel != plain jnp on {bad} lanes")
        kernel_check.check_oracle(cv, op, got, h1, h2, np.asarray(mask))
        mem = compiled.memory_analysis()
        log(f"kernel {op}: {DENSE_LANES} lanes bit-exact vs plain jnp and "
            f"oracle sample; compile {t_compile:.1f}s; "
            f"memory_analysis: {mem}")
    m = 1 << 15  # the flagship's per-party gate table
    for name in cuda_kernels.FIELD_IDS:
        F = get_field(name)
        a, b = F.random((m,), 1), F.random((m,), 2)
        for op in cuda_kernels.FIELD_OPS:
            kern = jax.jit(lambda x, y, _o=op, _n=name:
                           cuda_kernels.field_op(_o, _n, x, y))
            compiled = kern.lower(a, b).compile()
            got = jax.block_until_ready(compiled(a, b))
            want = jax.jit(lambda x, y, _o=op, _F=F: _F.plain(_o, x, y))(a, b)
            bad = kernel_check.field_mismatches(got, want)
            if bad:
                raise RuntimeError(f"{name} {op}: kernel != plain on {bad}")
            kernel_check.check_field_ints(F, op, a, b, got)
            log(f"kernel {name} {op}: {m} elements bit-exact vs plain limb "
                f"form and ints sample; memory_analysis: "
                f"{compiled.memory_analysis()}")


def prove(n: int, l: int, warm: int):
    """One phased leader-mode prove at (n, l): returns (out, timings)."""
    import jax

    from scalable_collaborative_zksnark_tpu.hyperplonk import (
        dhyperplonk_phased,
        packed_proving_parameters,
    )
    from scalable_collaborative_zksnark_tpu.hyperplonk.collaborative import (
        precompile_phases,
    )
    from scalable_collaborative_zksnark_tpu.mpc.net import PartyNet

    tm = {}
    net = PartyNet(8 * l, mode="leader")
    t0 = time.time()
    pk = packed_proving_parameters(n, l, net)
    jax.block_until_ready(pk.V)
    tm["setup_s"] = time.time() - t0
    t0 = time.time()
    precompile_phases(n, pk, net)
    tm["trace_compile_s"] = time.time() - t0
    t0 = time.time()
    out = jax.block_until_ready(dhyperplonk_phased(n, pk, net))
    tm["first_run_s"] = time.time() - t0
    runs = []
    for _ in range(warm):
        t0 = time.time()
        out = jax.block_until_ready(dhyperplonk_phased(n, pk, net))
        runs.append(time.time() - t0)
    tm["warm_s"] = runs
    return out, tm


def check_digest(n: int, l: int, out) -> None:
    from bench import CONFORMANCE_PIN
    from scalable_collaborative_zksnark_tpu.utils.benchlib import proof_digest

    d = proof_digest(out)
    pin = CONFORMANCE_PIN[(n, l)]
    log(f"digest n{n}/l{l}: 0x{d:016X} (pin 0x{pin:016X}) "
        f"{'PASS' if d == pin else 'FAIL'}")
    if d != pin:
        raise RuntimeError(f"n{n}/l{l} digest differs from its CPU pin")


def phase_conformance() -> None:
    out, tm = prove(6, 1, warm=0)
    log(f"conformance n6/l1: {tm}")
    check_digest(6, 1, out)


def phase_flagship() -> None:
    import jax

    out, tm = prove(16, 8, warm=3)
    log(f"flagship n16/l8 cold: setup (inputs; SRS from cache) "
        f"{tm['setup_s']:.2f}s, phase trace+compile "
        f"{tm['trace_compile_s']:.2f}s, first run {tm['first_run_s']:.3f}s")
    log(f"flagship n16/l8 warm runs (s): {tm['warm_s']}")
    stats = jax.devices()[0].memory_stats() or {}
    log(f"flagship peak_bytes_in_use: {stats.get('peak_bytes_in_use')}")
    check_digest(16, 8, out)


def four_cards() -> dict:
    """Sharded sim-mode prove on 4 cards vs the same prove on one."""
    import jax

    from scalable_collaborative_zksnark_tpu.utils import multichip
    from scalable_collaborative_zksnark_tpu.utils.benchlib import device_info

    dev = device_info()
    log(f"device: {dev}  jax {jax.__version__}")
    if dev["platform"] != "gpu" or dev["count"] < 4:
        raise RuntimeError(f"--four needs 4 GPUs, JAX found {dev}")
    log(f"nvidia-smi: {nvidia_smi()}")
    from scalable_collaborative_zksnark_tpu.utils.benchlib import (
        enable_compile_cache,
    )

    log(f"compile cache: {enable_compile_cache()}")
    log(f"srs set-up (CPU child): {wait_srs(pregen_srs([(16, 2)])):.1f}s")
    res = multichip.sharded_vs_single(jax.devices()[:4], n=16, l=2, log=log)
    if res["digest_sharded"] != res["digest_single"]:
        raise RuntimeError("4-card digest differs from the 1-card digest")
    return dev


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded check")
    args = ap.parse_args()
    if not PKG.is_dir():
        print("chip_smoke.py: run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    t_start = time.time()
    srs = None
    try:
        if args.four:
            dev = four_cards()
        else:
            dev = phase_device()
            from scalable_collaborative_zksnark_tpu.utils.benchlib import (
                enable_compile_cache,
            )

            log(f"compile cache: {enable_compile_cache()}")
            srs = pregen_srs([(6, 1), (16, 8)])
            t0 = time.time()
            phase_card_tests()
            log(f"phase 2 card tests: {time.time() - t0:.1f}s")
            t0 = time.time()
            phase_kernels()
            log(f"phase 3 kernels: {time.time() - t0:.1f}s")
            log(f"srs set-up (CPU child, waited): {wait_srs(srs):.1f}s")
            t0 = time.time()
            phase_conformance()
            log(f"phase 4 conformance: {time.time() - t0:.1f}s")
            t0 = time.time()
            phase_flagship()
            log(f"phase 5 flagship: {time.time() - t0:.1f}s")
    except Exception as e:  # any failed phase fails the run
        import traceback

        traceback.print_exc()
        print(f"chip_smoke.py: FAILED: {type(e).__name__}: {e}",
              file=sys.stderr)
        return 1
    finally:
        if srs is not None and srs.poll() is None:
            srs.kill()
            srs.wait()
    log(f"total {time.time() - t_start:.1f}s")
    print(json.dumps({"ok": True, "device": dev}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
