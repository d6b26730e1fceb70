#!/usr/bin/env python
"""Time each hand-written kernel against what XLA makes of its plain form.

On the GPU, at the widths the flagship prove runs:

* ``points``: every fused point kernel (cuda_kernels.py) vs the
  plain jnp formula over the compact (scan-form) field — the form the
  prover would run without the kernel — at ``--lanes`` lanes;
  ``--unrolled`` adds the plain formula over the unrolled field (its
  compile takes minutes).
* ``field``: the CUDA field kernels vs the plain unrolled-limb jnp form
  XLA fuses, for Fr and Fq multiply / add at the flagship table size.

Prints one line per measurement (compile seconds, device time per call
in ms); exits non-zero without a GPU.

    python scripts/kernel_bench.py [--lanes 8192] [--unrolled] [--only points]
"""

from __future__ import annotations

import argparse
import copy
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def timed(fn, args, reps: int):
    """(compile s, first-call s, ms per call over ``reps`` back-to-back)."""
    import jax

    t0 = time.time()
    c = jax.jit(fn).lower(*args).compile()
    tc = time.time() - t0
    t0 = time.time()
    jax.block_until_ready(c(*args))
    t1 = time.time() - t0
    t0 = time.time()
    out = None
    for _ in range(reps):
        out = c(*args)
    jax.block_until_ready(out)
    return tc, t1, (time.time() - t0) / reps * 1e3


def bench_points(lanes: int, unrolled: bool, reps: int) -> None:
    from scalable_collaborative_zksnark_tpu import cuda_kernels
    from scalable_collaborative_zksnark_tpu.curves.g1 import bls12_381_g1
    from scalable_collaborative_zksnark_tpu.fields.fr import get_field
    from scalable_collaborative_zksnark_tpu.utils import kernel_check as kc

    cv = bls12_381_g1()
    p1, p2a, p2j, mask, _, _ = kc.sample_points(cv, lanes)
    forms = [("kernel", lambda op: lambda *a: kc.run_kernel(cv, op, *a)),
             ("plain_scan", lambda op: lambda *a: kc.run_plain(cv, op, *a))]
    if unrolled:
        cvu = copy.copy(cv)
        cvu.fq = get_field(cv.fq.spec.name, compact=False)
        forms.append(
            ("plain_unrolled", lambda op: lambda *a: kc.run_plain(cvu, op, *a)))
    for op in cuda_kernels.OPS:
        args = kc.op_args(op, p1, p2a, p2j, mask)
        for name, mk in forms:
            tc, t1, ms = timed(mk(op), args, reps)
            print(f"points {op} {name} lanes={lanes}: compile {tc:.1f}s "
                  f"first {t1:.3f}s  {ms:.4f} ms/call", flush=True)


def bench_field(reps: int, m: int) -> None:
    from scalable_collaborative_zksnark_tpu import backend
    from scalable_collaborative_zksnark_tpu.fields.config import FIELDS
    from scalable_collaborative_zksnark_tpu.fields.fr import Field

    for name in ("bls12_381_fr", "bls12_381_fq"):
        for kernel in (True, False):
            choice = backend.field_kernels
            backend.field_kernels = lambda v=kernel: v
            try:
                F = Field(FIELDS[name])  # fresh jit caches per form
                a = F.random((m,), 1)
                b = F.random((m,), 2)
                for op in ("mul", "add"):
                    tc, t1, ms = timed(getattr(F, op), (a, b), reps)
                    form = "kernel" if kernel else "plain_unrolled"
                    print(f"field {name} {op} {form} m={m}: compile {tc:.1f}s"
                          f" first {t1:.3f}s  {ms:.4f} ms/call", flush=True)
            finally:
                backend.field_kernels = choice


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lanes", type=int, default=None,
                    help="point-kernel lanes (default: msm.DENSE_LANES)")
    ap.add_argument("--unrolled", action="store_true")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--only", choices=("points", "field"), default=None)
    ap.add_argument("--field-m", type=int, default=1 << 15,
                    help="field-op elements (flagship gate table: 2^15)")
    args = ap.parse_args()

    from scalable_collaborative_zksnark_tpu.primitives.msm import DENSE_LANES
    from scalable_collaborative_zksnark_tpu.utils.benchlib import device_info

    dev = device_info()
    print(f"device: {dev}", flush=True)
    if dev["platform"] != "gpu":
        sys.exit("kernel_bench.py: no GPU")
    if args.only in (None, "points"):
        bench_points(args.lanes or DENSE_LANES, args.unrolled, args.reps)
    if args.only in (None, "field"):
        bench_field(args.reps, args.field_m)


if __name__ == "__main__":
    main()
