#!/usr/bin/env python
"""Micro-benchmarks of the hot kernels (field ops, group law, MSM, fold).

Reports per-op wall time and derived throughput on the active backend.
Used to compare against the reference's primitive timings (BASELINE.md:
~18-26 ms local share MSM, leader MSM rounds 48-494 ms) and to find
kernels worth hand-writing in Pallas.
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from examples.common import base_parser, setup  # noqa: E402


def timeit(fn, *args, reps=3):
    import jax

    out = fn(*args)
    jax.block_until_ready(out)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(*args)
        jax.block_until_ready(out)
        best = min(best, time.perf_counter() - t0)
    return best


def main():
    ap = base_parser(__doc__)
    ap.add_argument("--m", type=int, default=20, help="log2 elements for field ops")
    args = ap.parse_args()
    setup(args)
    import jax
    import jax.numpy as jnp

    from scalable_collaborative_zksnark_tpu.curves.g1 import (
        BLS12_381_G1_GEN,
        bls12_381_g1,
    )
    from scalable_collaborative_zksnark_tpu.fields.fr import get_field
    from scalable_collaborative_zksnark_tpu.primitives.msm import msm
    from scalable_collaborative_zksnark_tpu.primitives.sumcheck import _rounds_product

    curve = bls12_381_g1()
    F = get_field("bls12_381_fr")
    M = 1 << args.m
    a = F.random((M,), 1)
    b = F.random((M,), 2)

    dt = timeit(F.add, a, b)
    print(f"fr.add   [2^{args.m}]: {dt*1e3:8.3f} ms  ({M/dt/1e9:.2f} Gop/s)")
    dt = timeit(F.mul, a, b)
    print(f"fr.mul   [2^{args.m}]: {dt*1e3:8.3f} ms  ({M/dt/1e6:.1f} Mmul/s)")
    dt = timeit(F.batch_inv, a)
    print(f"fr.binv  [2^{args.m}]: {dt*1e3:8.3f} ms  ({M/dt/1e6:.1f} Minv/s)")

    # one sumcheck-product round (the #1 elementwise loop)
    ch = F.random((1,), 3)
    round_fn = jax.jit(lambda f, g, c: _rounds_product(F, f, g, c, 0, 1)[0][0])
    dt = timeit(round_fn, a, b, ch)
    print(f"sumcheck product round [2^{args.m}]: {dt*1e3:8.3f} ms")

    # group law
    mg = min(args.m, 16)
    Mg = 1 << mg
    g = curve.from_affine_ints([BLS12_381_G1_GEN])
    pts = jax.tree.map(lambda x: jnp.broadcast_to(x, (Mg,) + x.shape[1:]), g)
    dt = timeit(curve.add, pts, pts)
    print(f"g1.add   [2^{mg}]: {dt*1e3:8.3f} ms  ({Mg/dt/1e6:.2f} Madd/s)")
    ks = F.decode(F.random((Mg,), 4))
    dt = timeit(lambda p, k: curve.scalar_mul(p, k), pts, ks)
    print(f"g1.smul  [2^{mg}]: {dt*1e3:8.3f} ms")

    for mm in (12, 14, 16):
        if mm > args.m:
            break
        Mm = 1 << mm
        ptsm = jax.tree.map(lambda x: jnp.broadcast_to(x, (Mm,) + x.shape[1:]), g)
        ksm = F.decode(F.random((Mm,), 5))
        for c in (4, 8):
            dt = timeit(lambda p, k, c=c: msm(curve, p, k, c=c), ptsm, ksm)
            print(f"msm      [2^{mm}] c={c}: {dt*1e3:8.3f} ms")


if __name__ == "__main__":
    main()
