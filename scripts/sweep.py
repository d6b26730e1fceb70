#!/usr/bin/env python
"""Benchmark sweeps → CSV (parity: reference hack/bench_*.sh + read_data.ipynb).

The reference drives scale sweeps with shell scripts and scrapes timer
traces into CSV with a notebook; here the sweep loop, timing and CSV
writing are one tool.

    python scripts/sweep.py --suite hyperplonk --l 4 8 --n 10 12 14 --out sweep.csv
    python scripts/sweep.py --suite sumcheck   --l 8 --n 16 18 20
"""

from __future__ import annotations

import argparse
import csv
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def _timed(fn):
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def run_one(suite: str, n: int, l: int, mode: str):
    import jax

    from scalable_collaborative_zksnark_tpu.mpc.net import PartyNet

    net = PartyNet(8 * l, mode=mode)
    if suite == "hyperplonk":
        from scalable_collaborative_zksnark_tpu.hyperplonk import (
            dhyperplonk_phased,
            packed_proving_parameters,
        )

        # phased, as bench.py: parallel AOT precompile bounds per-cell
        # compile at ~max-phase instead of sum-of-phases.
        from scalable_collaborative_zksnark_tpu.hyperplonk.collaborative import (
            precompile_phases,
        )

        pk = packed_proving_parameters(n, l, net)
        precompile_phases(n, pk, net)
        step = lambda: dhyperplonk_phased(n, pk, net)
        jax.block_until_ready(step())
        reps = sorted(
            _timed(lambda: jax.block_until_ready(step())) for _ in range(3)
        )
        dt = reps[len(reps) // 2]
    elif suite == "sumcheck":
        from scalable_collaborative_zksnark_tpu.fields.fr import get_field
        from scalable_collaborative_zksnark_tpu.primitives.sumcheck import (
            c_sumcheck_product,
        )
        from scalable_collaborative_zksnark_tpu.pss.pss import PackedSharingParams

        F = get_field("bls12_381_fr")
        pp = PackedSharingParams(F, l)
        P = net.local_parties
        f = F.random((P, (1 << n) // l), 1)
        g = F.random((P, (1 << n) // l), 2)
        ch = F.random((n + 4,), 3)
        step = jax.jit(lambda a, b, c: c_sumcheck_product(pp, net, a, b, c))
        jax.block_until_ready(step(f, g, ch))
        t0 = time.perf_counter()
        jax.block_until_ready(step(f, g, ch))
        dt = time.perf_counter() - t0
    elif suite == "pss":
        # criterion parity (dist-primitive/benches/pss.rs): pack/unpack
        # of field vectors and G1 points at the given l; n = log2(#secrets)
        from scalable_collaborative_zksnark_tpu.curves import host_curve as hc
        from scalable_collaborative_zksnark_tpu.curves.g1 import bls12_381_g1
        from scalable_collaborative_zksnark_tpu.fields.fr import get_field
        from scalable_collaborative_zksnark_tpu.pss.pss import PackedSharingParams

        F = get_field("bls12_381_fr")
        pp = PackedSharingParams(F, l)
        M = 1 << n
        sec = F.random((M // l, l, F.L), 1)
        pack = jax.jit(pp.pack_from_public)
        unpack = jax.jit(pp.unpack)
        sh = pack(sec)
        jax.block_until_ready(unpack(sh))
        t0 = time.perf_counter()
        jax.block_until_ready(unpack(pack(sec)))
        dt_f = time.perf_counter() - t0
        curve = bls12_381_g1()
        pts = curve.from_affine_ints([hc.G1_GEN] * min(M, 256))
        ptc = jax.tree.map(lambda a: a.reshape(-1, l, a.shape[-1]), pts)
        gsh = pp.pack_from_public_group(curve, ptc)
        jax.block_until_ready(pp.unpack_group(curve, gsh))
        t0 = time.perf_counter()
        jax.block_until_ready(pp.unpack_group(curve, pp.pack_from_public_group(curve, ptc)))
        dt = time.perf_counter() - t0
        print(f"# pss l={l} n={n}: field pack+unpack {dt_f:.4f}s, "
              f"G1 pack+unpack ({min(M,256)} pts) {dt:.4f}s", file=sys.stderr)
        return dt_f, 0, 0
    elif suite == "poly_comm":
        from scalable_collaborative_zksnark_tpu.curves.g1 import bls12_381_g1
        from scalable_collaborative_zksnark_tpu.primitives.poly_comm import (
            c_open,
            srs_random,
        )
        from scalable_collaborative_zksnark_tpu.pss.pss import PackedSharingParams

        curve = bls12_381_g1()
        F = curve.fr
        pp = PackedSharingParams(F, l)
        P = net.local_parties
        srs = srs_random(curve, n, 7, packed_parties=pp.n, max_level=-1)
        pe = F.random((P, (1 << n) // l), 1)
        pt = F.random((n + 2,), 2)
        step = jax.jit(lambda a, b: c_open(srs, pp, net, a, b))
        jax.block_until_ready(step(pe, pt))
        t0 = time.perf_counter()
        jax.block_until_ready(step(pe, pt))
        dt = time.perf_counter() - t0
    else:
        raise SystemExit(f"unknown suite {suite}")
    up, down = net.comm(0)
    return dt, up, down


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--suite", choices=("hyperplonk", "sumcheck", "poly_comm", "pss"),
                    default="sumcheck")
    ap.add_argument("--l", type=int, nargs="+", default=[2])
    ap.add_argument("--n", type=int, nargs="+", default=[10])
    ap.add_argument("--mode", choices=("sim", "leader"), default="leader")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--out", default=None, help="CSV output path")
    args = ap.parse_args()
    if args.cpu:
        import os

        os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
        import jax

        jax.config.update("jax_platforms", "cpu")
    from scalable_collaborative_zksnark_tpu.utils.benchlib import (
        enable_compile_cache,
    )

    enable_compile_cache()

    import jax

    backend = jax.default_backend()
    rows = []
    for l in args.l:
        for n in args.n:
            dt, up, down = run_one(args.suite, n, l, args.mode)
            row = {"suite": args.suite, "n": n, "l": l, "mode": args.mode,
                   "backend": backend,
                   "seconds": round(dt, 6), "up_bytes": up, "down_bytes": down}
            rows.append(row)
            print(row)
    if args.out:
        with open(args.out, "w", newline="") as fh:
            w = csv.DictWriter(fh, fieldnames=list(rows[0].keys()))
            w.writeheader()
            w.writerows(rows)
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
