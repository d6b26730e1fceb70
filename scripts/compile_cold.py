#!/usr/bin/env python
"""Per-phase COLD compile cost of the flagship phased prover.

Every chip call may start with no compiled code, so cold compile time is
set-up cost.  This script measures where that time goes: it lowers + compiles phased executables SEPARATELY with the
persistent cache disabled (or pointed at a throwaway dir) and prints
per-phase wall seconds, without running any device math (argument shapes
come from ``jax.eval_shape`` via ``phase_example_args``).

Usage:
  python scripts/compile_cold.py [--n 16] [--l 8] [--cpu]
      [--parallel K]   compile with a K-thread pool (tests whether the
                       backend compiles executables concurrently)
      [--cache DIR]    use DIR as the persistent cache (default: off)
      [--phases a,b]   only compile the named phases
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=16)
    ap.add_argument("--l", type=int, default=8)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--parallel", type=int, default=0)
    ap.add_argument("--cache", default=None)
    ap.add_argument("--phases", default=None)
    args = ap.parse_args()

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")
    import jax

    if args.cache:
        from scalable_collaborative_zksnark_tpu.utils.benchlib import (
            enable_compile_cache,
        )

        os.environ["JAX_COMPILATION_CACHE_DIR"] = args.cache
        enable_compile_cache()

    from scalable_collaborative_zksnark_tpu.hyperplonk import (
        packed_proving_parameters,
    )
    from scalable_collaborative_zksnark_tpu.hyperplonk.collaborative import (
        phase_example_args,
        phase_fns,
    )
    from scalable_collaborative_zksnark_tpu.mpc.net import PartyNet

    n, l = args.n, args.l
    net = PartyNet(8 * l, mode="leader")
    t0 = time.time()
    pk = packed_proving_parameters(n, l, net)
    jax.block_until_ready(pk.V)
    print(f"setup: {time.time() - t0:.1f}s", file=sys.stderr, flush=True)

    fns = phase_fns(n, pk, net)
    t0 = time.time()
    fargs = phase_example_args(n, pk, net)
    print(f"example-args (traces wire_a+commit): {time.time() - t0:.1f}s",
          file=sys.stderr, flush=True)

    only = args.phases.split(",") if args.phases else list(fns)

    def compile_one(name):
        t0 = time.time()
        lowered = fns[name].lower(*fargs[name])
        t1 = time.time()
        compiled = lowered.compile()
        t2 = time.time()
        try:
            sz = compiled.memory_analysis()
            extra = f" code={getattr(sz, 'generated_code_size_in_bytes', 0)/1e6:.1f}MB"
        except Exception:
            extra = ""
        print(
            f"{name:14s} trace {t1 - t0:6.1f}s   compile {t2 - t1:7.1f}s{extra}",
            flush=True,
        )
        return t2 - t0

    t0 = time.time()
    if args.parallel:
        with ThreadPoolExecutor(max_workers=args.parallel) as ex:
            list(ex.map(compile_one, only))
    else:
        for name in only:
            compile_one(name)
    print(f"TOTAL {time.time() - t0:.1f}s", flush=True)


if __name__ == "__main__":
    main()
