#!/usr/bin/env python
"""Pre-generate the seeded benchmark SRS for a config into the disk cache.

The SRS contract is seeded values only (params.py: srs cache), so it is
generated here on the CPU backend, where the native FFI makes the
scalar-multiplication ladder cheap, and written to ``SCZK_SRS_CACHE``
(default ``<compile cache>/srs``).  A prover process on any backend then
loads it instead of generating it.  This process never opens a GPU.

    python scripts/pregen_srs.py --n 16 --l 8

Exits non-zero when the SRS file was not written.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--n", type=int, default=16)
    ap.add_argument("--l", type=int, default=8)
    args = ap.parse_args()

    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")

    from scalable_collaborative_zksnark_tpu.curves.g1 import bls12_381_g1
    from scalable_collaborative_zksnark_tpu.hyperplonk import (
        packed_proving_parameters,
    )
    from scalable_collaborative_zksnark_tpu.hyperplonk.params import (
        _srs_cache_path,
    )
    from scalable_collaborative_zksnark_tpu.mpc.net import PartyNet
    from scalable_collaborative_zksnark_tpu.utils.benchlib import cache_dir

    os.environ.setdefault("SCZK_SRS_CACHE", str(cache_dir() / "srs"))
    t0 = time.time()
    net = PartyNet(8 * args.l, mode="leader")
    pk = packed_proving_parameters(args.n, args.l, net)
    jax.block_until_ready(pk.V)
    path = _srs_cache_path(bls12_381_g1(), args.n, pk.pp, 1)
    if path is None or not path.exists():
        print(f"SRS for n={args.n}, l={args.l} was NOT written to "
              f"{os.environ['SCZK_SRS_CACHE']}", file=sys.stderr)
        sys.exit(1)
    print(f"SRS cached for n={args.n}, l={args.l} in {time.time() - t0:.1f}s "
          f"-> {path}")


if __name__ == "__main__":
    main()
