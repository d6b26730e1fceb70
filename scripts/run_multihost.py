#!/usr/bin/env python
"""Multi-host collaborative prover runner.

The reference drives real clusters with shell orchestration
(`/root/reference/hack/run-hyperplonk/run-servers.sh`,
`prepare-server.sh`: one process per party over a TCP mesh).  The
equivalent here is JAX processes joined into a single device mesh via
``jax.distributed``; the N = 8l MPC parties are a sharded *array axis*
laid over every GPU of every process, and the protocol's cross-party
movement lowers to collectives (NCCL).

Each process must own its GPUs (a JAX process reserves most of a card's
memory when it starts).  One process per host drives all of that host's
cards; one process per card passes ``--local-device-ids``::

    python scripts/run_multihost.py \
        --coordinator 10.0.0.1:8476 --num-processes 4 --process-id $I \
        --local-device-ids $I --n 16 --l 8

and process 0 prints the per-party prove time + comm totals.

``--local-demo`` validates the whole multi-process path on one machine:
it spawns 2 coordinated CPU processes with 4 virtual devices each (an
8-device global mesh) and runs a tiny prove — the same code path a
multi-GPU run takes, minus real NVLink/NCCL; it never opens a GPU.

Reference parity: hack/run-hyperplonk/handle_server.sh:26-34 (scale
envelope), mpc-net/src/multi.rs:273-362 (process mesh bring-up).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def _global_put(arrays, shardings):
    """device_put that works in both single- and multi-process runs.

    In a multi-process mesh most shards are non-addressable, so build
    each global array from a callback that materializes only the local
    shard's slice (every process holds the same full host value —
    prover inputs are seeded identically, mirroring the reference's
    per-server deterministic test inputs).
    """
    import jax
    import numpy as np

    def put(a, s):
        if not hasattr(a, "shape"):
            return a
        host = np.asarray(a)
        return jax.make_array_from_callback(host.shape, s, lambda idx: host[idx])

    return jax.tree.map(put, arrays, shardings)


def run(args) -> None:
    import jax

    if args.num_processes > 1:
        jax.distributed.initialize(
            coordinator_address=args.coordinator,
            num_processes=args.num_processes,
            process_id=args.process_id,
            local_device_ids=args.local_device_ids,
        )
    from jax.sharding import Mesh

    from scalable_collaborative_zksnark_tpu.hyperplonk import (
        dhyperplonk,
        packed_proving_parameters,
    )
    from scalable_collaborative_zksnark_tpu.hyperplonk.sharding import (
        party_shardings,
        pk_arrays,
        pk_merge,
    )
    from scalable_collaborative_zksnark_tpu.mpc.net import PartyNet

    devs = jax.devices()
    n, l = args.n, args.l
    N = 8 * l
    mesh = Mesh(devs, ("party",))
    net = PartyNet(N, mode="sim")
    t0 = time.time()
    pk = packed_proving_parameters(n, l, net)
    arrays = pk_arrays(pk)
    shardings = party_shardings(mesh, arrays, N)
    arrays = _global_put(arrays, shardings)
    if args.process_id == 0:
        print(f"# setup: {time.time() - t0:.1f}s  mesh={len(devs)} devices, "
              f"N={N} parties, n={n}", flush=True)

    def step(arrs):
        return dhyperplonk(n, pk_merge(pk, arrs), net)

    jstep = jax.jit(step, in_shardings=(shardings,))
    with mesh:
        t0 = time.time()
        out = jstep(arrays)
        jax.block_until_ready(out)
        if args.process_id == 0:
            print(f"# compile + first prove: {time.time() - t0:.1f}s", flush=True)
        best = float("inf")
        for i in range(args.repeat):
            t0 = time.time()
            out = jstep(arrays)
            jax.block_until_ready(out)
            best = min(best, time.time() - t0)
        if args.digest:
            _write_digest(out, args.digest, args.process_id, mesh)
    if args.process_id == 0:
        leaves = len(jax.tree.leaves(out))
        if args.repeat:
            print(f"# warm prove: {best:.3f}s  ({leaves} proof leaves)")
        print(f"Comm: {net.comm(0)}")


def _write_digest(out, path: str, process_id: int, mesh) -> None:
    """Per-leaf position-weighted uint32 checksums of the proof bundle,
    written by process 0 — lets a multi-process run be compared
    BIT-EXACTLY against a single-process run of the same config
    (the reference's LocalTestNet result-equality tests, multi.rs parity).
    All processes must execute the jitted digest (SPMD); the scalar
    results are replicated, so process 0 can fetch them."""
    import jax

    from scalable_collaborative_zksnark_tpu.utils.benchlib import _leaf_digest

    leaves = jax.tree.leaves(out)
    digs = [jax.device_get(_leaf_digest()(a)) for a in leaves]
    if process_id == 0:
        with open(path, "w") as fh:
            for i, d in enumerate(digs):
                fh.write(f"{i} {int(d):08x}\n")


def local_demo(args) -> None:
    """Two coordinated CPU processes x 4 virtual devices on this host."""
    procs = []
    for pid in range(2):
        env = dict(
            os.environ,
            XLA_FLAGS="--xla_force_host_platform_device_count=4",
            JAX_PLATFORMS="cpu",
        )
        procs.append(
            subprocess.Popen(
                [
                    sys.executable, __file__,
                    "--coordinator", "localhost:8476",
                    "--num-processes", "2", "--process-id", str(pid),
                    "--n", str(args.n), "--l", str(args.l),
                    "--repeat", str(args.repeat),
                ]
                + (["--digest", args.digest] if args.digest else []),
                env=env,
                stdout=None if pid == 0 else subprocess.DEVNULL,
                stderr=None if pid == 0 else subprocess.DEVNULL,
            )
        )
    rcs = [p.wait(timeout=1800) for p in procs]
    if any(rcs):
        raise SystemExit(f"demo process exit codes: {rcs}")
    print("local multi-process demo OK")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", default="localhost:8476",
                    help="host:port of process 0 (jax.distributed)")
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--local-device-ids", type=int, nargs="*", default=None,
                    help="GPUs this process owns (default: all visible)")
    ap.add_argument("--n", type=int, default=5, help="log2 gate count")
    ap.add_argument("--l", type=int, default=1, help="packing factor (N = 8l)")
    ap.add_argument("--repeat", type=int, default=2)
    ap.add_argument("--local-demo", action="store_true",
                    help="spawn 2 coordinated CPU processes on this host")
    ap.add_argument("--digest", default=None, metavar="PATH",
                    help="write per-leaf proof checksums (process 0) for "
                         "bit-exact comparison across process layouts")
    args = ap.parse_args()

    if args.local_demo:
        local_demo(args)
        return
    run(args)


if __name__ == "__main__":
    main()
