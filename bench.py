#!/usr/bin/env python
"""Headline benchmark: collaborative HyperPlonk per-party prove time.

Runs the flagship ``dhyperplonk`` prover in ``leader`` execution mode —
one party's full compute materialized plus analytic communication
accounting, exactly the reference's `leader` feature benchmark mode
(/root/reference/README.md:28-33, serializing_net.rs:144-264) — on the
GPU, and prints ONE JSON line naming the device:

    {"metric": ..., "value": <seconds>, "unit": "s", "device": {...}, ...}

Without a GPU it exits non-zero; ``--cpu`` / ``--smoke`` ask for the
CPU backend explicitly and tag the metric ``_cpu``.  A prove whose
digest differs from its CPU pin also exits non-zero.

Baseline: the reference's only recorded run (BASELINE.md) reports
93.218 s for all N parties serialized on one thread, i.e. ≈ 93.218/N
per party (README.md:33).  With the BASELINE.json flagship config
(l = 8, N = 64) that is 1.457 s per party.  ``vs_baseline`` is
baseline/ours, so > 1 means faster than the reference.

Usage: python bench.py [--n 16] [--l 8] [--smoke] [--cpu] [--repeat 5]
  --smoke: tiny sizes on CPU (CI sanity), not a performance claim.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=16, help="log2 gate count")
    ap.add_argument("--l", type=int, default=8, help="packing factor (N = 8l)")
    ap.add_argument("--smoke", action="store_true", help="tiny CPU sanity run")
    ap.add_argument("--cpu", action="store_true",
                    help="run the FULL config on the CPU backend (native FFI "
                         "field/curve kernels) — the reference baseline is "
                         "itself a single-thread CPU number")
    ap.add_argument("--repeat", type=int, default=5)
    ap.add_argument("--mode", choices=("phased", "full", "eager"),
                    default="phased",
                    help="phased: one jitted executable per protocol phase, "
                         "compiled concurrently (default); full: single "
                         "end-to-end jit; eager: per-primitive dispatch")
    ap.add_argument("--eager", action="store_true", help="alias for --mode eager")
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="capture a jax.profiler trace of the warm runs into DIR")
    ap.add_argument("--conformance", action="store_true",
                    help="tiny pinned-digest prove (n=6, l=1) on the current "
                         "backend: verifies the GPU paths produce the "
                         "bit-exact CPU-pinned proof; prints PASS/FAIL JSON")
    args = ap.parse_args()

    if args.smoke:
        import os

        os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
        import jax

        jax.config.update("jax_platforms", "cpu")
        args.n, args.l = 4, 1
    elif args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")
    import jax

    from scalable_collaborative_zksnark_tpu.utils.benchlib import (
        device_info,
        enable_compile_cache,
    )

    dev = device_info()
    if not (args.smoke or args.cpu) and dev["platform"] != "gpu":
        sys.exit(f"bench.py: no GPU (JAX found {dev}); pass --cpu to "
                 "benchmark the CPU backend")

    if args.conformance:
        conformance(dev)
        return

    enable_compile_cache()

    from scalable_collaborative_zksnark_tpu.hyperplonk import (
        dhyperplonk,
        dhyperplonk_phased,
        packed_proving_parameters,
    )
    from scalable_collaborative_zksnark_tpu.mpc.net import PartyNet

    from scalable_collaborative_zksnark_tpu.hyperplonk.sharding import (
        pk_arrays,
        pk_merge,
    )

    from scalable_collaborative_zksnark_tpu.utils import timer

    timer.enable(True)  # Start:/End: trace lines on stderr (timer.rs parity)

    n, l = args.n, args.l
    N = 8 * l
    net = PartyNet(N, mode="leader")
    t0 = time.time()
    pk = packed_proving_parameters(n, l, net)
    jax.block_until_ready(pk.V)
    setup_s = time.time() - t0
    print(f"# setup (SRS + inputs): {setup_s:.1f}s", file=sys.stderr)

    # The protocol is a Python orchestration of jitted primitives;
    # jitting each phase (or the whole step) collapses thousands of
    # dispatches into a few device programs.
    arrays = pk_arrays(pk)

    mode = "eager" if args.eager else args.mode

    if mode == "phased":
        # Parallel AOT compile of every phase executable: compile
        # wall-clock becomes ~max-of-phases instead of sum-of-phases, and
        # the prove dispatches the compiled objects directly.
        from scalable_collaborative_zksnark_tpu.hyperplonk.collaborative import (
            precompile_phases,
        )

        t0 = time.time()
        precompile_phases(n, pk, net)
        print(f"# precompile (parallel AOT): {time.time() - t0:.1f}s",
              file=sys.stderr)
        step_jit = lambda arrs: dhyperplonk_phased(n, pk, net)
    else:
        def step(arrs):
            # return the FULL proof bundle: anything not returned is dead
            # code that XLA eliminates, silently shrinking the benchmark
            return dhyperplonk(n, pk_merge(pk, arrs), net)

        step_jit = step if mode == "eager" else jax.jit(step)

    t0 = time.time()
    out = step_jit(arrays)
    jax.block_until_ready(out)
    print(f"# compile + first run: {time.time() - t0:.1f}s", file=sys.stderr)
    # comm is counted while traces/eager collectives run; the first full
    # prove has seen them all — snapshot per-prove totals here
    comm = net.comm(0)
    print(f"# comm per prove: {comm}", file=sys.stderr)

    import contextlib

    prof = (
        jax.profiler.trace(args.trace) if args.trace else contextlib.nullcontext()
    )
    times = []
    with prof:
        for i in range(max(args.repeat, 1)):
            t0 = time.time()
            out = step_jit(arrays)
            jax.block_until_ready(out)
            dt = time.time() - t0
            print(f"# run {i}: {dt:.2f}s", file=sys.stderr)
            times.append(dt)
    times.sort()
    best = times[0]
    median = times[len(times) // 2] if len(times) % 2 else (
        (times[len(times) // 2 - 1] + times[len(times) // 2]) / 2
    )
    spread = times[-1] - times[0]

    # Conformance: the canonical digest of the LAST warm prove is checked
    # against the CPU-generated pin for this config, at zero extra prove
    # cost; a mismatch fails the run (after the metric line).
    from scalable_collaborative_zksnark_tpu.utils.benchlib import proof_digest

    d = proof_digest(out)
    pin = CONFORMANCE_PIN.get((n, l))
    if pin is None:
        conf = f"no-pin (digest 0x{d:016x})"
    else:
        conf = "pass" if d == pin else f"fail (0x{d:016x} != 0x{pin:016x})"
    print(f"# conformance: {conf}", file=sys.stderr)

    # Baseline: the reference's only recorded run is 93.218 s for all N
    # parties serialized on one thread (hack/run-hyperplonk/output.txt
    # tail; per-party = total/N per README.md:33).  The trace records
    # neither n nor l; BASELINE.md/BASELINE.json treat it as the
    # flagship n=16, l=8 (N=64) config -> 1.457 s/party.  vs_baseline
    # anchors to that assumption; vs_baseline_est additionally scales
    # the anchor to the REQUESTED (n, l) with the linear-work model
    # (per-party tables are 2^n*4/l, so work scales by 2^(n-16) * 8/l),
    # making the two equal at the flagship config and the JSON
    # self-describing about what was assumed.
    baseline_per_party = 93.218 / 64.0
    baseline_est = baseline_per_party * (2 ** (n - 16)) * (8 / l)
    tag = "_cpu" if (args.cpu or args.smoke) else ""
    print(
        json.dumps(
            {
                "metric": f"dhyperplonk_per_party_prove_s_n{n}_l{l}{tag}",
                "value": round(median, 4),
                "unit": "s",
                "vs_baseline": round(baseline_per_party / median, 4),
                "baseline_s": round(baseline_per_party, 4),
                "baseline_assumed_config": "93.218s/64 parties @ n=16,l=8 (trace size unrecorded)",
                "baseline_est_s": round(baseline_est, 4),
                "vs_baseline_est": round(baseline_est / median, 4),
                "min_s": round(best, 4),
                "spread_s": round(spread, 4),
                "runs": [round(t, 4) for t in times],
                "conformance": conf,
                "device": dev,
            }
        )
    )
    if conf.startswith("fail"):
        sys.exit(1)




# CPU-pinned proof digests, keyed by (n, l) — leader mode, phased
# prover.  The tiny (6, 1) config is proven by `--conformance` (CI:
# tests/test_bench_cli.py) on any backend; the DEFAULT bench path
# digests the flagship prove it just ran and checks the matching pin at
# zero extra prove cost, so every recorded metric certifies the values
# on the hardware that produced it.  Digests are CANONICAL: G1 points are
# normalized to affine before hashing (benchlib.canonicalize_proof), so
# a pin certifies VALUES and is insensitive to which MSM backend /
# window plan produced them.  Re-pin via scripts/pin_digest.py whenever
# the protocol's output semantics intentionally change.
CONFORMANCE_PIN = {
    (6, 1): 0x0D8B55994DD236A9,
    (16, 8): 0x8D7A4D5DE7FF827B,  # scripts/pin_digest.py (CPU, FFI MSM)
}

# Only small configs are PROVEN by the --conformance CLI; the flagship
# pin is checked in-line by the default bench path instead.
CONFORMANCE_PROVE_MAX_N = 8


def conformance(dev: dict) -> None:
    from scalable_collaborative_zksnark_tpu.utils.benchlib import (
        enable_compile_cache,
        proof_digest,
    )

    enable_compile_cache()
    from scalable_collaborative_zksnark_tpu.hyperplonk import (
        packed_proving_parameters,
    )
    from scalable_collaborative_zksnark_tpu.hyperplonk.collaborative import (
        dhyperplonk_phased,
    )
    from scalable_collaborative_zksnark_tpu.mpc.net import PartyNet

    results = {}
    ok = True
    for (n, l), pin in CONFORMANCE_PIN.items():
        if pin is None or n > CONFORMANCE_PROVE_MAX_N:
            continue
        net = PartyNet(8 * l, mode="leader")
        pk = packed_proving_parameters(n, l, net)
        out = dhyperplonk_phased(n, pk, net)
        d = proof_digest(out)
        results[f"n{n}_l{l}"] = {
            "digest": f"0x{d:016x}",
            "pinned": f"0x{pin:016x}",
            "pass": d == pin,
        }
        ok = ok and d == pin
    print(
        json.dumps(
            {
                "metric": "conformance",
                "value": 1 if ok else 0,
                "unit": "pass",
                "device": dev,
                "results": results,
            }
        )
    )
    if not ok:
        sys.exit(1)


if __name__ == "__main__":
    main()
