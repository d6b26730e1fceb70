"""Guard the driver-facing bench entry point.

The harness runs ``python bench.py`` unattended at round end; a
regression here means no recorded metric at all.  One subprocess smoke
run checks that the CLI completes on the CPU backend and prints exactly
one well-formed JSON metric line (phased mode — the default the driver
hits; full/eager are exercised by the same code path behind --mode).
"""

import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def test_bench_smoke_emits_metric_line():
    out = subprocess.run(
        [sys.executable, str(REPO / "bench.py"), "--smoke", "--repeat", "1"],
        capture_output=True,
        text=True,
        timeout=900,
        cwd=str(REPO),
    )
    assert out.returncode == 0, out.stderr[-2000:]
    lines = [l for l in out.stdout.splitlines() if l.strip()]
    assert len(lines) == 1, out.stdout
    rec = json.loads(lines[0])
    assert {"metric", "value", "unit", "vs_baseline"} <= set(rec)
    assert rec["unit"] == "s" and rec["value"] > 0
    # hardened baseline reporting (VERDICT r3 item 6): the JSON line says
    # which config the 93.218 s trace is assumed to be, and carries an
    # (n, l)-scaled estimate next to the flagship-anchored number
    assert "baseline_assumed_config" in rec
    assert rec["baseline_est_s"] > 0 and rec["vs_baseline_est"] > 0


def test_bench_conformance_digest_pinned():
    """--conformance on the CPU backend must match the pinned digest —
    the same pin chip_smoke.py checks on the GPU (bit-exactness of the
    GPU arithmetic)."""
    out = subprocess.run(
        [sys.executable, str(REPO / "bench.py"), "--conformance", "--cpu"],
        capture_output=True,
        text=True,
        timeout=900,
        cwd=str(REPO),
    )
    assert out.returncode == 0, (out.stdout, out.stderr[-2000:])
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["metric"] == "conformance" and rec["value"] == 1, rec
