"""Multi-process mesh bring-up test.

The reference smoke-tests its TCP mesh bring-up (mpc-net/src/
multi.rs:273-362 LocalTestNet); the equivalent here is
``scripts/run_multihost.py``: JAX processes joined via
``jax.distributed``.  ``--local-demo`` spawns 2 coordinated CPU
processes x 4 virtual devices (an 8-device global mesh) and runs a tiny
prove; this test asserts its proof equals a single-process 8-device run
BIT-EXACTLY (per-leaf checksums).
"""

import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
SCRIPT = REPO / "scripts" / "run_multihost.py"


def _clean_env(xla_devices: int):
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={xla_devices}"
    env["JAX_PLATFORMS"] = "cpu"
    return env


def test_local_demo_matches_single_process(tmp_path):
    demo_digest = tmp_path / "demo.txt"
    single_digest = tmp_path / "single.txt"

    # 2 coordinated processes x 4 virtual devices
    subprocess.run(
        [sys.executable, str(SCRIPT), "--local-demo", "--n", "4", "--l", "1",
         "--repeat", "0", "--digest", str(demo_digest)],
        check=True, timeout=1500, env=dict(os.environ),
    )
    # 1 process x 8 virtual devices, same config/seeds
    subprocess.run(
        [sys.executable, str(SCRIPT), "--n", "4", "--l", "1",
         "--repeat", "0", "--digest", str(single_digest)],
        check=True, timeout=1500, env=_clean_env(8),
    )
    demo = demo_digest.read_text()
    single = single_digest.read_text()
    assert demo, "demo wrote no digest"
    assert demo == single, "multi-process proof != single-process proof"
