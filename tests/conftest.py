"""Test configuration.

The suite runs on the CPU backend (``JAX_PLATFORMS=cpu``) with a
virtual 8-device mesh, so protocol correctness and party-axis sharding
are checked without a GPU.  Tests marked ``gpu`` need the card: they
skip here and run on the GPU through ``python chip_smoke.py`` (phase 2),
or directly with ``python -m pytest tests/test_gpu.py -m gpu``.
"""

import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
if "--xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] += " --xla_force_host_platform_device_count=8"

import pytest

# NOTE: the persistent compilation cache is deliberately DISABLED.
# XLA:CPU executable (de)serialization is unreliable across hosts: loads
# segfault when entries were AOT-compiled under different CPU features.
# Compile time is paid once per process instead.


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs the GPU; skips on other backends"
    )


@pytest.fixture()
def gpu():
    """Skip unless JAX computes on a GPU (decided here, at run time)."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (run via chip_smoke.py)")
