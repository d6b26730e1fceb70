"""The one place that decides which implementation each platform runs.

* ``cpu``: field and curve ops lower to the native FFI kernels
  (fields/ffi.py) — the test and digest-pin oracle.
* ``gpu``: BLS12-381 field multiply / add / subtract and the G1 group
  law run as CUDA kernels (cuda_kernels.py); the remaining limb code
  (sums, carries, other fields) is plain jnp with the limb loops
  unrolled.

Every choice is keyed on ``jax.default_backend()`` at trace time; no
environment variable changes it.
"""

from __future__ import annotations

import jax


def platform() -> str:
    """"cpu" or "gpu" (the backend JAX traces for)."""
    return jax.default_backend()


def native_ffi():
    """The native FFI module on the CPU backend, else None."""
    if platform() != "cpu":
        return None
    from .fields import ffi

    return ffi if ffi.available() else None


def unrolled_limbs() -> bool:
    """Unroll limb loops at trace time (XLA fuses the chain into one
    kernel) instead of ``lax.scan`` over limbs.  Off on the CPU, whose
    compiler takes minutes for unrolled CIOS graphs."""
    return platform() != "cpu"


def field_kernels() -> bool:
    """CUDA kernels for BLS12-381 field ops (cuda_kernels.py)."""
    return platform() == "gpu"


def point_kernels() -> bool:
    """Fused CUDA G1 point kernels (cuda_kernels.py)."""
    return platform() == "gpu"


def mxu_sumcheck() -> bool:
    """Sumcheck rounds as int8 matrix products (fields/mxu.py).

    Off everywhere: on the H100 a 2 x 64-entry product fold through this
    path did not finish in 15 minutes (PERF.md, PR 1), and the limb
    rounds run through the field kernels."""
    return False


def export_platform() -> str:
    """The ``jax.export`` platform name of the current backend."""
    return {"cpu": "cpu", "gpu": "cuda"}[platform()]
