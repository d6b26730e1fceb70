"""XLA FFI binding for the native CPU field kernels (native/field_ffi.cc).

On the CPU backend every field mul/add/sub/inv lowers to one custom-call
instruction backed by 64-bit Montgomery arithmetic in C++.  Two wins:

* **Compile time.**  Protocol graphs contain tens of thousands of field
  ops; the pure-JAX CPU path emits a ``lax.scan`` body per call site and
  XLA:CPU compiles of even tiny end-to-end provers blew past 20 minutes
  and 20 GB.  As single instructions the same graphs compile in seconds.
* **Runtime.**  u64 CIOS with __int128 carries is ~2 orders of magnitude
  faster per element than 16-bit-limb emulation in u32 lanes on CPU.

The GPU path is unaffected (backend.py).  ``available()`` gates
everything: a missing toolchain or FFI API degrades to the pure path.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
_SRC = _ROOT / "native" / "field_ffi.cc"
_SO = _ROOT / "native" / "build" / "libsczkffi.so"

_OPS = ("mul", "add", "sub", "inv")


@functools.lru_cache(maxsize=1)
def _field_ids() -> dict:
    """Stable name -> id mapping (sorted for determinism)."""
    from .config import FIELDS

    return {name: i for i, name in enumerate(sorted(FIELDS))}


@functools.lru_cache(maxsize=1)
def _lib():
    """Build + load the library, register FFI targets and field params.

    Returns None (and stays None for the process) on any failure.
    """
    try:
        import jax
    except ImportError:  # pragma: no cover
        return None
    if not hasattr(jax, "ffi"):
        return None
    from ..native import build_library

    # -O3 -funroll-loops: ~2x on the width-templated Montgomery/curve
    # kernels vs -O2 (measured on the Pippenger bucket pass)
    if not build_library(
        _SRC, _SO,
        ["g++", "-O3", "-funroll-loops", "-fPIC", "-shared", "-std=c++17",
         "-march=native", f"-I{jax.ffi.include_dir()}"],
    ):
        return None
    try:
        lib = ctypes.CDLL(str(_SO))
    except OSError:
        return None
    lib.sczk_field_init.restype = None
    lib.sczk_field_init.argtypes = [
        ctypes.c_int32, ctypes.POINTER(ctypes.c_uint64), ctypes.c_int32
    ]
    for op in _OPS:
        sym = getattr(lib, f"SczkField{op.capitalize()}")
        jax.ffi.register_ffi_target(
            f"sczk_field_{op}", jax.ffi.pycapsule(sym), platform="cpu"
        )
    jax.ffi.register_ffi_target(
        "sczk_g1_op", jax.ffi.pycapsule(lib.SczkG1Op), platform="cpu"
    )
    from .config import FIELDS

    for name, fid in _field_ids().items():
        spec = FIELDS[name]
        nw = spec.num_limbs // 4  # 16-bit limbs -> 64-bit words
        assert spec.num_limbs == 4 * nw
        words = np.frombuffer(
            spec.modulus.to_bytes(8 * nw, "little"), dtype=np.uint64
        ).copy()
        lib.sczk_field_init(
            fid, words.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), nw
        )
    return lib


def available() -> bool:
    return _lib() is not None


def field_id(name: str) -> int:
    return _field_ids()[name]


def binary(op: str, fid: int, a, b):
    """Elementwise field op on same-shape uint32 [..., L] arrays."""
    import jax
    import jax.numpy as jnp

    out = jax.ShapeDtypeStruct(a.shape, jnp.uint32)
    return jax.ffi.ffi_call(
        f"sczk_field_{op}", out, vmap_method="broadcast_all"
    )(a, b, fid=np.int32(fid))


def inv(fid: int, a):
    import jax
    import jax.numpy as jnp

    out = jax.ShapeDtypeStruct(a.shape, jnp.uint32)
    return jax.ffi.ffi_call(
        "sczk_field_inv", out, vmap_method="broadcast_all"
    )(a, fid=np.int32(fid))


def g1_op(mode: int, fid: int, x, y, z, scal, out_shape, n_in: int, n_out: int):
    """Batched native G1 linear op (see native/field_ffi.cc G1OpImpl).

    mode 0 MSM / 1 scalar_mul / 2 sum / 3 linear_map.  ``x/y/z``:
    Jacobian Montgomery Fq limb arrays; ``scal``: standard-form Fr limb
    arrays (raw little-endian bits).  Returns (ox, oy, oz).
    """
    import jax
    import jax.numpy as jnp

    out = [jax.ShapeDtypeStruct(out_shape, jnp.uint32)] * 3
    return jax.ffi.ffi_call(
        "sczk_g1_op", out, vmap_method="broadcast_all"
    )(
        x, y, z, scal,
        fid=np.int32(fid), mode=np.int32(mode),
        n_in=np.int32(n_in), n_out=np.int32(n_out),
    )
