"""CUDA kernels for the BLS12-381 field and G1 group law on the GPU.

* **Field ops** (``field_op``): elementwise Fr / Fq multiply, add and
  subtract, one thread per element on 4 / 6 x 64-bit Montgomery words
  (32 x 32 -> 64-bit products).  Each op is one custom call, so a
  protocol phase compiles like the CPU path's FFI graphs instead of
  inlining a ~3k-op unrolled limb multiply at every call site.
* **Point ops** (``point_op``): one kernel per group-law operation (add /
  double / mixed add with the MSM accumulate selects) instead of the
  dozens of limb loops the plain jnp formula runs; the whole formula
  stays in registers.  The mixed-add reset step is the accumulate step
  of the dense MSM (primitives/msm.py::_dense_bucket_sums), the prove's
  floor.

The arithmetic lives in ``native/gpu_kernels.h``; ``native/gpu_kernels.cu``
wraps it as XLA FFI targets built for ``sm_90a`` with nvcc at first use
(into ``native/build/``, rebuilt when the sources, flags or host change),
and ``native/host_kernels.cc`` builds the same code for the CPU so the
tests check the kernels' results without a card (``host_*``).  Layout at
the boundary: uint32 ``[..., L]`` 16-bit Montgomery limbs (the
fields/fr.py contract, L = 16 for Fr, 24 for Fq); the kernels repack
each lane to 64-bit words on load and store.
"""

from __future__ import annotations

import ctypes
import functools
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

OPS = ("add", "add_mixed", "double", "add_masked", "add_reset",
       "add_reset_lazy")
"""Point op names in the order of ``enum Op`` in native/gpu_kernels.h."""

FIELD_OPS = ("mul", "add", "sub")
"""Field op names in the order of ``enum FieldOp``."""

FIELD_IDS = {"bls12_381_fr": 0, "bls12_381_fq": 1}
"""Fields the kernels implement (``field`` attribute of the FFI call)."""

FQ = "bls12_381_fq"
TARGET = "sczk_g1_point"
FIELD_TARGET = "sczk_field_op"

_NATIVE = Path(__file__).resolve().parents[1] / "native"
_HEADER = _NATIVE / "gpu_kernels.h"


def _nvcc() -> str:
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


@functools.lru_cache(maxsize=1)
def ensure_registered() -> None:
    """Build the CUDA library (first use) and register its FFI targets."""
    from .native import build_library

    so = _NATIVE / "build" / "libsczkcuda.so"
    build_library(
        _NATIVE / "gpu_kernels.cu", so,
        [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
         "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
         f"-I{jax.ffi.include_dir()}", f"-I{_NATIVE}"],
        required=True, deps=(_HEADER,),
    )
    lib = ctypes.CDLL(str(so))
    jax.ffi.register_ffi_target(
        TARGET, jax.ffi.pycapsule(lib.SczkG1Point), platform="CUDA"
    )
    jax.ffi.register_ffi_target(
        FIELD_TARGET, jax.ffi.pycapsule(lib.SczkFieldOp), platform="CUDA"
    )


def field_op(op: str, field_name: str, a, b):
    """Elementwise field op on same-shape uint32 [..., L] arrays."""
    ensure_registered()
    out = jax.ShapeDtypeStruct(a.shape, jnp.uint32)
    return jax.ffi.ffi_call(FIELD_TARGET, out, vmap_method="broadcast_all")(
        a, b, field=np.int32(FIELD_IDS[field_name]),
        op=np.int32(FIELD_OPS.index(op)),
    )


def _flat(coords, mask):
    """Six [m, 24] coordinate arrays and a uint32 [m] mask."""
    shape = coords[0].shape
    m = int(np.prod(shape[:-1], dtype=np.int64))
    flat = [c.reshape(m, shape[-1]) for c in coords]
    if len(flat) == 3:  # double: the second operand is not read
        flat = flat + flat
    if mask is None:
        mask = jnp.zeros((m,), jnp.uint32)
    else:
        mask = mask.reshape(m).astype(jnp.uint32)
    return flat, mask, shape


def point_op(op: str, fq_name: str, coords, mask=None):
    """Run one fused point kernel over a batch.

    ``coords``: tuple of [..., 24] uint32 arrays (X1, Y1, Z1[, X2, Y2,
    Z2]) sharing one batch shape; ``mask``: bool [...] for the masked /
    reset ops.  Returns the output coordinates (and, for
    ``add_reset_lazy``, the bool [...] doubling flags)."""
    assert op in OPS and fq_name == FQ, (op, fq_name)
    ensure_registered()
    flat, mask, shape = _flat(coords, mask)
    m = mask.shape[0]
    out_types = [jax.ShapeDtypeStruct((m, shape[-1]), jnp.uint32)] * 3 + [
        jax.ShapeDtypeStruct((m,), jnp.uint32)
    ]
    out = jax.ffi.ffi_call(TARGET, out_types, vmap_method="broadcast_all")(
        *flat, mask, op=np.int32(OPS.index(op))
    )
    res = tuple(o.reshape(shape) for o in out[:3])
    if op == "add_reset_lazy":
        res = res + (out[3].reshape(shape[:-1]) > 0,)
    return res


@functools.lru_cache(maxsize=1)
def _host_lib():
    from .native import build_library

    so = _NATIVE / "build" / "libsczkhost.so"
    build_library(
        _NATIVE / "host_kernels.cc", so,
        ["g++", "-O2", "-fPIC", "-shared", "-std=c++17"],
        required=True, deps=(_HEADER,),
    )
    lib = ctypes.CDLL(str(so))
    lib.sczk_g1_point_host.restype = None
    lib.sczk_field_host.restype = None
    return lib


def host_field_op(op: str, field_name: str, a, b):
    """The field kernels' code run on the CPU (numpy in and out)."""
    a = np.ascontiguousarray(np.asarray(a, np.uint32))
    b = np.ascontiguousarray(np.broadcast_to(np.asarray(b, np.uint32),
                                             a.shape))
    out = np.zeros_like(a)
    m = a.size // a.shape[-1]
    u32p = ctypes.POINTER(ctypes.c_uint32)
    _host_lib().sczk_field_host(
        ctypes.c_int(FIELD_IDS[field_name]),
        ctypes.c_int(FIELD_OPS.index(op)), ctypes.c_int64(m),
        a.ctypes.data_as(u32p), b.ctypes.data_as(u32p),
        out.ctypes.data_as(u32p),
    )
    return out


def host_point_op(op: str, coords, mask=None):
    """The point kernels' code run on the CPU (numpy in and out)."""
    assert op in OPS, op
    coords = [np.ascontiguousarray(np.asarray(c, np.uint32)) for c in coords]
    shape = coords[0].shape
    m = int(np.prod(shape[:-1], dtype=np.int64))
    flat = [c.reshape(m, shape[-1]) for c in coords]
    if len(flat) == 3:
        flat = flat + flat
    mk = np.zeros((m,), np.uint32) if mask is None else np.ascontiguousarray(
        np.asarray(mask).reshape(m).astype(np.uint32))
    outs = [np.zeros((m, shape[-1]), np.uint32) for _ in range(3)]
    flag = np.zeros((m,), np.uint32)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    ins = (u32p * 6)(*[a.ctypes.data_as(u32p) for a in flat])
    outp = (u32p * 3)(*[a.ctypes.data_as(u32p) for a in outs])
    _host_lib().sczk_g1_point_host(
        ctypes.c_int(OPS.index(op)), ctypes.c_int64(m), ins,
        mk.ctypes.data_as(u32p), outp, flag.ctypes.data_as(u32p),
    )
    res = tuple(o.reshape(shape) for o in outs)
    if op == "add_reset_lazy":
        res = res + (flag.reshape(shape[:-1]) > 0,)
    return res
