"""Shared benchmark-harness helpers (bench.py, chip_smoke.py, scripts/).

Compile cache: a cold prove spends minutes tracing and compiling the
phase executables, so every entry point shares one cache directory —
``JAX_COMPILATION_CACHE_DIR`` when it is set (JAX reads it itself),
else the fixed ``<repo>/.jax_cache`` (the path is part of the cache
key, so it must not move).  The benchmark SRS (``srs/``) and the
phase-export artifacts (``phases/``) live under the same directory.
"""

from __future__ import annotations

import functools
import os
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]


def cache_dir() -> Path:
    """The compile-cache directory every entry point shares."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    return Path(env) if env else REPO / ".jax_cache"


def device_info() -> dict:
    """The device JAX computes on, as every result line names it."""
    import jax

    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def enable_compile_cache() -> Path:
    """Turn on JAX's persistent compilation cache at :func:`cache_dir`.

    XLA:CPU entries are CPU-feature-specific and unsafe to share, so
    the fallback directory is not installed on the CPU backend; the
    SRS and phase caches follow the directory on every backend.
    """
    import jax

    d = cache_dir()
    if "JAX_COMPILATION_CACHE_DIR" not in os.environ and (
        jax.default_backend() != "cpu"
    ):
        jax.config.update("jax_compilation_cache_dir", str(d))
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)
    # benchmark-SRS disk cache rides along: stable SRS values are ALSO
    # what makes the phase executables' cache keys stable across
    # processes (the SRS levels are embedded as jaxpr constants)
    os.environ.setdefault("SCZK_SRS_CACHE", str(d / "srs"))
    return d


@functools.cache
def _leaf_digest():
    import jax
    import jax.numpy as jnp

    @jax.jit
    def dig(a):
        x = a.ravel().astype(jnp.uint32)
        w = (jnp.arange(x.size, dtype=jnp.uint32) % jnp.uint32(8191)) + 1
        return jnp.sum(x * w, dtype=jnp.uint32)

    return dig


def canonicalize_proof(out):
    """Normalize every G1 point in a proof bundle to its canonical
    representative (affine (x, y, 1) or infinity (0, 1, 0)).

    MSM backends legitimately differ in the Jacobian representative they
    return (native FFI Pippenger vs the dense-scan GPU core vs the naive
    ladder; window width and signed-digit choices also change Z), so a
    VALUE comparison across backends must canonicalize first.  Field
    values are already canonical (Montgomery limbs reduced mod p)."""
    import jax

    from ..curves.g1 import PointJ, bls12_381_g1

    cv = bls12_381_g1()
    is_pt = lambda x: isinstance(x, PointJ)
    return jax.tree.map(
        lambda x: cv.normalize(x) if is_pt(x) else x, out, is_leaf=is_pt
    )


@functools.cache
def _bundle_digest_fn():
    import jax
    import jax.numpy as jnp

    @jax.jit
    def dig_all(out):
        canon = canonicalize_proof(out)

        def dig(a):
            x = a.ravel().astype(jnp.uint32)
            w = (jnp.arange(x.size, dtype=jnp.uint32) % jnp.uint32(8191)) + 1
            return jnp.sum(x * w, dtype=jnp.uint32)

        return tuple(dig(leaf) for leaf in jax.tree.leaves(canon))

    return dig_all


def proof_digest(out) -> int:
    """Order-sensitive 64-bit digest of a proof bundle.

    G1 points are canonicalized to affine first (see
    :func:`canonicalize_proof`), then per-leaf position-weighted uint32
    checksums are folded host-side; any single-bit change in any VALUE
    (or a leaf-order change) flips the digest, while representation
    differences between MSM backends do not.  This is what lets one
    CPU-pinned digest certify the GPU paths on real hardware
    (bench.py, chip_smoke.py).  All device work (canonicalize + per-leaf
    checksums) runs as ONE jitted dispatch — a flagship bundle has
    hundreds of leaves."""
    import jax

    digs = jax.device_get(_bundle_digest_fn()(out))
    d = 0
    for leaf in digs:
        d = (d * 1000003 + int(leaf)) % (1 << 64)
    return d
