"""Batched radix-2 NTT / inverse NTT over a prime field.

Semantics mirror arkworks' ``Radix2EvaluationDomain`` (the reference's
FFT backend for packed secret sharing, secret-sharing/src/pss.rs:43-51):

* ``ntt(F, dom, coeffs)``   == arkworks ``domain.fft(coeffs)``  — evaluate
  the polynomial with little-endian-indexed coefficients at points
  ``offset * g^i`` for i = 0..n-1.
* ``intt(F, dom, evals)``   == arkworks ``domain.ifft(evals)``.
* Inputs shorter than the domain are implicitly zero-padded, longer
  inputs are truncated — exactly arkworks' ``fft_in_place`` resize
  behavior, which the PSS pack/unpack maps rely on.

Implementation: iterative Cooley-Tukey with per-stage twiddle tables
precomputed on the host.  Each stage is a reshape + one batched field
multiply + add/sub — fully vectorized over both the batch and the
in-stage butterfly index, so the whole transform is log2(n) fused passes
over the table (no scalar loops, no dynamic shapes).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np

from ..fields.fr import Field


@dataclass(frozen=True)
class Domain:
    """A (possibly coset) radix-2 evaluation domain of size n."""

    field_name: str
    size: int
    offset: int = 1  # 1 for plain domains, F.generator for PSS secret cosets

    def __post_init__(self):
        assert self.size & (self.size - 1) == 0


@functools.lru_cache(maxsize=None)
def _stage_tables(field: Field, size: int, offset: int, inverse: bool):
    """Host-precomputed twiddles for each butterfly stage + scale factors.

    Returns (twiddles, pre_scale, post_scale):
      twiddles: list over stages of np.uint32 [m, L] Montgomery twiddle
                vectors (m = half-block size of that stage);
      pre_scale / post_scale: optional [size, L] elementwise scale vectors
                (coset offset powers; 1/n folding for the inverse).
    """
    p = field.p
    g = field.spec.root_of_unity(size) if size > 1 else 1
    if inverse:
        g = pow(g, -1, p)
    logn = size.bit_length() - 1

    twiddles = []
    # DIT stages: stage s has blocks of 2*m with m = 2^s half-size.
    for s in range(logn):
        m = 1 << s
        w = pow(g, size // (2 * m), p)
        tw = np.empty((m, field.L), dtype=np.uint32)
        acc = 1
        for j in range(m):
            tw[j] = field.to_mont_int(acc)
            acc = acc * w % p
        twiddles.append(tw)

    pre_scale = None
    post_scale = None
    if not inverse and offset != 1:
        # evaluate at offset*g^i: scale coefficient k by offset^k first
        sc = np.empty((size, field.L), dtype=np.uint32)
        acc = 1
        for k in range(size):
            sc[k] = field.to_mont_int(acc)
            acc = acc * offset % p
        pre_scale = sc
    if inverse:
        ninv = pow(size, -1, p)
        off_inv = pow(offset, -1, p) if offset != 1 else 1
        sc = np.empty((size, field.L), dtype=np.uint32)
        acc = ninv
        for k in range(size):
            sc[k] = field.to_mont_int(acc)
            acc = acc * off_inv % p
        post_scale = sc
    return twiddles, pre_scale, post_scale


def _bit_reverse_perm(n: int) -> np.ndarray:
    logn = n.bit_length() - 1
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(logn):
        rev |= ((idx >> b) & 1) << (logn - 1 - b)
    return rev


def _fit(field: Field, x: jnp.ndarray, n: int) -> jnp.ndarray:
    """Zero-pad or truncate the second-to-last axis to length n."""
    cur = x.shape[-2]
    if cur < n:
        pad = jnp.zeros(x.shape[:-2] + (n - cur, field.L), dtype=jnp.uint32)
        x = jnp.concatenate([x, pad], axis=-2)
    elif cur > n:
        x = x[..., :n, :]
    return x


def _transform(field: Field, x: jnp.ndarray, size: int, offset: int, inverse: bool):
    x = _fit(field, x, size)
    if size == 1:
        return x
    twiddles, pre_scale, post_scale = _stage_tables(field, size, offset, inverse)
    if pre_scale is not None:
        x = field.mul(x, jnp.asarray(pre_scale))
    # decimation-in-time: bit-reverse input order, then ascending stages
    x = x[..., jnp.asarray(_bit_reverse_perm(size)), :]
    logn = size.bit_length() - 1
    for s in range(logn):
        m = 1 << s
        nblocks = size >> (s + 1)
        xb = x.reshape(x.shape[:-2] + (nblocks, 2, m, field.L))
        lo = xb[..., 0, :, :]
        hi = field.mul(xb[..., 1, :, :], jnp.asarray(twiddles[s]))
        x = jnp.concatenate(
            [field.add(lo, hi)[..., None, :, :], field.sub(lo, hi)[..., None, :, :]],
            axis=-3,
        ).reshape(x.shape[:-2] + (size, field.L))
    if post_scale is not None:
        x = field.mul(x, jnp.asarray(post_scale))
    return x


def ntt(field: Field, dom: Domain, coeffs: jnp.ndarray) -> jnp.ndarray:
    """Evaluate (little-endian coeffs) on the domain; arkworks ``fft``."""
    return _transform(field, coeffs, dom.size, dom.offset, inverse=False)


def intt(field: Field, dom: Domain, evals: jnp.ndarray) -> jnp.ndarray:
    """Interpolate evaluations on the domain; arkworks ``ifft``."""
    return _transform(field, evals, dom.size, dom.offset, inverse=True)


# ---------------------------------------------------------------------------
# Distributed 4-step NTT over a data-sharded axis
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _four_step_tables(field: Field, n: int, rows: int, offset: int):
    """Host-precomputed tables for the 4-step NTT.

    Returns (pre, twiddle): ``pre[r, q] = offset^(q*rows + r)`` (None when
    offset == 1) and ``twiddle[r, k2] = w_n^(r*k2)``.
    """
    cols = n // rows
    p = field.p
    g = field.spec.root_of_unity(n)
    tw = np.empty((rows, cols, field.L), dtype=np.uint32)
    for r in range(rows):
        base = pow(g, r, p)
        acc = 1
        for k2 in range(cols):
            tw[r, k2] = field.to_mont_int(acc)
            acc = acc * base % p
    pre = None
    if offset != 1:
        pre = np.empty((rows, cols, field.L), dtype=np.uint32)
        step = pow(offset, rows, p)
        for r in range(rows):
            acc = pow(offset, r, p)
            for q in range(cols):
                pre[r, q] = field.to_mont_int(acc)
                acc = acc * step % p
    return pre, tw


def ntt_4step(field: Field, dom: Domain, coeffs: jnp.ndarray, rows: int) -> jnp.ndarray:
    """Four-step (Bailey) NTT of size n = rows * cols.

    Writing i = q*rows + r and k = k1*cols + k2:
        X[k1*cols + k2] = sum_r w_n^(r*k2) * (w_cols-DFT over q)[r, k2]
                          then a w_rows-DFT over r.
    A coset offset is folded in as an elementwise pre-scale
    c'_i = c_i * offset^i.  When the leading data axis is sharded over a
    mesh, the transposes become XLA ``all_to_all`` collectives and each
    small NTT stays chip-local — the array-native shape of a *distributed*
    NTT (replacing any mpc-net-style exchange; cf. SURVEY §5).  Output is
    in standard order, identical to ``ntt``.
    """
    n = dom.size
    assert n % rows == 0
    cols = n // rows
    x = _fit(field, coeffs, n)
    batch = x.shape[:-2]
    pre, tw = _four_step_tables(field, n, rows, dom.offset)
    # c[i] with i = q*rows + r  ->  x[r, q]
    x = x.reshape(batch + (cols, rows, field.L))
    x = jnp.swapaxes(x, -3, -2)  # [rows, cols]
    if pre is not None:
        x = field.mul(x, jnp.asarray(pre))
    # 1. inner DFT over q (length cols) for each r
    x = ntt(field, Domain(field.spec.name, cols, 1), x)
    # 2. twiddle w_n^(r*k2)
    x = field.mul(x, jnp.asarray(tw))
    # 3. outer DFT over r (length rows) for each k2
    x = jnp.swapaxes(x, -3, -2)  # [k2=cols, r=rows]
    x = ntt(field, Domain(field.spec.name, rows, 1), x)
    # 4. current layout [k2, k1] -> [k1, k2] -> flatten to k = k1*cols + k2
    x = jnp.swapaxes(x, -3, -2)
    return x.reshape(batch + (n, field.L))
