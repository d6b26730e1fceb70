"""Int8 matrix-product field arithmetic for shared-operand patterns.

The limb field multiply (fields/fr.py) pays ~3k int32 lane-ops per
Montgomery multiply.  Matrix units (the H100's tensor cores) do int8 x
int8 -> int32 products at far higher throughput — but only
contractions, not elementwise products.  Two patterns that dominate the sumcheck /
zerocheck protocol phases ARE contractions:

* ``dot_red``  — sum-of-products  t = sum_i f_i * g_i  (the t0/t1/t2
  round messages, reference dsumcheck.rs:167-220): the limb-product
  matrix G[p, q] = sum_i f8[i, p] * g8[i, q] is ONE matmul contracting
  over the (huge) evaluation axis.
* ``mul_shared`` — elementwise multiply by a BROADCAST field scalar
  (the fold  lo + c*(hi - lo), eq-table extension, fix_variable):
  with x = sum_k c_k 2^(8k), the Montgomery product is
  x*r/R = sum_k c_k * (2^(8k) * r / R mod p) — a single matmul of the
  byte-chunk matrix against a tiny per-``r`` matrix M_r whose rows are
  the byte limbs of 2^(8k)*r*R^-1 mod p.  M_r is built at trace time
  from ``r`` with ~4W Montgomery muls — negligible next to the
  [B, K] x [K, 2L] MXU matmul it enables.

Representation ("red8"): an array ``[..., W]`` of uint32 coefficients
at BYTE positions — value(x) = sum_k x[k] * 2^(8k) — with a tracked
Python-int coefficient bound.  Canonical Montgomery limb vectors embed
with bound 256; adds/subs grow the bound; every matmul stage folds the
value back mod p and resets the bound.  All bounds are static Python
ints, asserted at trace time, so overflow is impossible by
construction rather than by testing.

int8 matmuls: operands are unsigned bytes (0..255); they are biased by
-128 into int8, multiplied with ``preferred_element_type=int32``, and
the exact rank-1 bias corrections are added back.  Contraction sizes
are capped so every accumulator stays within int32.

Reference parity: replaces the same arkworks bigint ops as
fields/pallas_fr.py (dist-primitive/src/dsumcheck.rs round loops); all
outputs canonicalize to bit-identical Montgomery limbs.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from .config import LIMB_BITS, LIMB_MASK, FieldSpec, int_to_limbs

I32 = jnp.int32
U32 = jnp.uint32

# int8-matmul contraction cap: |sum (a-128)(b-128)| <= K * 2^14 < 2^29.
MAX_CONTRACT = 1 << 15


def _bytes_of_int(x: int, nbytes: int) -> np.ndarray:
    assert 0 <= x < (1 << (8 * nbytes))
    return np.array([(x >> (8 * i)) & 0xFF for i in range(nbytes)], np.uint32)


def value_of(arr) -> int:
    """Host-side: integer value of a byte-position coefficient vector."""
    out = 0
    for i, v in enumerate(np.asarray(arr, dtype=np.uint64).ravel().tolist()):
        out += int(v) << (8 * i)
    return out


@dataclass(frozen=True)
class MXUSpec:
    """Precomputed constants for one field (host-side, hashable)."""

    spec: FieldSpec

    @property
    def L(self) -> int:
        return self.spec.num_limbs

    @property
    def W(self) -> int:  # byte width of one canonical element
        return 2 * self.spec.num_limbs

    @functools.cached_property
    def p(self) -> int:
        return self.spec.modulus

    @functools.cached_property
    def R(self) -> int:
        return 1 << (LIMB_BITS * self.L)

    @functools.cached_property
    def rinv(self) -> int:
        return pow(self.R, self.p - 2, self.p)

    @functools.lru_cache(maxsize=None)
    def pow8_mont(self, kmax: int) -> tuple:
        """[kmax, L] PLAIN limb encodings of 2^(8k) mod p.

        mont_mul(r_hat, pow8_mont[k]) = r_hat * 2^(8k) * R^-1 mod p —
        exactly the row generator for the runtime fold matrices M_r
        (the R^-1 of the Montgomery mul provides the R^-1 the fold
        needs, so the rows must NOT be Montgomery-encoded)."""
        rows = np.stack(
            [
                int_to_limbs((1 << (8 * k)) % self.p, self.L)
                for k in range(kmax)
            ]
        )
        return _np_key(rows)

    @functools.lru_cache(maxsize=None)
    def red_rows(self, kmax: int, rinv_power: int = 0) -> tuple:
        """[kmax, W] byte limbs of 2^(8k) * R^-s mod p."""
        rr = pow(self.rinv, rinv_power, self.p) if rinv_power else 1
        rows = np.stack(
            [
                _bytes_of_int((1 << (8 * k)) * rr % self.p, self.W)
                for k in range(kmax)
            ]
        )
        return _np_key(rows)


def _np_key(a: np.ndarray) -> tuple:
    return (a.shape, tuple(a.ravel().tolist()))


def _np_val(key, dtype=np.uint32) -> np.ndarray:
    shape, flat = key
    return np.array(flat, dtype=dtype).reshape(shape)


@functools.lru_cache(maxsize=None)
def mxu_spec(spec: FieldSpec) -> MXUSpec:
    return MXUSpec(spec)


# ---------------------------------------------------------------------------
# Redundant byte-position values with static bound tracking
# ---------------------------------------------------------------------------
@jax.tree_util.register_pytree_node_class
@dataclass
class Red:
    """uint32 byte-position coefficients [..., W] + static coeff bound.

    value(x) = sum_k arr[..., k] * 2^(8k);   all coeffs < bound."""

    arr: jnp.ndarray
    bound: int

    def tree_flatten(self):
        return (self.arr,), self.bound

    @classmethod
    def tree_unflatten(cls, bound, children):
        return cls(children[0], bound)

    @property
    def W(self) -> int:
        return self.arr.shape[-1]


def to_red(mont_limbs: jnp.ndarray) -> Red:
    """Canonical [..., L] 16-bit limbs -> red8 [..., 2L] bytes."""
    lo = mont_limbs & 0xFF
    hi = mont_limbs >> 8
    st = jnp.stack([lo, hi], axis=-1)
    return Red(st.reshape(st.shape[:-2] + (st.shape[-2] * 2,)), 256)


def _pad_w(arr: jnp.ndarray, W: int) -> jnp.ndarray:
    if arr.shape[-1] == W:
        return arr
    pad = [(0, 0)] * (arr.ndim - 1) + [(0, W - arr.shape[-1])]
    return jnp.pad(arr, pad)


def add_red(a: Red, b: Red) -> Red:
    W = max(a.W, b.W)
    bound = a.bound + b.bound - 1
    assert bound < 1 << 32
    return Red(_pad_w(a.arr, W) + _pad_w(b.arr, W), bound)


@functools.lru_cache(maxsize=None)
def _sub_bias(spec: FieldSpec, W: int, coeff: int) -> tuple:
    """Constant D: D[k] in (coeff-256, coeff], value(D) ≡ 0 mod p.

    sub_red(a, b) = a + D - b is borrow-free in uint32 and ≡ a - b."""
    mx = mxu_spec(spec)
    D = np.full(W, coeff, dtype=object)
    v = value_of(np.array(D, dtype=np.uint64)) % mx.p
    corr = _bytes_of_int(v, W)
    D = D - corr.astype(object)
    val = sum(int(x) << (8 * k) for k, x in enumerate(D))
    assert val % mx.p == 0
    assert all(0 <= int(x) < 1 << 32 for x in D)
    return tuple(int(x) for x in D)


def sub_red(spec: FieldSpec, a: Red, b: Red) -> Red:
    W = max(a.W, b.W)
    coeff = 1 << max(b.bound - 1, 1 << 9).bit_length()
    D = jnp.asarray(_sub_bias(spec, W, coeff), U32)
    bound = a.bound + coeff
    assert bound < 1 << 32
    return Red(_pad_w(a.arr, W) + D - _pad_w(b.arr, W), bound)


def _chunk(a: Red) -> tuple[jnp.ndarray, int]:
    """Split coefficients into 8-bit chunks: [..., W] -> [..., n*W].

    Flat row (t*W + k) carries weight 2^(8*(k+t)) — byte position k+t."""
    n = max(((a.bound - 1).bit_length() + 7) // 8, 1)
    parts = [(a.arr >> (8 * t)) & 0xFF for t in range(n)]
    return jnp.concatenate(parts, axis=-1), n


def _chunk_positions(W: int, n: int) -> np.ndarray:
    """Byte position of each flat chunk row: row t*W + k -> k + t."""
    return np.concatenate([np.arange(W) + t for t in range(n)])


# ---------------------------------------------------------------------------
# Exact unsigned-byte matmuls on the int8 MXU path
# ---------------------------------------------------------------------------
def _i8mm(a_bytes: jnp.ndarray, b_bytes: jnp.ndarray,
          b_colsum: jnp.ndarray) -> jnp.ndarray:
    """Exact sum_k a[..., k] * b[k, n] for byte-valued uint32 inputs.

    sum a*b = sum (a-128)(b-128) + 128*(sum a) + 128*(sum b) - K*128^2.
    """
    K = a_bytes.shape[-1]
    assert K <= MAX_CONTRACT, K
    a8 = (a_bytes.astype(I32) - 128).astype(jnp.int8)
    b8 = (b_bytes.astype(I32) - 128).astype(jnp.int8)
    m = jax.lax.dot_general(
        a8, b8, (((a8.ndim - 1,), (0,)), ((), ())),
        preferred_element_type=I32,
    )
    arow = jnp.sum(a_bytes.astype(I32), axis=-1, keepdims=True)  # [..., 1]
    shape = (1,) * (m.ndim - 1) + (-1,)
    return m + 128 * (arow + b_colsum.reshape(shape)) - K * 128 * 128


def _dot_batch(a_bytes: jnp.ndarray, b_bytes: jnp.ndarray) -> jnp.ndarray:
    """Exact sum_i a[..., i, p] * b[..., i, q] -> [..., p, q] (contract
    the -2 axis of both)."""
    B = a_bytes.shape[-2]
    assert B <= MAX_CONTRACT, B
    a8 = (a_bytes.astype(I32) - 128).astype(jnp.int8)
    b8 = (b_bytes.astype(I32) - 128).astype(jnp.int8)
    nb = a8.ndim - 2
    m = jax.lax.dot_general(
        a8, b8,
        (((nb,), (nb,)), (tuple(range(nb)), tuple(range(nb)))),
        preferred_element_type=I32,
    )  # [..., P, Q]
    sa = jnp.sum(a_bytes.astype(I32), axis=-2)  # [..., P]
    sb = jnp.sum(b_bytes.astype(I32), axis=-2)  # [..., Q]
    return m + 128 * (sa[..., :, None] + sb[..., None, :]) - B * 128 * 128


# ---------------------------------------------------------------------------
# Montgomery fold stages
# ---------------------------------------------------------------------------
def reduce_red(spec: FieldSpec, x: Red, rinv_power: int = 0) -> Red:
    """Fold any red8 to width-W coefficients ≡ value(x) * R^-s mod p."""
    mx = mxu_spec(spec)
    ch, n = _chunk(x)
    pos = _chunk_positions(x.W, n)
    rows_np = _np_val(mx.red_rows(int(pos.max()) + 1, rinv_power))[pos]
    K = ch.shape[-1]
    bound = K * 255 * 255 + 1
    assert bound < 1 << 31
    colsum = jnp.asarray(rows_np.astype(np.int64).sum(0).astype(np.int32))
    out = _i8mm(ch, jnp.asarray(rows_np, U32), colsum)
    return Red(out.astype(U32), bound)


def fold_matrix(spec: FieldSpec, F, r_mont: jnp.ndarray,
                src_bound: int, src_W: int):
    """Build the shared-scalar matrix for :func:`mul_shared`.

    ``r_mont``: canonical Montgomery scalar [L] (may be traced).
    Returns (M_r [kmax, W] uint32 bytes, colsum [W] int32) where row k
    holds the byte limbs of (2^(8k) * r * R^-1 mod p) — kmax Montgomery
    muls + a byte split at trace time."""
    mx = mxu_spec(spec)
    n = max(((src_bound - 1).bit_length() + 7) // 8, 1)
    kmax = src_W + n  # positions k + t reach src_W - 1 + n - 1
    pows = jnp.asarray(_np_val(mx.pow8_mont(kmax)))  # [kmax, L]
    rows = F.mul(jnp.broadcast_to(r_mont, pows.shape), pows)  # [kmax, L]
    st = jnp.stack([rows & 0xFF, rows >> 8], axis=-1)
    return st.reshape(kmax, mx.W), kmax


def mul_shared(spec: FieldSpec, x: Red, m_r: jnp.ndarray) -> Red:
    """Montgomery-multiply every element of ``x`` by one shared scalar.

    ``m_r``: [kmax, W] from :func:`fold_matrix` built with the SAME
    (src_bound, src_W) as ``x`` (kmax must cover x's chunk positions).
    """
    ch, n = _chunk(x)
    pos = _chunk_positions(x.W, n)
    assert int(pos.max()) + 1 <= m_r.shape[0], (pos.max(), m_r.shape)
    rows = jnp.take(m_r, jnp.asarray(pos), axis=0)  # [K, W]
    K = ch.shape[-1]
    bound = K * 255 * 255 + 1
    assert bound < 1 << 31
    colsum = jnp.sum(rows.astype(I32), axis=0)  # traced (m_r is traced)
    out = _i8mm(ch, rows, colsum)
    return Red(out.astype(U32), bound)


# ---------------------------------------------------------------------------
# Sum-of-products (contraction over the evaluation axis)
# ---------------------------------------------------------------------------
def _diag_sums(g: jnp.ndarray) -> jnp.ndarray:
    """Anti-diagonal sums of [..., P, Q] -> [..., P+Q-1] (pad+reshape)."""
    P, Q = g.shape[-2], g.shape[-1]
    pad = [(0, 0)] * (g.ndim - 2) + [(0, 0), (0, P)]
    b = jnp.pad(g, pad).reshape(g.shape[:-2] + (P * (Q + P),))
    b = b[..., : P * (Q + P - 1)].reshape(g.shape[:-2] + (P, Q + P - 1))
    return jnp.sum(b, axis=-2)


def _pos_group_matrix(pos: np.ndarray) -> np.ndarray:
    """[rows, n_positions] 0/1 matrix grouping chunk rows by position."""
    P = int(pos.max()) + 1
    m = np.zeros((len(pos), P), np.int32)
    m[np.arange(len(pos)), pos] = 1
    return m


def dot_red(spec: FieldSpec, f: Red, g: Red) -> Red:
    """sum_i mont(f_i * g_i) over axis -2: [..., B, W] -> [..., W'].

    Result ≡ (sum_i value(f_i) * value(g_i)) * R^-1 mod p.  The batch
    axis is contracted on the MXU; batches larger than MAX_CONTRACT are
    split and the (tiny) per-piece results added."""
    B = f.arr.shape[-2]
    if B > MAX_CONTRACT:
        pieces = []
        for s in range(0, B, MAX_CONTRACT):
            e = min(s + MAX_CONTRACT, B)
            pieces.append(
                dot_red(
                    spec,
                    Red(f.arr[..., s:e, :], f.bound),
                    Red(g.arr[..., s:e, :], g.bound),
                )
            )
        return functools.reduce(add_red, pieces)

    fc, nf = _chunk(f)  # [..., B, Kf]
    gc, ng = _chunk(g)
    gmat = _dot_batch(fc, gc)  # [..., Kf, Kg] exact int32, >= 0
    pf = _chunk_positions(f.W, nf)
    pg = _chunk_positions(g.W, ng)
    mf = jnp.asarray(_pos_group_matrix(pf))  # [Kf, Pf]
    mg = jnp.asarray(_pos_group_matrix(pg))  # [Kg, Pg]
    Pf, Pg = mf.shape[1], mg.shape[1]
    # gmat < 2^31: split into 16-bit halves before position/diag summing
    glo = (gmat.astype(U32) & 0xFFFF).astype(I32)
    ghi = (gmat.astype(U32) >> 16).astype(I32)

    def pos_sum(m):  # [..., Kf, Kg] -> [..., Pf, Pg]
        m = jnp.einsum("...pq,pa->...aq", m, mf)
        return jnp.einsum("...aq,qb->...ab", m, mg)

    # per-position group sizes <= nf (resp ng); diag over <= min(Pf, Pg)
    dlo = _diag_sums(pos_sum(glo)).astype(U32)  # [..., Pf+Pg-1]
    dhi = _diag_sums(pos_sum(ghi)).astype(U32)
    b_lo = min(Pf, Pg) * nf * ng * ((1 << 16) - 1) + 1
    b_hi = min(Pf, Pg) * nf * ng * ((1 << 15) - 1) + 1
    W = Pf + Pg - 1 + 2
    arr = _pad_w(dlo, W) + _pad_w(
        jnp.concatenate([jnp.zeros(dhi.shape[:-1] + (2,), U32), dhi], -1), W
    )
    bound = b_lo + b_hi
    assert bound < 1 << 32
    return reduce_red(spec, Red(arr, bound), rinv_power=1)


# ---------------------------------------------------------------------------
# Canonicalization (phase boundaries)
# ---------------------------------------------------------------------------
def canon(spec: FieldSpec, F, x: Red) -> jnp.ndarray:
    """red8 -> canonical Montgomery limbs [..., L] (value mod p).

    Iterated ripple-carry + top-carry fold with STATIC bound tracking:
    each round replaces the carry c (weight R = 2^(8W)) by c*(R mod p),
    shrinking the value by (R mod p)/R (< 0.1x for both BLS fields); the
    Python loop runs until the tracked carry bound hits zero, then a
    constant ladder of conditional subtracts lands in [0, p).  Used at
    phase boundaries only (round messages, folded finals)."""
    mx = mxu_spec(spec)
    y = x
    while y.bound > 1 << 24 or y.W != mx.W:
        y = reduce_red(spec, y, rinv_power=0)  # W = mx.W, bound < 2^24.2

    def ripple(arr):
        c = jnp.zeros_like(arr[..., 0])
        outs = []
        for k in range(mx.W):
            s = arr[..., k] + c
            outs.append(s & 0xFF)
            c = s >> 8
        return jnp.stack(outs, axis=-1), c

    rp_bytes = jnp.asarray(_bytes_of_int(mx.R % mx.p, mx.W), U32)
    rmodp = mx.R % mx.p
    assert 2 * rmodp < mx.R  # holds for 16-bit-limb Montgomery fields
    geom = ((1 << (8 * mx.W)) - 1) // 255  # sum_k 2^(8k)
    vb = (y.bound - 1) * geom  # value bound (inclusive)
    arr = y.arr
    for _ in range(64):  # static; bound-driven, ~6 iterations
        cb = vb >> (8 * mx.W)
        bytes_, c = ripple(arr)
        if cb == 0:
            arr = bytes_
            break
        assert cb * 255 < 1 << 32  # coefficient overflow guard
        arr = bytes_ + c[..., None] * rp_bytes
        if cb == 1:
            # value was < R + (R mod p); after this fold it is
            # < max(R, 2*(R mod p)) = R, so the NEXT ripple carries 0.
            vb = mx.R - 1
        else:
            vb = (1 << (8 * mx.W)) - 1 + cb * rmodp
    else:  # pragma: no cover - bound tracking guarantees termination
        raise AssertionError("canon did not converge")
    limbs = jnp.stack(
        [arr[..., 2 * j] + (arr[..., 2 * j + 1] << 8) for j in range(mx.L)],
        axis=-1,
    )
    # value < R: subtract p << s for s = floor(log2(R/p)) .. 0
    s_top = (mx.R // mx.p).bit_length() - 1
    for s in range(s_top, -1, -1):
        if (mx.p << s) < (1 << (16 * mx.L)):
            limbs = _cond_sub_const(limbs, (mx.p << s), mx.L)
    return limbs


def _cond_sub_const(limbs: jnp.ndarray, sub_val: int, L: int) -> jnp.ndarray:
    """Subtract ``sub_val`` iff limbs >= sub_val (16-bit borrow probe)."""
    sub = int_to_limbs(sub_val, L)
    borrow = jnp.zeros_like(limbs[..., 0])
    diff = []
    for j in range(L):
        d = limbs[..., j] - jnp.uint32(int(sub[j])) - borrow
        borrow = (d >> 31) & 1
        diff.append(d & jnp.uint32(LIMB_MASK))
    take = borrow == 0
    return jnp.where(take[..., None], jnp.stack(diff, axis=-1), limbs)


def sum_red(spec: FieldSpec, f: Red) -> Red:
    """Plain sum over axis -2: [..., B, W] -> [..., W'] ≡ sum_i value(f_i).

    (No R^-1 factor — unlike :func:`dot_red` this is a linear sum, used
    for the single-table sumcheck round messages.)"""
    B = f.arr.shape[-2]
    if B > MAX_CONTRACT:
        pieces = [
            sum_red(spec, Red(f.arr[..., s : s + MAX_CONTRACT, :], f.bound))
            for s in range(0, B, MAX_CONTRACT)
        ]
        return functools.reduce(add_red, pieces)
    fc, nf = _chunk(f)  # [..., B, K]
    ones = jnp.ones(fc.shape[:-1] + (1,), U32)
    cs = _dot_batch(fc, ones)[..., 0]  # [..., K] exact, < B * 255
    pos = _chunk_positions(f.W, nf)
    m = jnp.asarray(_pos_group_matrix(pos))  # [K, P]
    by_pos = jnp.einsum("...k,kp->...p", cs.astype(I32), m).astype(U32)
    bound = nf * B * 255 + 1
    assert bound < 1 << 32
    x = Red(by_pos, bound)
    return reduce_red(spec, x, rinv_power=0) if bound > 1 << 26 else x
