"""Multi-scalar multiplication (MSM) on the accelerator + the distributed d_msm.

The reference's MSM is arkworks' Pippenger (`G::msm`, dmsm.rs:19-24) —
a serial bucket method with data-dependent indexing that does not map to
a SIMD machine.  The formulation here keeps Pippenger's
window/bucket *math* but replaces bucket scatter-accumulation with
**sort + segmented associative scan**:

  per c-bit window:
    1. digit extraction (vectorized bit slicing of standard-form limbs);
    2. sort point indices by digit (one XLA key sort);
    3. segmented inclusive scan with the group law as combiner
       (`lax.associative_scan` — O(n) point-adds at log depth);
    4. the last element of each digit-segment is that bucket's sum; a
       masked scatter (collisions only ever target the ignored 0-bucket)
       lands them in a [2^c] bucket table;
    5. bucket aggregation sum_k k*B_k via a reversed suffix scan;
  windows run under one `lax.scan`, combined Horner-style (c doublings
  per window).

Everything is branch-free and static-shaped; the only value-dependent
data movement is the sort.

`d_msm` (dmsm.rs:9-43): each party runs a local MSM over its share
vectors; the reference then leader-gathers, unpack2s each batch column,
sums the l secrets and re-packs (dmsm.rs:29-40).  That leader map is the
*rank-1* linear map (pack∘replicate∘sum∘unpack2) = q ⊗ w over the party
axis, so we evaluate it as two small fixed-scalar combinations — the
reference's leader MSM hotspot (48-494 ms rounds in its trace) becomes
two batched device ops.
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

from ..curves.g1 import Curve, PointJ
from ..fields.config import LIMB_BITS
from ..mpc.net import PartyNet
from ..pss.pss import PackedSharingParams


def _digit(scalars_std: jnp.ndarray, c: int, w: jnp.ndarray) -> jnp.ndarray:
    """Window-w base-2^c digit of each scalar ([N, L] uint32 -> [N])."""
    bitpos = w * c
    limb = bitpos // LIMB_BITS
    off = bitpos % LIMB_BITS
    L = scalars_std.shape[-1]
    lo = jnp.take(scalars_std, jnp.minimum(limb, L - 1), axis=-1)
    hi = jnp.where(
        limb + 1 < L, jnp.take(scalars_std, jnp.minimum(limb + 1, L - 1), axis=-1), 0
    )
    val = (lo >> off) | jnp.where(off > 0, hi << (LIMB_BITS - off), 0)
    return val & jnp.uint32((1 << c) - 1)


def _auto_c_enabled() -> bool:
    """Cost-model window-width override for flat dense MSMs (default on)."""
    return os.environ.get("SCZK_MSM_AUTO_C", "1") != "0"


def _signed_enabled() -> bool:
    """Signed-digit windows in the dense cores (default on).

    Signed base-2^c digits lie in (-2^(c-1), 2^(c-1)], so the bucket
    count per window halves to K = 2^(c-1)+1 — the weighted reduce costs
    half at equal c, and the cost model can afford wider windows (fewer
    accumulate adds, the prove's ALU floor).
    Safe with arbitrary (even duplicated) bases: the add formulas are
    complete (P + (-P) -> infinity via the is_cancel select,
    native/gpu_kernels.h add_pts)."""
    return os.environ.get("SCZK_MSM_SIGNED", "1") != "0"


def _signed_digit_block(scalars_std: jnp.ndarray, c: int, ws, carry):
    """Signed digits for a block of ascending windows.

    ``ws``: [wc] window indices (traced ok, ascending, contiguous);
    ``carry``: [N] uint32 carry into window ws[0].  Returns
    (mags [wc, N] uint32, negs [wc, N] bool, carry_out [N]).

    Conversion: d = raw + carry; if d > 2^(c-1): d -= 2^c, carry 1.
    The strict > keeps +2^(c-1) positive, so magnitudes fit in
    [0, 2^(c-1)] and — because scalars are < 2^255 < 2^(c*W)/2 — the
    top window never carries out (the final window holds < 2^(c-1)
    after carry for every c; see the window-count analysis in
    _msm_1d_dense)."""
    half = jnp.uint32(1 << (c - 1))
    full = jnp.uint32(1 << c)
    mags, negs = [], []
    wc = ws.shape[0] if hasattr(ws, "shape") else len(ws)
    for j in range(int(wc)):
        d = _digit(scalars_std, c, ws[j]) + carry
        neg = d > half
        carry = neg.astype(jnp.uint32)
        mags.append(jnp.where(neg, full - d, d))
        negs.append(neg)
    return jnp.stack(mags), jnp.stack(negs), carry


def _negate_where(curve: Curve, pts: PointJ, neg_mask: jnp.ndarray) -> PointJ:
    """Conditional point negation: y -> p - y on flagged entries
    (identity rows keep z = 0, so their y is irrelevant)."""
    y_neg = curve.fq.neg(pts.y)
    return PointJ(pts.x, jnp.where(neg_mask[..., None], y_neg, pts.y), pts.z)


def _seg_scan_last(curve: Curve, seg: jnp.ndarray, pts: PointJ) -> PointJ:
    """Inclusive segmented point-sum scan (Hillis-Steele).

    Returns scanned points where the last element of each equal-``seg``
    run holds that segment's sum.  Expressed as a single fori_loop whose
    body contains ONE group add (kept deliberately small: XLA compile
    time of the limb-arithmetic graphs is the binding constraint; the
    n log n vs n work trade is a good one on a wide lane machine).
    """
    n = seg.shape[0]
    steps = max((n - 1).bit_length(), 1)
    idx = jnp.arange(n)

    def body(k, carry):
        s, p = carry
        sh = jnp.int32(1) << k
        p_sh = jax.tree.map(lambda a: jnp.roll(a, sh, axis=0), p)
        s_sh = jnp.roll(seg, sh, axis=0)  # original seg ids suffice
        ok = jnp.logical_and(idx >= sh, s_sh == seg)
        combined = curve.add(p, p_sh)
        return s, curve.select(ok, combined, p)

    _, out = jax.lax.fori_loop(0, steps, body, (seg, pts))
    return out


def _prefix_sum_points(curve: Curve, pts: PointJ) -> PointJ:
    """Plain inclusive prefix point-sum (Hillis-Steele, one add in body)."""
    n = pts.x.shape[0]
    steps = max((n - 1).bit_length(), 1)
    idx = jnp.arange(n)

    def body(k, p):
        sh = jnp.int32(1) << k
        p_sh = jax.tree.map(lambda a: jnp.roll(a, sh, axis=0), p)
        ok = idx >= sh
        return curve.select(ok, curve.add(p, p_sh), p)

    return jax.lax.fori_loop(0, steps, body, pts)


NAIVE_MAX = 256
"""Below this size, Pippenger's bucket overhead loses to plain batched
double-and-add (~2 point-ops per scalar bit on N lanes vs ~24 per window
element): the small-MSM path is one scalar_mul scan + a tree sum."""


def _horner_windows(curve: Curve, totals: PointJ, c: int) -> PointJ:
    """Window combine res = sum_w 2^(c*w) * totals[w] ([W, C...] -> [C...]).

    A scan of W steps, each c doublings and one add (one fused kernel
    each on the GPU)."""
    rev_tot = jax.tree.map(lambda a: a[::-1], totals)

    def horner(res, tot):
        for _ in range(c):
            res = curve.double(res)
        return curve.add(res, PointJ(*tot)), None

    res0 = curve.infinity(totals.x.shape[1:-1])
    res, _ = jax.lax.scan(horner, res0, tuple(rev_tot))
    return res


def _weighted_bucket_totals(curve: Curve, acc_wck: PointJ) -> PointJ:
    """sum_{k>=1} k*B_k per (window, segment): [W, C, K, L] -> [W, C, L].

    Reversed inclusive prefix-scan, then a tree sum of the suffixes:
    ~2*log2(K) add rounds at W*C*K lanes."""
    K = acc_wck.x.shape[2]
    rev = jax.tree.map(lambda t: t[:, :, ::-1], acc_wck)
    pref = _prefix_scan_axis1(curve, rev, axis=2)
    suff = jax.tree.map(lambda t: t[:, :, : K - 1], pref)
    return curve.sum(suff, axis=2)


def _prefix_scan_axis1(curve: Curve, pts: PointJ, axis: int = 1) -> PointJ:
    """Inclusive prefix point-sum along a batch axis (Hillis-Steele)."""
    n = pts.x.shape[axis]
    steps = max((n - 1).bit_length(), 1)
    batch_ndim = pts.x.ndim - 1  # limb axis excluded
    idx = jnp.arange(n).reshape(
        (1,) * axis + (n,) + (1,) * (batch_ndim - axis - 1)
    )

    def body(k, p):
        sh = jnp.int32(1) << k
        p_sh = jax.tree.map(lambda a: jnp.roll(a, sh, axis=axis), p)
        ok = idx >= sh
        return curve.select(ok, curve.add(p, p_sh), p)

    return jax.lax.fori_loop(0, steps, body, pts)


def _msm_1d_buckets(curve: Curve, points: PointJ, scalars_std: jnp.ndarray,
                    c: int, affine: bool = False) -> PointJ:
    """Bucket-serial windowed Pippenger (the ``SCZK_MSM_DENSE=0`` core).

    Classic Pippenger does W·(N + 2^c) point-adds but relies on bucket
    scatter-accumulation.  The segmented-scan formulation (docstring at
    top) is scatter-free but pays a log N work factor.  This one gets
    the W·N add count AND stays scatter-free:

      1. per window, sort point *indices* by digit (one u32 key sort);
      2. bucket boundaries via searchsorted (starts/lens per bucket);
      3. a while_loop over t = 0..max bucket length: every (window,
         bucket) lane gathers its t-th member point and accumulates it
         with ONE mixed add per iteration — W·2^c lanes in parallel,
         so the loop does N adds per window in ~N/2^c iterations;
      4. suffix-scan weighted bucket reduce, Horner over windows.

    Input points are normalized to affine once (batched inversion) so
    the inner accumulate uses the cheaper mixed add.

    Why NOT affine-batched accumulation (the classic CPU follow-up —
    replace the Jacobian mixed add with an affine add plus a Montgomery
    batch inversion per iteration): batch inversion needs a prefix
    product over the W*2^c accumulate lanes, and a parallel prefix
    (Hillis-Steele / `associative_scan`) does n*log2(n) work — at 8k
    lanes that is ~2*13 field muls per lane per iteration to save the
    ~7-mul difference between mixed-Jacobian (11M+5S) and affine
    (1I+2M+1S) adds.  The trade only wins on machines with a serial
    O(n) product pass; on a lane machine it loses ~3x.
    """
    N = scalars_std.shape[-2]
    nbits = scalars_std.shape[-1] * LIMB_BITS
    W = (nbits + c - 1) // c
    K = 1 << c
    # pre-normalized bases (z in {0,1}) skip the per-call batch inversion
    aff = points if affine else curve.normalize(points)

    ws = jnp.arange(W, dtype=jnp.uint32)
    digits = jax.vmap(lambda w: _digit(scalars_std, c, w))(ws)  # [W, N]
    iota = jnp.broadcast_to(jnp.arange(N, dtype=jnp.uint32)[None], (W, N))
    sorted_d, sorted_i = jax.lax.sort_key_val(digits, iota, dimension=1)
    ks = jnp.arange(K, dtype=jnp.uint32)
    starts = jax.vmap(
        lambda sd: jnp.searchsorted(sd, ks, side="left")
    )(sorted_d).astype(jnp.int32)  # [W, K]
    ends = jax.vmap(
        lambda sd: jnp.searchsorted(sd, ks, side="right")
    )(sorted_d).astype(jnp.int32)
    lens = ends - starts
    lens = lens.at[:, 0].set(0)  # digit 0 contributes nothing
    maxlen = jnp.max(lens)

    acc0 = curve.infinity((W, K))

    def cond(state):
        t, _ = state
        return t < maxlen

    def body(state):
        t, acc = state
        pos = jnp.minimum(starts + t, N - 1)  # [W, K]
        pid = jnp.take_along_axis(sorted_i, pos, axis=1).astype(jnp.int32)
        pt = jax.tree.map(lambda a: jnp.take(a, pid, axis=0), aff)
        acc = curve.add_mixed_masked(acc, pt, t < lens)
        return t + 1, acc

    _, acc = jax.lax.while_loop(cond, body, (jnp.int32(0), acc0))

    # sum_k k*B_k per window via the fused weighted bucket reduce
    totals = jax.tree.map(
        lambda a: a[:, 0],
        _weighted_bucket_totals(
            curve, jax.tree.map(lambda a: a[:, None], acc)
        ),
    )  # [W]

    # Horner over windows, MSB window first: res = 2^c * res + total_w
    return _horner_windows(curve, totals, c)


def _msm_1d(curve: Curve, points: PointJ, scalars_std: jnp.ndarray, c: int,
            affine: bool = False) -> PointJ:
    """MSM for unbatched inputs: points [N], scalars [N, L] standard form.

    Algorithm is chosen by static size: tiny tables use double-and-add;
    large ones the sort+scan Pippenger.  There, all ~nbits/c windows are
    *independent*, so they run as one vmapped batch (a [W, N] lane grid);
    only the tiny Horner combine (c doublings +
    1 add per window on a single point) is sequential.  jitted with
    (curve, c) static: the inner scans close over the point table, so an
    un-jitted call would bake it into the jaxpr as a constant and
    recompile on every invocation (~25-30 s on CPU).  Under jit the
    executable caches per shape."""
    if scalars_std.shape[0] <= NAIVE_MAX:
        return curve.sum(curve.scalar_mul(points, scalars_std), axis=0)
    if _dense_enabled():
        return _msm_1d_dense(curve, points, scalars_std, c, affine=affine)
    return _msm_1d_buckets(curve, points, scalars_std, c, affine=affine)


def _msm_1d_segscan(curve: Curve, points: PointJ, scalars_std: jnp.ndarray,
                    c: int) -> PointJ:
    """Sort + segmented-scan Pippenger (superseded by _msm_1d_buckets,
    which does ~log N fewer point-adds; kept as a cross-check oracle)."""
    nbits = scalars_std.shape[-1] * LIMB_BITS
    n_windows = (nbits + c - 1) // c
    N = scalars_std.shape[0]
    nb = 1 << c

    def window(w):
        d = _digit(scalars_std, c, w)  # [N]
        order = jnp.argsort(d)
        ds = d[order]
        pts = jax.tree.map(lambda a: a[order], points)
        scanned = _seg_scan_last(curve, ds, pts)
        nxt = jnp.concatenate([ds[1:], jnp.full_like(ds[:1], nb)], 0)
        is_last = ds != nxt
        # route non-last entries (and digit-0 segments) to the ignored 0-bucket
        idx = jnp.where(is_last, ds, 0)
        inf_n = curve.infinity((N,))
        binit = curve.infinity((nb,))

        def scat(bz, s, infv):
            return bz.at[idx, :].set(jnp.where(is_last[:, None], s, infv))

        buckets = PointJ(
            scat(binit.x, scanned.x, inf_n.x),
            scat(binit.y, scanned.y, inf_n.y),
            scat(binit.z, scanned.z, inf_n.z),
        )
        # aggregation  sum_{k>=1} k * B_k:
        #   suffix sums S_j = sum_{k>=j} B_k  (reverse prefix scan),
        #   then G_w = sum_{j>=1} S_j          (prefix scan, last entry).
        tail = jax.tree.map(lambda a: jnp.flip(a[1:], axis=0), buckets)
        suffix = _prefix_sum_points(curve, tail)  # suffix[j] = S_{nb-1-j}
        total = _prefix_sum_points(curve, suffix)
        return jax.tree.map(lambda a: a[-1], total)

    ws = jnp.arange(n_windows, dtype=jnp.uint32)
    g_ws = jax.vmap(window)(ws)  # PointJ [W], weight 2^(c*w)

    def comb(acc, gw):
        acc = jax.lax.fori_loop(0, c, lambda _, a: curve.double(a), acc)
        return curve.add(acc, gw), None

    out, _ = jax.lax.scan(
        comb, curve.infinity(()), jax.tree.map(lambda a: jnp.flip(a, 0), g_ws)
    )
    return out


# ---------------------------------------------------------------------------
# Dense segmented-scan bucket accumulation
#
# The while-loop schedule above runs max-bucket-load iterations over a
# [W, K] lane grid, so lane utilization is mean/max bucket load — fine
# for one large MSM (~70%), catastrophic for the ragged opening chains
# (every segment idles until the LARGEST chunk's worst bucket drains;
# measured ~5% at the flagship c_open, 7.4 s of the 22 s prove).  The
# dense schedule below does EXACTLY E = sum_k N_k * W point-adds at
# ~100% lane occupancy, independent of bucket skew:
#
#   1. flatten all (window, entry) pairs into ONE globally sorted list
#      (key = segment<<c | digit, window-major — already sorted per
#      window, so the flat list is sorted);
#   2. split the list into T equal runs (lanes); a lax.scan does one
#      masked mixed-add per step over all T lanes — each lane serially
#      accumulates its run, resetting at key changes (E/T steps);
#   3. a log2(T)-step segmented scan over lane summaries produces the
#      carry for segments that span lane boundaries;
#   4. each bucket sum = scanned value at its end position (+ lane carry
#      when the bucket started before the lane) — pure gathers.
# ---------------------------------------------------------------------------
DENSE_LANES = 32768
"""Lanes of the dense accumulation scan: E/T steps of one [T]-wide
mixed add (one point kernel of T threads on the GPU).  On the H100 the
lazy reset step takes 0.087 ms at 8192 lanes (64 blocks: the card is
not full) and 0.127 ms at 32768, 2.7x less per add (PERF.md, PR 1)."""


def _dense_bucket_sums(curve: Curve, pts_flat: PointJ, keys: jnp.ndarray,
                       ends_g: jnp.ndarray, starts_g: jnp.ndarray,
                       lens: jnp.ndarray, T: int = DENSE_LANES):
    """Bucket sums from a globally key-sorted entry list.

    ``pts_flat``: PointJ [E] (affine, z in {0,1});  ``keys``: [E] uint32
    sorted ascending;  ``ends_g``/``starts_g``/``lens``: [NB] global end
    (exclusive) / start positions and lengths per bucket.  Returns
    PointJ [NB] — the sum of entries of each bucket (infinity if empty).
    """
    E = keys.shape[0]
    # adapt the lane count: the cross-lane segmented scan costs ~log2(T)
    # full adds on T lanes regardless of E — for small workloads that
    # fixed cost dominated the per-layer zerocheck opens.  Keep lanes
    # at most ~E/32 (scan depth >= 32 steps) but no fewer than 512.
    if E < 32 * T:
        T = max(512, 1 << max(E // 32, 1).bit_length() - 1)
    T = min(T, E)
    steps = -(-E // T)
    pad = steps * T - E
    sentinel = jnp.uint32(0xFFFFFFFF)
    if pad:
        keys = jnp.concatenate([keys, jnp.full((pad,), sentinel, jnp.uint32)])
        inf = curve.infinity((pad,))
        pts_flat = jax.tree.map(
            lambda a, b: jnp.concatenate([a, b], 0), pts_flat, inf
        )
    # lane t owns global entries [t*steps, (t+1)*steps): reshape to
    # [T, steps] then step-major [steps, T] for the scan
    keys_lt = keys.reshape(T, steps).T  # [steps, T]
    pts_lt = jax.tree.map(
        lambda a: a.reshape(T, steps, a.shape[-1]).swapaxes(0, 1), pts_flat
    )

    acc0 = curve.infinity((T,))
    prev0 = jnp.full((T,), sentinel, jnp.uint32)

    def body(carry, x):
        acc, prev = carry
        k, p = x
        acc2, flag = curve.add_mixed_reset_lazy(acc, PointJ(*p), k == prev)
        # x-collision doublings are ~2^-255-rare for distinct points;
        # the repair branch compiles once and essentially never runs
        acc2 = jax.lax.cond(
            jnp.any(flag),
            lambda a, o, f: curve.select(f, curve.double(a), o),
            lambda a, o, f: o,
            acc, acc2, flag,
        )
        return (acc2, k), acc2

    (_, _), scanned = jax.lax.scan(
        body, (acc0, prev0), (keys_lt, tuple(pts_lt))
    )  # scanned: PointJ [steps, T]

    # lane summaries: trailing-segment sum + whether the lane is uniform
    first_key = keys_lt[0]  # [T]
    last_key = keys_lt[-1]
    last_val = jax.tree.map(lambda a: a[-1], scanned)  # PointJ [T]
    whole = first_key == last_key

    # inclusive segmented scan over lanes (Hillis-Steele, log2(T) adds):
    # state (val = trailing-run sum, first_key, whole)
    idx = jnp.arange(T)
    val, fk, wh = PointJ(*last_val), first_key, whole

    def cross(step, state):
        # Hillis-Steele over the block monoid (val = trailing-run sum,
        # fk = block first key, wh = block is key-uniform); a block's
        # LAST key always equals its rightmost lane's own last_key, so
        # the static ``last_key`` array is correct at every distance.
        val, fk, wh = state
        sh = jnp.int32(1) << step
        val_l = jax.tree.map(lambda a: jnp.roll(a, sh, 0), val)
        fk_l = jnp.roll(fk, sh, 0)
        lk_l = jnp.roll(last_key, sh, 0)
        wh_l = jnp.roll(wh, sh, 0)
        ok = idx >= sh
        # right block's trailing run extends into the left block iff the
        # right block is uniform and the keys meet at the boundary
        join = jnp.logical_and(ok, jnp.logical_and(wh, lk_l == fk))
        val2 = curve.select(join, curve.add(val, PointJ(*val_l)), val)
        fk2 = jnp.where(join, fk_l, fk)
        wh2 = jnp.where(ok, jnp.logical_and(join, wh_l), wh)
        return val2, fk2, wh2

    steps_T = max((T - 1).bit_length(), 1)
    val, fk, wh = jax.lax.fori_loop(0, steps_T, cross, (val, fk, wh))
    run_sum = val  # [T] inclusive trailing-run sums

    # bucket extraction: value at end-1 (+ previous-lane run carry when
    # the bucket spans the lane boundary)
    e = jnp.maximum(ends_g.astype(jnp.int32) - 1, 0)
    lane = e // steps
    pos = e % steps
    gat = lambda a: a[pos, lane]
    v_end = PointJ(
        gat(scanned.x), gat(scanned.y), gat(scanned.z)
    )
    prev_lane = jnp.maximum(lane - 1, 0)
    carry = jax.tree.map(lambda a: a[prev_lane], run_sum)
    lane_first = first_key[lane]
    key_e = keys[jnp.minimum(e, E - 1)]
    need_carry = jnp.logical_and(
        jnp.logical_and(lane > 0, starts_g.astype(jnp.int32) < lane * steps),
        jnp.logical_and(
            last_key[prev_lane] == key_e, lane_first == key_e
        ),
    )
    total = curve.select(
        need_carry, curve.add(v_end, PointJ(*carry)), v_end
    )
    return curve.select(lens > 0, total, curve.infinity(lens.shape))


def _dense_enabled() -> bool:
    import os

    flag = os.environ.get("SCZK_MSM_DENSE")
    if flag is not None:
        return flag != "0"
    return True


def _msm_1d_dense(curve: Curve, points: PointJ, scalars_std: jnp.ndarray,
                  c: int, affine: bool = False) -> PointJ:
    """Windowed Pippenger with dense segmented-scan accumulation.

    With signed digits (default): digits in (-2^(c-1), 2^(c-1)] so the
    per-window bucket range is [0, 2^(c-1)] (K = 2^(c-1)+1); entries
    with negative digits accumulate the NEGATED point.  Window count
    stays ceil(nbits/c): scalars are field elements < 2^255, so the top
    window (which owns bit 255 or less) holds at most 2^(c-1) after the
    incoming carry and never carries out."""
    N = scalars_std.shape[-2]
    nbits = scalars_std.shape[-1] * LIMB_BITS
    W = (nbits + c - 1) // c
    signed = _signed_enabled()
    K = (1 << (c - 1)) + 1 if signed else (1 << c)
    aff = points if affine else curve.normalize(points)

    ws = jnp.arange(W, dtype=jnp.uint32)
    if signed:
        digits, negs, _ = _signed_digit_block(
            scalars_std, c, ws, jnp.zeros((N,), jnp.uint32)
        )  # [W, N] magnitudes + signs
    else:
        digits = jax.vmap(lambda w: _digit(scalars_std, c, w))(ws)  # [W, N]
    iota = jnp.broadcast_to(jnp.arange(N, dtype=jnp.uint32)[None], (W, N))
    sorted_d, sorted_i = jax.lax.sort_key_val(digits, iota, dimension=1)
    ks = jnp.arange(K, dtype=jnp.uint32)
    starts = jax.vmap(
        lambda sd: jnp.searchsorted(sd, ks, side="left")
    )(sorted_d).astype(jnp.int32)  # [W, K]
    ends = jax.vmap(
        lambda sd: jnp.searchsorted(sd, ks, side="right")
    )(sorted_d).astype(jnp.int32)
    lens = ends - starts
    lens = lens.at[:, 0].set(0)  # digit 0 contributes nothing

    # global flat layout: entry (w, j) -> w*N + j;  key = w*K + digit
    keys = (sorted_d + ws[:, None] * jnp.uint32(K)).reshape(-1)
    pid = sorted_i.reshape(-1).astype(jnp.int32)
    pts_flat = jax.tree.map(lambda a: jnp.take(a, pid, axis=0), aff)
    if signed:
        sflat = jnp.take_along_axis(
            negs, sorted_i.astype(jnp.int32), axis=1
        ).reshape(-1)
        pts_flat = _negate_where(curve, pts_flat, sflat)
    offs = (ws[:, None].astype(jnp.int32) * N)
    acc = _dense_bucket_sums(
        curve,
        pts_flat,
        keys,
        (ends + offs).reshape(-1),
        (starts + offs).reshape(-1),
        lens.reshape(-1),
    )  # [W*K]
    acc = jax.tree.map(lambda a: a.reshape(W, K, -1), acc)
    totals = jax.tree.map(
        lambda a: a[:, 0],
        _weighted_bucket_totals(
            curve, jax.tree.map(lambda a: a[:, None], acc)
        ),
    )  # [W]

    return _horner_windows(curve, totals, c)


MIN_MSM_SIZE = 32
"""Small MSMs are zero-padded up to this size so every tiny call shares
ONE compiled executable per batch rank.  A zero scalar contributes
nothing on either path (digit-0 segments land in the ignored 0-bucket;
double-and-add with an all-zero scalar yields infinity), so padding with
(infinity, 0) pairs is exact.  XLA compile time (~25-30 s per distinct
shape for these limb-arithmetic graphs) is the binding constraint; the
protocols call MSM on dozens of distinct small levels (c_open
q-vectors, layered zerocheck opens)."""


def msm(curve: Curve, points: PointJ, scalars_std: jnp.ndarray, c: int = 8,
        affine: bool = False) -> PointJ:
    """Batched MSM: points [..., N], scalars [..., N, L] (standard form).

    Returns PointJ [...]. Batch dims are vmapped; each instance runs the
    sort+scan Pippenger above.  On CPU the whole batched MSM is one
    native Pippenger custom call (curves/g1.py::_ffi).
    """
    ffi = curve._ffi()
    if ffi is not None:
        N = scalars_std.shape[-2]
        # batch dims align as PREFIXES (extra scalar batch dims broadcast
        # the points), matching _msm_batched's vmap nest below
        pb = points.x.shape[:-2]
        sbsh = scalars_std.shape[:-2]
        bshape = sbsh if len(sbsh) >= len(pb) else pb
        pts = jax.tree.map(
            lambda a: jnp.broadcast_to(
                a.reshape(pb + (1,) * (len(bshape) - len(pb)) + a.shape[-2:]),
                bshape + a.shape[-2:],
            ),
            points,
        )
        sb = jnp.broadcast_to(
            scalars_std.reshape(
                sbsh + (1,) * (len(bshape) - len(sbsh)) + scalars_std.shape[-2:]
            ),
            bshape + scalars_std.shape[-2:],
        )
        out_shape = bshape + (curve.fq.L,)
        ox, oy, oz = ffi.g1_op(
            0, curve._ffi_fid(ffi), pts.x, pts.y, pts.z, sb, out_shape, N, 1
        )
        return PointJ(ox, oy, oz)
    N = scalars_std.shape[-2]
    if N < MIN_MSM_SIZE:
        padn = MIN_MSM_SIZE - N
        scalars_std = jnp.concatenate(
            [
                scalars_std,
                jnp.zeros(scalars_std.shape[:-2] + (padn,) + scalars_std.shape[-1:],
                          scalars_std.dtype),
            ],
            axis=-2,
        )
        inf = curve.infinity(points.x.shape[:-2] + (padn,))
        points = jax.tree.map(
            lambda a, b: jnp.concatenate([a, b], axis=-2), points, inf
        )
        N = N + padn
    if _dense_enabled() and N > NAIVE_MAX:
        # batched MSM as equal segments of the flat dense core: the core
        # is scan-based and vmap would both serialize its lanes and turn
        # the rare-collision lax.cond into an always-executed select
        batch = scalars_std.shape[:-2]
        Bn = int(np.prod(batch, dtype=np.int64)) if batch else 1
        # the caller's c is a hint; the dense core picks the
        # cost-model-optimal width for this workload (wider windows under
        # signed digits cut the accumulate floor)
        if _auto_c_enabled():
            c = _pick_c_dense(Bn * N, Bn, scalars_std.shape[-1] * LIMB_BITS)
        pb = points.x.shape[:-2]
        pts = jax.tree.map(
            lambda a: jnp.broadcast_to(
                a.reshape(pb + (1,) * (len(batch) - len(pb)) + a.shape[-2:]),
                batch + a.shape[-2:],
            ).reshape(Bn * N, a.shape[-1]),
            points,
        )
        sc = scalars_std.reshape(Bn * N, scalars_std.shape[-1])
        res = _msm_ragged_dense(curve, pts, sc, (N,) * Bn, c, affine)
        return jax.tree.map(lambda a: a.reshape(batch + a.shape[-1:]), res)
    return _msm_batched(curve, points, scalars_std, c, affine)


@functools.partial(jax.jit, static_argnums=(0, 3, 4))
def _msm_batched(curve: Curve, points: PointJ, scalars_std: jnp.ndarray, c: int,
                 affine: bool = False) -> PointJ:
    """jit boundary ABOVE the vmap stack: `vmap(jit(f))` builds a fresh
    batched executable on every call (observed: hundreds of runtime
    recompiles); `jit(vmap(f))` caches one executable per shape."""
    batch = scalars_std.shape[:-2]
    pts_batch_rank = points.x.ndim - 2  # [batch..., N, L]
    f = lambda p, s: _msm_1d(curve, p, s, c, affine)
    # inner vmaps map both; leading extra scalar batch dims broadcast points
    for i in range(len(batch)):
        shared = len(batch) - 1 - i < pts_batch_rank
        f = jax.vmap(f, in_axes=(0 if shared else None, 0))
    return f(points, scalars_std)


def msm_naive(curve: Curve, points: PointJ, scalars_std: jnp.ndarray) -> PointJ:
    """Oracle-grade tiny MSM: per-point scalar_mul then tree sum."""
    prods = curve.scalar_mul(points, scalars_std)
    return curve.sum(prods, axis=-1)


# ---------------------------------------------------------------------------
# Ragged (segmented) MSM — many MSM instances of DIFFERENT sizes in ONE
# bucket pass.  The protocols' opening loops commit halving chains of
# q-vectors (dpoly_comm.rs:299-325, :401-464): per-level msm() calls give
# one XLA sub-graph per distinct size, which made round-1's wire-phase
# executable take ~15 min of compile.  Here every (batch-slot, level)
# pair becomes a *segment* with its own bucket range in a single flat
# [W, n_chunks * 2^c] accumulator grid, so any ragged chain is one sort +
# one bucket while-loop + one reduction — one executable for the lot.
# Big segments are split into fixed-size chunks so the while-loop trip
# count (the max bucket load) is set by the chunk size, not by the
# largest segment; chunk partials are summed at the end.
# ---------------------------------------------------------------------------
def _pick_c(max_size: int) -> int:
    """Window size by largest segment: keeps bucket-lane count (W * 2^c
    per segment) proportionate to the useful work."""
    if max_size >= 8192:
        return 8
    if max_size >= 512:
        return 6
    return 4


def _pick_c_dense(total_n: int, n_segments: int, nbits: int = 256) -> int:
    """Window size for the dense-scan cores by explicit cost model:
    accumulation does W * total_n mixed adds (the prove's ALU floor);
    the weighted bucket reduce does ~1.3*W*C*K*c lane-adds (Hillis-Steele
    rounds, _weighted_bucket_totals).

    Signed digits halve K to 2^(c-1)+1, which shifts the optimum toward
    wider windows — the point of the signed scheme: W (and with it the
    accumulate floor) drops ~20% at the flagship sizes.  Bucket-grid
    memory is capped at 2^21 points (~600 MB of Jacobian coords)."""
    signed = _signed_enabled()
    best_c, best_cost = 4, None
    for c in (2, 3, 4, 5, 6, 8, 9, 10, 11, 12, 13):
        W = -(-nbits // c)
        K = ((1 << (c - 1)) + 1) if signed else (1 << c)
        if W * n_segments * K > (1 << 21):
            continue
        red = 1.3 * W * n_segments * K * c
        cost = W * total_n + red
        if best_cost is None or cost < best_cost:
            best_c, best_cost = c, cost
    return best_c


def _chunk_plan(sizes, chunk):
    """Static chunk decomposition: (chunk_sizes, seg_of_chunk) tuples."""
    chunk_sizes, seg_of_chunk = [], []
    for s_idx, n in enumerate(sizes):
        if chunk is None or n <= chunk:
            parts = [n]
        else:
            parts = [chunk] * (n // chunk)
            if n % chunk:
                parts.append(n % chunk)
        for psz in parts:
            chunk_sizes.append(psz)
            seg_of_chunk.append(s_idx)
    return tuple(chunk_sizes), tuple(seg_of_chunk)


@functools.partial(jax.jit, static_argnums=(0, 3, 4, 5))
def _msm_ragged_core(curve: Curve, points: PointJ, scalars_std: jnp.ndarray,
                     chunk_sizes: tuple, c: int, affine: bool) -> PointJ:
    """Flat segmented bucket MSM: points/scalars [N_total(, L)] with the
    static per-chunk sizes; returns per-chunk partial results [C]."""
    N = scalars_std.shape[0]
    K = 1 << c
    C = len(chunk_sizes)
    nbits = scalars_std.shape[-1] * LIMB_BITS
    W = (nbits + c - 1) // c
    aff = points if affine else curve.normalize(points)

    chunk_id = np.repeat(
        np.arange(C, dtype=np.uint32), np.asarray(chunk_sizes, dtype=np.int64)
    )
    ws = jnp.arange(W, dtype=jnp.uint32)
    digits = jax.vmap(lambda w: _digit(scalars_std, c, w))(ws)  # [W, N]
    key = jnp.asarray(chunk_id)[None, :] * jnp.uint32(K) + digits
    iota = jnp.broadcast_to(jnp.arange(N, dtype=jnp.uint32)[None], (W, N))
    sorted_k, sorted_i = jax.lax.sort_key_val(key, iota, dimension=1)
    ks = jnp.arange(C * K, dtype=jnp.uint32)
    starts = jax.vmap(
        lambda sk: jnp.searchsorted(sk, ks, side="left")
    )(sorted_k).astype(jnp.int32)  # [W, C*K]
    ends = jax.vmap(
        lambda sk: jnp.searchsorted(sk, ks, side="right")
    )(sorted_k).astype(jnp.int32)
    lens = ends - starts
    lens = jnp.where((ks % K == 0)[None, :], 0, lens)  # digit-0 buckets idle
    maxlen = jnp.max(lens)

    acc0 = curve.infinity((W, C * K))

    def cond(state):
        t, _ = state
        return t < maxlen

    def body(state):
        t, acc = state
        pos = jnp.minimum(starts + t, N - 1)
        pid = jnp.take_along_axis(sorted_i, pos, axis=1).astype(jnp.int32)
        pt = jax.tree.map(lambda a: jnp.take(a, pid, axis=0), aff)
        return t + 1, curve.add_mixed_masked(acc, pt, t < lens)

    _, acc = jax.lax.while_loop(cond, body, (jnp.int32(0), acc0))

    # per chunk: sum_k k*B_k via the fused weighted bucket reduce
    accr = jax.tree.map(lambda a: a.reshape(W, C, K, -1), acc)
    totals = _weighted_bucket_totals(curve, accr)  # [W, C]

    return _horner_windows(curve, totals, c)


MAX_DENSE_ENTRIES = 1 << 22
"""Window-chunking threshold of the dense core: the flat (window, entry)
list materializes E = W*N gathered points (288 B each) plus sorted keys;
beyond ~4M entries (~1.2 GB) the windows are processed in chunks under a
lax.scan — required for the 2^22-gate north-star config, whose commit
MSMs reach E = 2*10^8."""


@functools.partial(jax.jit, static_argnums=(0, 3, 4, 5))
def _msm_ragged_dense(curve: Curve, points: PointJ, scalars_std: jnp.ndarray,
                      sizes: tuple, c: int, affine: bool) -> PointJ:
    """Segmented MSM with dense-scan accumulation: the scan depth is E/T
    regardless of segment-size skew (the while-loop core idles every
    small segment until the largest one's worst bucket drains — measured
    ~5% lane utilization on the flagship c_open).  Windows are processed
    in chunks of ``wc`` when E = W*N exceeds MAX_DENSE_ENTRIES (one
    compiled chunk body under lax.scan; bucket sums are per-window, so
    chunks need no cross-carries)."""
    N = scalars_std.shape[0]
    signed = _signed_enabled()
    K = (1 << (c - 1)) + 1 if signed else (1 << c)
    C = len(sizes)
    nbits = scalars_std.shape[-1] * LIMB_BITS
    W = (nbits + c - 1) // c
    aff = points if affine else curve.normalize(points)

    seg_id = np.repeat(
        np.arange(C, dtype=np.uint32), np.asarray(sizes, dtype=np.int64)
    )
    seg_key = jnp.asarray(seg_id) * jnp.uint32(K)
    iota = jnp.arange(N, dtype=jnp.uint32)
    ks = jnp.arange(C * K, dtype=jnp.uint32)

    wc = max(min(W, MAX_DENSE_ENTRIES // max(N, 1)), 1)
    n_chunks = -(-W // wc)

    def chunk(carry, wbase):
        # windows ascend across chunks, so the signed-digit carry threads
        # through the scan carry
        ws = wbase + jnp.arange(wc, dtype=jnp.uint32)
        live = (ws < W)[:, None]
        if signed:
            digs, negs, carry = _signed_digit_block(scalars_std, c, ws, carry)
            digs = jnp.where(live, digs, 0)
            negs = jnp.logical_and(negs, live)
        else:
            digs = jax.vmap(lambda w: _digit(scalars_std, c, w))(ws)  # [wc, N]
            digs = jnp.where(live, digs, 0)
        key = seg_key[None, :] + digs
        sorted_k, sorted_i = jax.lax.sort_key_val(
            key, jnp.broadcast_to(iota[None], (wc, N)), dimension=1
        )
        starts = jax.vmap(
            lambda sk: jnp.searchsorted(sk, ks, side="left")
        )(sorted_k).astype(jnp.int32)  # [wc, C*K]
        ends = jax.vmap(
            lambda sk: jnp.searchsorted(sk, ks, side="right")
        )(sorted_k).astype(jnp.int32)
        lens = ends - starts
        lens = jnp.where((ks % K == 0)[None, :], 0, lens)
        wl = jnp.arange(wc, dtype=jnp.uint32)
        keys_flat = (sorted_k + (wl * jnp.uint32(C * K))[:, None]).reshape(-1)
        pid = sorted_i.reshape(-1).astype(jnp.int32)
        pts_flat = jax.tree.map(lambda a: jnp.take(a, pid, axis=0), aff)
        if signed:
            sflat = jnp.take_along_axis(
                negs, sorted_i.astype(jnp.int32), axis=1
            ).reshape(-1)
            pts_flat = _negate_where(curve, pts_flat, sflat)
        offs = (wl.astype(jnp.int32) * N)[:, None]
        accc = _dense_bucket_sums(
            curve,
            pts_flat,
            keys_flat,
            (ends + offs).reshape(-1),
            (starts + offs).reshape(-1),
            lens.reshape(-1),
        )
        return carry, tuple(accc)  # coords [wc*C*K, L]

    carry0 = jnp.zeros((N,), jnp.uint32)
    if n_chunks == 1:
        _, acc_t = chunk(carry0, jnp.uint32(0))
        acc = PointJ(*acc_t)
    else:
        wbases = jnp.arange(n_chunks, dtype=jnp.uint32) * jnp.uint32(wc)
        _, accs = jax.lax.scan(chunk, carry0, wbases)
        acc = PointJ(
            *[
                a.reshape(n_chunks * wc * C * K, -1)[: W * C * K]
                for a in accs
            ]
        )
    acc = jax.tree.map(lambda a: a.reshape(W, C, K, -1), acc)
    totals = _weighted_bucket_totals(curve, acc)  # [W, C]

    return _horner_windows(curve, totals, c)


def msm_ragged(curve: Curve, bases_list, scalars_list, c: int | None = None,
               affine: bool = False, chunk: int | None = 4096):
    """MSM over a ragged batch in ONE bucket pass.

    ``bases_list[i]``: PointJ broadcastable to [B..., N_i]; also accepts
    per-entry batch-free bases.  ``scalars_list[i]``: [B..., N_i, L]
    standard-form scalars, all entries sharing the same leading batch
    shape.  Returns a list of PointJ [B...] — one result per entry.
    On CPU the native Pippenger FFI services each entry directly.
    """
    ffi = curve._ffi()
    if ffi is not None:
        return [
            msm(curve, b, s, c=8) for b, s in zip(bases_list, scalars_list)
        ]
    batch = scalars_list[0].shape[:-2]
    Bn = int(np.prod(batch, dtype=np.int64)) if batch else 1
    sizes = []
    pts_flat, sc_flat = [], []
    for b, s in zip(bases_list, scalars_list):
        assert s.shape[:-2] == batch, (s.shape, batch)
        n_i = s.shape[-2]
        bb = jax.tree.map(
            lambda a: jnp.broadcast_to(
                a.reshape((1,) * (len(batch) + 2 - a.ndim) + a.shape),
                batch + (n_i, a.shape[-1]),
            ),
            b,
        )
        pts_flat.append(jax.tree.map(lambda a: a.reshape(Bn * n_i, a.shape[-1]), bb))
        sc_flat.append(s.reshape(Bn * n_i, s.shape[-1]))
        sizes += [n_i] * Bn  # batch-major segments per entry
    points = jax.tree.map(lambda *xs: jnp.concatenate(xs, 0), *pts_flat)
    scal = jnp.concatenate(sc_flat, 0)
    if _dense_enabled():
        if c is None:
            c = _pick_c_dense(
                sum(sizes), len(sizes), scal.shape[-1] * LIMB_BITS
            )
        chunk_sizes = tuple(sizes)
        seg_of_chunk = tuple(range(len(sizes)))
        res = _msm_ragged_dense(curve, points, scal, chunk_sizes, c, affine)
    else:
        if c is None:
            c = _pick_c(max(sizes))
        chunk_sizes, seg_of_chunk = _chunk_plan(tuple(sizes), chunk)
        res = _msm_ragged_core(curve, points, scal, chunk_sizes, c, affine)

    # chunk -> segment partial sums (host-unrolled; chunk counts are tiny)
    seg_results = []
    by_seg: dict = {}
    for ci, sg in enumerate(seg_of_chunk):
        by_seg.setdefault(sg, []).append(ci)
    for s_idx in range(len(sizes)):
        idxs = by_seg[s_idx]
        pt = jax.tree.map(lambda a: a[idxs[0]], res)
        for ci in idxs[1:]:
            pt = curve.add(pt, jax.tree.map(lambda a, _ci=ci: a[_ci], res))
        seg_results.append(pt)

    out_list = []
    k = 0
    for s in scalars_list:
        grp = seg_results[k : k + Bn]
        k += Bn
        stacked = jax.tree.map(lambda *xs: jnp.stack(xs, 0), *grp)
        out_list.append(
            jax.tree.map(lambda a: a.reshape(batch + a.shape[1:]), stacked)
        )
    return out_list


# ---------------------------------------------------------------------------
# Distributed MSM on shares (dmsm.rs:9-43)
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _dmsm_reduce_vectors(pp: PackedSharingParams):
    """(w [1, n], q [n, 1]) int matrices of the fused leader map.

    leader(x)[j] = pack(replicate_l(sum_l(unpack2(x))))[j] = q[j] * (w·x)
    with w = column sums of the unpack2 matrix, q = pack @ ones_l.
    """
    p = pp.field.p
    U2 = pp.unpack2_matrix()  # [l, n]
    P = pp.pack_matrix()  # [n, l]
    w = np.empty((1, pp.n), dtype=object)
    for j in range(pp.n):
        w[0, j] = sum(int(U2[i, j]) for i in range(pp.l)) % p
    q = np.empty((pp.n, 1), dtype=object)
    for j in range(pp.n):
        q[j, 0] = sum(int(P[j, i]) for i in range(pp.l)) % p
    return w, q


@functools.lru_cache(maxsize=None)
def _dmsm_scale_consts(pp: PackedSharingParams):
    """Montgomery-limb constants that fold the rank-1 leader map INTO
    the MSM scalars (group-linearity rewrite; see d_msm docstring):

    * ``qw0`` [L]: q_0 * sum_j w_j mod r — the leader-mode pre-scale
      (the fake-network gather tiles the one party's partial, so
      w·x = (sum w_j)·x and out_0 = q_0·(w·x)).
    * ``w_mont`` [n, L]: per-party w_j for the sim-mode pre-scale.
    * ``q_std`` [n, L]: standard-form q_j for the sim-mode post scalar
      multiplication.
    """
    from ..fields.config import int_to_limbs

    F = pp.field
    w, q = _dmsm_reduce_vectors(pp)
    wsum = sum(int(w[0, j]) for j in range(pp.n)) % F.p
    qw0 = F.to_mont_int(int(q[0, 0]) * wsum % F.p)
    w_mont = np.stack([F.to_mont_int(int(w[0, j])) for j in range(pp.n)])
    q_std = np.stack([int_to_limbs(int(q[j, 0]), F.L) for j in range(pp.n)])
    # NUMPY results only: device arrays born inside one jit trace would
    # leak tracers into later traces through the lru_cache (cf.
    # unpack._pack_single_u_np)
    return qw0, w_mont, q_std


def _dmsm_prescale(pp: PackedSharingParams, net: PartyNet,
                   scalars_std: jnp.ndarray) -> jnp.ndarray:
    """Fold the leader map's scalar factors into standard-form scalars.

    For standard-form s, F.mul(s, to_mont(k)) = s*k*R*R^-1 = s*k mod r —
    still standard form.  Leader mode folds the whole q_0*(sum w) factor
    (output = the local MSM directly); sim mode folds per-party w_j
    (the partial sum over parties then equals w·x by MSM linearity)."""
    F = pp.field
    qw0, w_mont, _ = _dmsm_scale_consts(pp)
    if net.mode == "leader":
        return F.mul(scalars_std, jnp.asarray(qw0))
    wb = jnp.asarray(
        w_mont.reshape((pp.n,) + (1,) * (scalars_std.ndim - 2) + (F.L,))
    )
    return F.mul(scalars_std, wb)


def d_msm(
    curve: Curve,
    pp: PackedSharingParams,
    net: PartyNet,
    bases: PointJ,
    scalars_std: jnp.ndarray,
    c: int = 8,
) -> PointJ:
    """Batched distributed MSM on PSS shares.

    ``bases``: PointJ [P, B, M] (per party: B batch entries of M share
    points); ``scalars_std``: [P, B, M, L] standard-form share scalars.
    Returns PointJ [P, B] — fresh degree-(t+l) shares whose every secret
    slot equals the true MSM result (dmsm.rs:35 replicates the output
    into all l slots before re-packing).

    The rank-1 leader map q ⊗ (w·x) is folded INTO the MSM by group
    linearity: party j's scalars are pre-scaled by w_j (one elementwise
    field multiply), so summing the local partials yields w·x with no
    leader-side group arithmetic; leader mode additionally folds q_0
    into the same pre-scale (its fake gather tiles one party's partial,
    making the whole map the scalar q_0·Σw).  A 255-bit scalar
    multiplication has ~2·255 sequential group-op depth however it is
    batched; the fold replaces it with one elementwise pass over the
    scalar table.  Outputs are value-identical (possibly
    different Jacobian representatives).
    """
    scaled = _dmsm_prescale(pp, net, scalars_std)
    local = msm(curve, bases, scaled, c=c)  # [P, B]
    B = local.x.shape[-2]
    if net.mode == "leader":
        # counting only: one gather + one scatter leader round
        net._count_gather(net.payload_bytes("g1", B, vec=True))
        net._count_scatter(net.payload_bytes("g1", B, vec=True))
        return local
    g = net.gather_to_root(local, "g1", count=B, vec=True)  # [N, B]
    t = curve.sum(g, axis=0)  # [B] = w·x (w folded into the scalars)
    _, _, q_std = _dmsm_scale_consts(pp)
    tb = jax.tree.map(
        lambda a: jnp.broadcast_to(a[None], (net.n,) + a.shape), t
    )
    out = curve.scalar_mul(tb, jnp.asarray(q_std)[:, None, :])  # [N, B] = q_p*(w*x)
    return net.scatter_from_root(out, "g1", count=B, vec=True)
