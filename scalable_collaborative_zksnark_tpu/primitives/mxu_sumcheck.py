"""Sumcheck fold phases on the int8 matmul field engine (fields/mxu.py).

Drop-in alternatives to the limb round loops of primitives/sumcheck.py
with identical canonical outputs (chosen by backend.mxu_sumcheck):

* every round's three partial sums t0/t1/t2 contract the evaluation
  axis as int8 matrix products (one each);
* both table folds  lo + c*(hi - lo)  are shared-scalar Montgomery
  multiplies — one int8 matmul against the per-challenge matrix M_c;
* adds/subs stay in the redundant byte representation between rounds,
  so NO per-element canonicalization happens inside the phase.

Reference hot loop: dist-primitive/src/dsumcheck.rs:167-220 (product)
and :super:`36-58` (single).  Output layout matches
``sumcheck._rounds_product`` / ``_rounds_single`` exactly.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..fields import mxu
from ..fields.mxu import Red, add_red, canon, dot_red, mul_shared, sub_red, sum_red


def _halves(r: Red):
    half = r.arr.shape[-2] // 2
    return (
        Red(r.arr[..., :half, :], r.bound),
        Red(r.arr[..., half:, :], r.bound),
    )


def _fold_matrix(F, ch, bound, W):
    m_r, _ = mxu.fold_matrix(F.spec, F, ch, bound, W)
    return m_r


def product_phase(F, evals_f: jnp.ndarray, evals_g: jnp.ndarray,
                  challenges: jnp.ndarray, start: int, count: int | None = None):
    """[..., M, L] tables -> (msgs list of R [..., 3, L], cur_f, cur_g).

    Canonically identical to ``sumcheck._rounds_product`` over the same
    challenges (R = count or log2(M) rounds); the returned tables are
    the folded remainders [..., M/2^R, L] in canonical form."""
    spec = F.spec
    M = evals_f.shape[-2]
    R = M.bit_length() - 1 if count is None else count
    cur_f = mxu.to_red(evals_f)
    cur_g = mxu.to_red(evals_g)
    raw = []  # per-round (t0, t1, t2) in redundant form
    for r in range(R):
        lof, hif = _halves(cur_f)
        log_, hig = _halves(cur_g)
        t0 = dot_red(spec, lof, log_)
        t1 = dot_red(spec, hif, hig)
        df = sub_red(spec, hif, lof)
        dg = sub_red(spec, hig, log_)
        ef = add_red(hif, df)  # 2*hi - lo  (dsumcheck.rs:60)
        eg = add_red(hig, dg)
        t2 = dot_red(spec, ef, eg)
        raw.append((t0, t1, t2))
        ch = challenges[start + r]
        m_c = _fold_matrix(F, ch, df.bound, df.W)
        cur_f = add_red(lof, mul_shared(spec, df, m_c))
        cur_g = add_red(log_, mul_shared(spec, dg, m_c))
    msgs = _canon_rows(F, raw) if R else []
    return msgs, canon(spec, F, cur_f), canon(spec, F, cur_g)


def _canon_rows(F, raw):
    """Canonicalize ALL round messages with ONE canon call.

    canon unrolls ~2.5k HLO ops (ripple chains); calling it per message
    per round multiplies a phase's compile time.  Stacking
    the (same-width) redundant messages first costs one canon total."""
    spec = F.spec
    k = len(raw[0])
    flat = [t for tup in raw for t in tup]
    W = max(t.W for t in flat)
    bound = max(t.bound for t in flat)
    arr = jnp.stack([mxu._pad_w(t.arr, W) for t in flat], axis=0)
    limbs = canon(spec, F, Red(arr, bound))  # [R*k, ..., L]
    return [
        jnp.stack([limbs[i * k + j] for j in range(k)], axis=-2)
        for i in range(len(raw))
    ]


def single_phase(F, evals: jnp.ndarray, challenges: jnp.ndarray,
                 start: int, count: int | None = None):
    """[..., M, L] -> (msgs list of R [..., 2, L], cur [..., M/2^R, L]).

    Canonically identical to ``sumcheck._rounds_single``."""
    spec = F.spec
    M = evals.shape[-2]
    R = M.bit_length() - 1 if count is None else count
    cur = mxu.to_red(evals)
    raw = []
    for r in range(R):
        lo, hi = _halves(cur)
        raw.append((sum_red(spec, lo), sum_red(spec, hi)))
        ch = challenges[start + r]
        d = sub_red(spec, hi, lo)
        m_c = _fold_matrix(F, ch, d.bound, d.W)
        cur = add_red(lo, mul_shared(spec, d, m_c))
    msgs = _canon_rows(F, raw) if R else []
    fin = canon(spec, F, cur)
    return msgs, fin
