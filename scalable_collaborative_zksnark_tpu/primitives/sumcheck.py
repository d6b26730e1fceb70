"""Sumcheck family: local, collaborative (c_) and distributed (d_) variants.

Protocol parity with /root/reference/dist-primitive/src/dsumcheck.rs:

* ``sumcheck`` / ``sumcheck_product``  (dsumcheck.rs:6-90): monolithic
  fold over 2^n evaluations; round i emits (sum_lo, sum_hi) (resp. the
  degree-2 triple (t=0, t=1, t=2 with extrapolation 2*hi - lo)) and folds
  the table by lo + c_i * (hi - lo).
* ``c_sumcheck`` / ``c_sumcheck_product``  (dsumcheck.rs:92-285): same
  fold on PSS *shares* (linearity: sums of shares are shares of sums);
  after the local table collapses to one packed share, ``pss2ss``
  converts it to l single-secret shares (one leader round-trip) and the
  fold continues for log2(l) rounds.
* ``d_sumcheck`` / ``d_sumcheck_product``  (dsumcheck.rs:287-512):
  plain data sliced 1/N per party; parties fold locally and push their
  round messages, the leader sums them pointwise and folds the N final
  values for log2(N) more rounds.

DOCUMENTED DEVIATION: the reference's phase-2 loops index ``challenge[i]``
for i in 0..log2(l) (dsumcheck.rs:127-141), reusing the *first* challenges
instead of continuing at ``challenge[n]`` — which breaks the verifier's
round-consistency identity g_i(0)+g_i(1) = g_{i-1}(r_{i-1}).  We continue
with ``challenge[n_local:]``, which makes the collaborative transcript
verify against the same oracle as the monolithic one (see tests).

All tables are arrays ``[..., M, L]`` (element axis -2, limb axis -1) so
every round is two fused elementwise passes.  Party-batched variants put the party axis first.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

from .. import backend
from ..fields.fr import Field
from ..mpc.net import PartyNet
from ..pss.pss import PackedSharingParams
from .unpack import pss2ss


def _halves(x):
    half = x.shape[-2] // 2
    return x[..., :half, :], x[..., half:, :]


def _fold(F: Field, x, ch):
    """lo + c * (hi - lo)  — equals (1-c)*lo + c*hi exactly."""
    lo, hi = _halves(x)
    return F.add(lo, F.mul(ch, F.sub(hi, lo)))


def _rounds_single(F: Field, cur, challenges, start, count):
    """Fold ``count`` rounds; returns (messages [count, ..., 2, L], cur)."""
    if count > 0 and backend.mxu_sumcheck():
        # int8 path: per-round sums and folds as int8 matmuls (mxu.py)
        from . import mxu_sumcheck as msc

        return msc.single_phase(F, cur, challenges, start, count)
    msgs = []
    for i in range(count):
        lo, hi = _halves(cur)
        s0 = F.sum(lo, axis=-2)
        s1 = F.sum(hi, axis=-2)
        msgs.append(jnp.stack([s0, s1], axis=-2))
        cur = _fold(F, cur, challenges[start + i])
    return msgs, cur


def _rounds_product(F: Field, cur_f, cur_g, challenges, start, count):
    """Product rounds; messages are (t0, t1, t2) triples [..., 3, L]."""
    if count > 0 and backend.mxu_sumcheck():
        # int8 path: partial sums contract the eval axis as int8 matrix
        # products; folds are shared-scalar matmuls.  Handles any count /
        # any M (dot_red splits big batches).
        from . import mxu_sumcheck as msc

        return msc.product_phase(F, cur_f, cur_g, challenges, start, count)
    msgs = []
    two = F.const(2)
    for i in range(count):
        lof, hif = _halves(cur_f)
        log, hig = _halves(cur_g)
        t0 = F.sum(F.mul(lof, log), axis=-2)
        t1 = F.sum(F.mul(hif, hig), axis=-2)
        ef = F.sub(F.mul(two, hif), lof)  # 2*hi - lo (dsumcheck.rs:60)
        eg = F.sub(F.mul(two, hig), log)
        t2 = F.sum(F.mul(ef, eg), axis=-2)
        msgs.append(jnp.stack([t0, t1, t2], axis=-2))
        ch = challenges[start + i]
        cur_f = _fold(F, cur_f, ch)
        cur_g = _fold(F, cur_g, ch)
    return msgs, cur_f, cur_g


# ---------------------------------------------------------------------------
# Local (monolithic) sumcheck — the reference baseline + verifier oracle
# ---------------------------------------------------------------------------
def sumcheck(F: Field, evals: jnp.ndarray, challenges: jnp.ndarray) -> jnp.ndarray:
    """[..., 2^n, L] -> messages [..., n+1, 2, L] (last = (0, final))."""
    n = evals.shape[-2].bit_length() - 1
    msgs, cur = _rounds_single(F, evals, challenges, 0, n)
    final = jnp.stack([F.zeros(cur.shape[:-2]), cur[..., 0, :]], axis=-2)
    msgs.append(final)
    return jnp.stack(msgs, axis=-3)


def sumcheck_product(
    F: Field, evals_f: jnp.ndarray, evals_g: jnp.ndarray, challenges: jnp.ndarray
) -> jnp.ndarray:
    """[..., 2^n, L] x2 -> messages [..., n+1, 3, L] (last = (0, f*g, 0))."""
    n = evals_f.shape[-2].bit_length() - 1
    msgs, cf, cg = _rounds_product(F, evals_f, evals_g, challenges, 0, n)
    z = F.zeros(cf.shape[:-2])
    final = jnp.stack([z, F.mul(cf[..., 0, :], cg[..., 0, :]), z], axis=-2)
    msgs.append(final)
    return jnp.stack(msgs, axis=-3)


# ---------------------------------------------------------------------------
# Collaborative (PSS-share) sumcheck
# ---------------------------------------------------------------------------
def c_sumcheck(
    pp: PackedSharingParams,
    net: PartyNet,
    shares: jnp.ndarray,
    challenges: jnp.ndarray,
) -> jnp.ndarray:
    """shares [P, 2^n_loc, L] -> per-party messages [P, n_loc+log2(l)+1, 2, L]."""
    F = pp.field
    n_loc = shares.shape[-2].bit_length() - 1
    log_l = pp.l.bit_length() - 1
    msgs, cur = _rounds_single(F, shares, challenges, 0, n_loc)
    ss = pss2ss(pp, net, cur[..., 0, :])  # [P, l, L]
    msgs2, cur2 = _rounds_single(F, ss, challenges, n_loc, log_l)
    final = jnp.stack([F.zeros(cur2.shape[:-2]), cur2[..., 0, :]], axis=-2)
    return jnp.stack(msgs + msgs2 + [final], axis=-3)


def c_sumcheck_product(
    pp: PackedSharingParams,
    net: PartyNet,
    shares_f: jnp.ndarray,
    shares_g: jnp.ndarray,
    challenges: jnp.ndarray,
) -> jnp.ndarray:
    """[P, 2^n_loc, L] x2 -> per-party messages [P, n_loc+log2(l)+1, 3, L].

    Phase-1 messages are degree-2(t+l) shares (products of shares);
    transcripts are opened with ``unpack2`` across the party axis.
    """
    F = pp.field
    n_loc = shares_f.shape[-2].bit_length() - 1
    log_l = pp.l.bit_length() - 1
    msgs, cf, cg = _rounds_product(F, shares_f, shares_g, challenges, 0, n_loc)
    ssf = pss2ss(pp, net, cf[..., 0, :])
    ssg = pss2ss(pp, net, cg[..., 0, :])
    msgs2, cf2, cg2 = _rounds_product(F, ssf, ssg, challenges, n_loc, log_l)
    z = F.zeros(cf2.shape[:-2])
    final = jnp.stack([z, F.mul(cf2[..., 0, :], cg2[..., 0, :]), z], axis=-2)
    return jnp.stack(msgs + msgs2 + [final], axis=-3)


# ---------------------------------------------------------------------------
# Distributed (plain-sliced) sumcheck
# ---------------------------------------------------------------------------
def d_sumcheck(
    F: Field, net: PartyNet, parts: jnp.ndarray, challenges: jnp.ndarray
) -> jnp.ndarray:
    """parts [P, ..., 2^n_loc, L] -> leader proof [..., n_loc+log2(N), 2, L].

    Per the reference (dsumcheck.rs:319-353) the leader output has no
    trailing (0, value) entry; workers receive nothing.  Extra batch dims
    ride the same leader round (round compression, SURVEY §2.6.8).
    """
    n_loc = parts.shape[-2].bit_length() - 1
    s = net.n.bit_length() - 1
    B = int(np.prod(parts.shape[1:-2], dtype=np.int64))
    msgs, cur = _rounds_single(F, parts, challenges, 0, n_loc)
    local = jnp.stack(msgs, axis=-3)  # [P, ..., n_loc, 2, L]
    # workers push Vec<(F,F)> of n_loc+1 entries (incl. final) per slot
    gathered = net.gather_to_root(local, "fr", count=B * (n_loc + 1) * 2, vec=True)
    final = net.gather_data_only(cur[..., 0, :])  # [N, ..., L]
    summed = F.sum(gathered, axis=0)  # [..., n_loc, 2, L]
    lead_in = jnp.moveaxis(final, 0, -2)  # [..., N, L]
    lead_msgs, _ = _rounds_single(F, lead_in, challenges, n_loc, s)
    lead = (
        jnp.stack(lead_msgs, axis=-3)
        if lead_msgs
        else jnp.zeros(summed.shape[:-3] + (0, 2, F.L), jnp.uint32)
    )
    return jnp.concatenate([summed, lead], axis=-3)


def d_sumcheck_product(
    F: Field,
    net: PartyNet,
    parts_f: jnp.ndarray,
    parts_g: jnp.ndarray,
    challenges: jnp.ndarray,
) -> jnp.ndarray:
    """[P, ..., 2^n_loc, L] x2 -> leader proof [..., n_loc+log2(N), 3, L].

    Parties additionally push (last_g, last_f, 0) (dsumcheck.rs:433); the
    leader folds those N (f, g) pairs for log2(N) further product rounds.
    Extra batch dims ride the same leader round.
    """
    n_loc = parts_f.shape[-2].bit_length() - 1
    s = net.n.bit_length() - 1
    B = int(np.prod(parts_f.shape[1:-2], dtype=np.int64))
    msgs, cf, cg = _rounds_product(F, parts_f, parts_g, challenges, 0, n_loc)
    local = jnp.stack(msgs, axis=-3)  # [P, ..., n_loc, 3, L]
    gathered = net.gather_to_root(local, "fr", count=B * (n_loc + 1) * 3, vec=True)
    lf = net.gather_data_only(cf[..., 0, :])  # [N, ..., L]
    lg = net.gather_data_only(cg[..., 0, :])
    summed = F.sum(gathered, axis=0)
    lead_msgs, _, _ = _rounds_product(
        F, jnp.moveaxis(lf, 0, -2), jnp.moveaxis(lg, 0, -2), challenges, n_loc, s
    )
    lead = (
        jnp.stack(lead_msgs, axis=-3)
        if lead_msgs
        else jnp.zeros(summed.shape[:-3] + (0, 3, F.L), jnp.uint32)
    )
    return jnp.concatenate([summed, lead], axis=-3)


# ---------------------------------------------------------------------------
# Transcript verifier oracles (dsumcheck.rs:541-588 test helpers)
# ---------------------------------------------------------------------------
def check_sumcheck(F: Field, h, proof, challenges) -> bool:
    """Verify a plain transcript: proof [k, 2] of ints, h claimed sum."""
    p = F.p
    if (proof[0][0] + proof[0][1]) % p != h % p:
        return False
    for i in range(1, len(proof)):
        x = challenges[i - 1]
        target = (proof[i - 1][0] + (proof[i - 1][1] - proof[i - 1][0]) * x) % p
        if (proof[i][0] + proof[i][1]) % p != target:
            return False
    return True


def check_sumcheck_product(F: Field, h, proof, challenges) -> bool:
    """Verify a degree-2 transcript: proof [k, 3] ints (t=0,1,2 values)."""
    p = F.p
    if (proof[0][0] + proof[0][1]) % p != h % p:
        return False
    inv2 = pow(2, -1, p)
    for i in range(1, len(proof)):
        x = challenges[i - 1]
        c = proof[i - 1][0]
        a = (proof[i - 1][2] - 2 * proof[i - 1][1] + proof[i - 1][0]) * inv2 % p
        b = (-proof[i - 1][2] + 4 * proof[i - 1][1] - 3 * proof[i - 1][0]) * inv2 % p
        target = (a * x * x + b * x + c) % p
        if (proof[i][0] + proof[i][1]) % p != target:
            return False
    return True
