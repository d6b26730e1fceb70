"""Prover input generation: PackedProvingParameters + local baseline inputs.

Parity with /root/reference/hyperplonk/src/dhyperplonk.rs:21-157 and the
input blocks of hyperplonk.rs:18-47.  As in the reference, every input is
a *seeded random placeholder* of the correct size ("Jump from sky",
dhyperplonk.rs:187-190): the prover's arithmetic and communication are
cost-faithful, the witness is not a real circuit.  Fields with a ``_p``
suffix are plain values sliced 1/N per party; the rest are PSS shares
sized 1/l per party (dhyperplonk.rs:20).

Shape convention: every per-party vector is an array [P, len, L]
(P = materialized parties: N in ``sim`` mode, 1 in ``leader`` mode);
challenges/scalars are [k, L] / [L] replicated across parties.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..curves.g1 import Curve, bls12_381_g1
from ..fields.fr import Field
from ..mpc.net import PartyNet
from ..primitives.mle import fix_variable
from ..primitives.poly_comm import PolynomialCommitment, srs_random
from ..pss.pss import PackedSharingParams


@dataclasses.dataclass
class PackedProvingParameters:
    """All collaborative-prover inputs (dhyperplonk.rs:21-62)."""

    n: int
    pp: PackedSharingParams
    curve: Curve
    # witness shares (sized gate_count*4/l per party)
    V: jnp.ndarray
    a_evals: jnp.ndarray
    b_evals: jnp.ndarray
    c_evals: jnp.ndarray
    # input / selectors: shares and plain slices
    I: jnp.ndarray
    S1: jnp.ndarray
    S2: jnp.ndarray
    I_p: jnp.ndarray
    S1_p: jnp.ndarray
    S2_p: jnp.ndarray
    # permutation / identity polynomials
    ssigma: jnp.ndarray
    ssigma_p: jnp.ndarray
    ssigma_a: jnp.ndarray
    ssigma_b: jnp.ndarray
    ssigma_c: jnp.ndarray
    sid: jnp.ndarray
    sid_p: jnp.ndarray
    # eq polynomials
    eq: jnp.ndarray
    eq_top_p: jnp.ndarray
    eq_r1: jnp.ndarray
    eq_r1_p: jnp.ndarray
    eq_r2: jnp.ndarray
    eq_r2_p: jnp.ndarray
    # challenges
    challenge: jnp.ndarray
    challenge_r1: jnp.ndarray
    challenge_r2: jnp.ndarray
    alpha: jnp.ndarray
    beta: jnp.ndarray
    gamma: jnp.ndarray
    # commitments (SRS)
    d_commitment: PolynomialCommitment
    c_commitment: PolynomialCommitment
    # masks for c_acc_product_and_share
    mask: jnp.ndarray
    unmask0: jnp.ndarray
    unmask1: jnp.ndarray
    unmask2: jnp.ndarray
    # dummies
    reduce_target: jnp.ndarray


def consistent_proving_parameters(
    n: int,
    l: int,
    net: PartyNet,
    srs: dict,
    curve: Optional[Curve] = None,
    seed: int = 1,
):
    """Prover inputs that are CONSISTENT shares/slices of one global
    witness (unlike the reference's independent random placeholders,
    dhyperplonk.rs:64-157) — so distributed transcripts can be unpacked
    across parties and verified against the monolithic oracle.

    Requires ``sim`` mode (all N parties materialized) and an honest
    ``srs`` = {"c": packed secret-derived SRS, "d": secret-derived SRS
    with the distributed extension}.  Returns (pk, globals_dict) where
    globals_dict holds the underlying global polynomials.
    """
    from ..primitives.mle import pack_vec

    assert net.mode == "sim"
    if curve is None:
        curve = bls12_381_g1()
    F = curve.fr
    pp = PackedSharingParams(F, l)
    N = pp.n
    gc = 1 << n

    def rg(sz, k):
        return F.random((sz,), seed * 7013 + k)

    g = {
        "V": rg(gc * 4, 1),
        "I": rg(gc, 3),
        "S1": rg(gc, 4),
        "S2": rg(gc, 5),
        "ssigma": rg(gc * 4, 9),
        "sid": rg(gc * 4, 10),
        "eq": rg(gc, 12),
        "eq_r1": rg(gc * 4, 14),
        "eq_r2": rg(gc * 4, 16),
    }
    zero, one = F.const(0), F.const(1)
    pts00 = jnp.stack([zero, zero])
    pts01 = jnp.stack([zero, one])
    pts10 = jnp.stack([one, zero])
    g["a"] = fix_variable(F, g["V"], pts00)
    g["b"] = fix_variable(F, g["V"], pts01)
    g["c"] = fix_variable(F, g["V"], pts10)

    sh = lambda x: pack_vec(pp, x)
    sl = lambda x: x.reshape(N, x.shape[-2] // N, F.L)
    P = net.local_parties
    rnd = lambda shape, k: F.random(shape, seed * 1009 + k)
    pk = PackedProvingParameters(
        n=n, pp=pp, curve=curve,
        V=sh(g["V"]),
        a_evals=sh(g["a"]), b_evals=sh(g["b"]), c_evals=sh(g["c"]),
        I=sh(g["I"]), S1=sh(g["S1"]), S2=sh(g["S2"]),
        I_p=sl(g["I"]), S1_p=sl(g["S1"]), S2_p=sl(g["S2"]),
        ssigma=sh(g["ssigma"]), ssigma_p=sl(g["ssigma"]),
        ssigma_a=sh(fix_variable(F, g["ssigma"], pts00)),
        ssigma_b=sh(fix_variable(F, g["ssigma"], pts01)),
        ssigma_c=sh(fix_variable(F, g["ssigma"], pts10)),
        sid=sh(g["sid"]), sid_p=sl(g["sid"]),
        eq=sh(g["eq"]), eq_top_p=rnd((P, N * 2), 13),
        eq_r1=sh(g["eq_r1"]), eq_r1_p=sl(g["eq_r1"]),
        eq_r2=sh(g["eq_r2"]), eq_r2_p=sl(g["eq_r2"]),
        challenge=rnd((n,), 18),
        challenge_r1=rnd((n + 2,), 19),
        challenge_r2=rnd((n + 2,), 20),
        alpha=rnd((), 21), beta=rnd((), 22), gamma=rnd((), 23),
        d_commitment=srs["d"], c_commitment=srs["c"],
        mask=rnd((P, gc * 4 // l), 24),
        unmask0=rnd((P, gc * 4 // l), 25),
        unmask1=rnd((P, gc * 4 // l), 26),
        unmask2=rnd((P, gc * 4 // l), 27),
        reduce_target=rnd((P, max(gc // l // l, 1)), 28),
    )
    return pk, g


def packed_proving_parameters(
    n: int,
    l: int,
    net: PartyNet,
    curve: Optional[Curve] = None,
    seed: int = 1,
    srs: Optional[dict] = None,
) -> PackedProvingParameters:
    """Generate all inputs (dhyperplonk.rs:64-157) for N = 8l parties.

    ``srs``: optional {"c": ..., "d": ...} override (e.g. an honest
    secret-derived SRS for verification tests instead of the random one).
    """
    if curve is None:
        curve = bls12_381_g1()
    F = curve.fr
    pp = PackedSharingParams(F, l)
    assert net.n == pp.n
    P = net.local_parties
    gc = 1 << n
    s_bits = pp.n.bit_length() - 1

    zero, one = F.const(0), F.const(1)

    def r(shape, k):
        return F.random(shape, seed * 1009 + k)

    V = r((P, gc * 4 // l), 1)
    pts00 = jnp.stack([zero, zero])
    pts01 = jnp.stack([zero, one])
    pts10 = jnp.stack([one, zero])
    a_evals = fix_variable(F, V, pts00)
    b_evals = fix_variable(F, V, pts01)
    c_evals = fix_variable(F, V, pts10)
    ssigma = r((P, gc * 4 // l), 2)

    if srs is None:
        cached = _load_srs_cache(curve, n, pp, seed)
        if cached is not None:
            srs = cached
    if srs is None:
        # c: `new_single` (random packed levels, identical across parties,
        # dpoly_comm.rs:197-219); d: `new_random` (levels capped at
        # n+2-log2(N), dpoly_comm.rs:220-233) + root levels for d_open.
        c_srs = srs_random(curve, n + 2, seed + 17, packed_parties=pp.n, max_level=-1)
        # level cap follows `new_random` (n+2 - log2 N, dpoly_comm.rs:222)
        # but never below log2 N: the leader tree-top commits at level
        # log2 N (dhyperplonk.rs:500-505), which at small n would index
        # past the reference's own SRS (it only benches n >= 16).
        d_srs = srs_random(curve, n + 2, seed + 23, n_parties=pp.n,
                           max_level=max(n + 2 - s_bits, s_bits))
        _save_srs_cache(curve, n, pp, seed, c_srs, d_srs)
    else:
        c_srs, d_srs = srs["c"], srs["d"]

    return PackedProvingParameters(
        n=n,
        pp=pp,
        curve=curve,
        V=V,
        a_evals=a_evals,
        b_evals=b_evals,
        c_evals=c_evals,
        I=r((P, gc // l), 3),
        S1=r((P, gc // l), 4),
        S2=r((P, gc // l), 5),
        I_p=r((P, gc // pp.n), 6),
        S1_p=r((P, gc // pp.n), 7),
        S2_p=r((P, gc // pp.n), 8),
        ssigma=ssigma,
        ssigma_p=r((P, gc * 4 // pp.n), 9),
        ssigma_a=fix_variable(F, ssigma, pts00),
        ssigma_b=fix_variable(F, ssigma, pts01),
        ssigma_c=fix_variable(F, ssigma, pts10),
        sid=r((P, gc * 4 // l), 10),
        sid_p=r((P, gc * 4 // pp.n), 11),
        eq=r((P, gc // l), 12),
        eq_top_p=r((P, pp.n * 2), 13),
        eq_r1=r((P, gc * 4 // l), 14),
        eq_r1_p=r((P, gc * 4 // pp.n), 15),
        eq_r2=r((P, gc * 4 // l), 16),
        eq_r2_p=r((P, gc * 4 // pp.n), 17),
        challenge=r((n,), 18),
        challenge_r1=r((n + 2,), 19),
        challenge_r2=r((n + 2,), 20),
        alpha=r((), 21),
        beta=r((), 22),
        gamma=r((), 23),
        d_commitment=d_srs,
        c_commitment=c_srs,
        mask=r((P, gc * 4 // l), 24),
        unmask0=r((P, gc * 4 // l), 25),
        unmask1=r((P, gc * 4 // l), 26),
        unmask2=r((P, gc * 4 // l), 27),
        reduce_target=r((P, max(gc // l // l, 1)), 28),
    )


# ---------------------------------------------------------------------------
# Benchmark-SRS disk cache (opt-in via SCZK_SRS_CACHE=<dir>)
#
# The random benchmark SRS (srs_random) costs minutes of device compile +
# generation per process at n = 16+ (scripts/pregen_srs.py makes it on
# the CPU instead); its only
# contract is size/cost-faithfulness (dpoly_comm.rs:115-233), so reusing
# the same seeded points across processes is exact.  Honest SRS objects
# (srs_from_secret / explicit ``srs=``) are never cached.
# ---------------------------------------------------------------------------
def _srs_cache_path(curve, n, pp, seed):
    import os
    from pathlib import Path

    d = os.environ.get("SCZK_SRS_CACHE")
    if not d:
        return None
    return (
        Path(d)
        / f"srs_v1_{curve.name}_n{n}_N{pp.n}_l{pp.l}_s{seed}.pkl"
    )


def _pc_fields_host(pc):
    import dataclasses as dc

    f = {k: v for k, v in dc.asdict(pc).items() if k != "curve"}
    return jax.tree.map(
        lambda a: np.asarray(jax.device_get(a)) if hasattr(a, "dtype") else a, f
    )


def _load_srs_cache(curve, n, pp, seed):
    import pickle

    path = _srs_cache_path(curve, n, pp, seed)
    if path is None or not path.exists():
        return None
    try:
        with open(path, "rb") as fh:
            blob = pickle.load(fh)
    except Exception:
        return None

    def rebuild(fields):
        from ..curves.g1 import PointJ
        from ..primitives.poly_comm import PolynomialCommitment

        dev = jax.tree.map(
            lambda a: (
                jnp.asarray(a)
                if isinstance(a, np.ndarray) and a.dtype != object
                else a  # object arrays = host-int party weights
            ),
            fields,
        )

        def pj(x):
            # dataclasses.asdict lowered PointJ namedtuples to tuples of
            # arrays at save time; jax.tree preserved the tuple shape
            if isinstance(x, (list, tuple)) and len(x) == 3 and all(
                hasattr(c, "dtype") for c in x
            ):
                return PointJ(*x)
            if isinstance(x, list):
                return [pj(v) for v in x]
            if isinstance(x, dict):
                return {k: pj(v) for k, v in x.items()}
            return x

        return PolynomialCommitment(
            curve=curve,
            powers_of_g=pj(dev["powers_of_g"]),
            powers_of_g2=dev["powers_of_g2"],
            party_weights=dev["party_weights"],
            root_levels=pj(dev["root_levels"]),
            packed_powers=pj(dev["packed_powers"]),
            affine=dev["affine"],
        )

    return {"c": rebuild(blob["c"]), "d": rebuild(blob["d"])}


def _save_srs_cache(curve, n, pp, seed, c_srs, d_srs):
    import pickle

    path = _srs_cache_path(curve, n, pp, seed)
    if path is None:
        return
    try:
        path.parent.mkdir(parents=True, exist_ok=True)
        blob = {"c": _pc_fields_host(c_srs), "d": _pc_fields_host(d_srs)}
        with open(path, "wb") as fh:
            pickle.dump(blob, fh, protocol=4)
    except Exception:  # cache is best-effort
        pass
