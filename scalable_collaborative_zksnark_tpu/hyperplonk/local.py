"""Monolithic HyperPlonk / HyperPlonk++ baseline provers.

Parity with /root/reference/hyperplonk/src/hyperplonk.rs:15-316: the same
placeholder-input structure (seeded random polynomials), the same six
gate-identity sumcheck-products, the same wire-identity grand-product +
8 commit/open pairs + 6 sumcheck-products, and the same final openings.
Like the reference, this is a *cost-faithful simulation* of the prover's
arithmetic — the protocol glue (virtual gate circuit, transcripts) is
simplified identically (hyperplonk.rs:70-72).

Array shape: one device, tables [2^k, L]; the grand product h = num/den
uses the Montgomery batch inversion (log-depth scans) instead of the
reference's per-element division (hyperplonk.rs:112).
"""

from __future__ import annotations

import dataclasses
from typing import List

import jax.numpy as jnp

from ..curves.g1 import Curve, bls12_381_g1
from ..fields.fr import Field
from ..primitives.acc_product import acc_product
from ..primitives.mle import fix_variable
from ..primitives.poly_comm import PolynomialCommitment, srs_random
from ..primitives.sumcheck import sumcheck_product
from ..utils.timer import trace as timed


@dataclasses.dataclass
class LocalInputs:
    """Placeholder prover inputs (hyperplonk.rs:18-47)."""

    n: int
    m: jnp.ndarray          # witness, 2^(n+2)
    a: jnp.ndarray          # fix_variable(m, [0,0])
    b: jnp.ndarray
    c: jnp.ndarray
    input: jnp.ndarray      # 2^n
    q1: jnp.ndarray
    q2: jnp.ndarray
    ssigma: jnp.ndarray     # 2^(n+2)
    sid: jnp.ndarray
    eq: jnp.ndarray         # 2^n
    eq_p2: jnp.ndarray      # 2^(n+2)
    challenge: jnp.ndarray      # [n, L]
    challengep2: jnp.ndarray    # [n+2, L]
    challengep2_2: jnp.ndarray  # [n+2, L]
    alpha: jnp.ndarray
    beta: jnp.ndarray


def local_inputs(F: Field, n: int, seed: int = 0) -> LocalInputs:
    gc = 1 << n
    zero, one = F.const(0), F.const(1)

    def r(shape, k):
        return F.random(shape, seed * 7907 + k)

    m = r((gc * 4,), 1)
    return LocalInputs(
        n=n,
        m=m,
        a=fix_variable(F, m, jnp.stack([zero, zero])),
        b=fix_variable(F, m, jnp.stack([zero, one])),
        c=fix_variable(F, m, jnp.stack([one, zero])),
        input=r((gc,), 2),
        q1=r((gc,), 3),
        q2=r((gc,), 4),
        ssigma=r((gc * 4,), 5),
        sid=r((gc * 4,), 6),
        eq=r((gc,), 7),
        eq_p2=r((gc * 4,), 8),
        challenge=r((n,), 9),
        challengep2=r((n + 2,), 10),
        challengep2_2=r((n + 2,), 11),
        alpha=r((), 12),
        beta=r((), 13),
    )


def _wire_polys(F: Field, w: jnp.ndarray, ins: LocalInputs, s_poly=None):
    """num/den/h of the wire identity (hyperplonk.rs:100-112 / :255-268).

    Plain HyperPlonk: num = w + α·sid + β, den = w + α·ssigma + β.
    HyperPlonk++ (s_poly given): num uses s (M'), den uses eq instead of
    the witness (hyperplonk.rs:257-267).
    """
    a_sid = F.mul(ins.alpha, ins.sid)
    a_ssig = F.mul(ins.alpha, ins.ssigma)
    if s_poly is None:
        num = F.add(F.add(w, a_sid), ins.beta)
        den = F.add(F.add(w, a_ssig), ins.beta)
    else:
        num = F.add(F.add(s_poly, a_sid), ins.beta)
        den = F.add(F.add(ins.eq_p2, a_ssig), ins.beta)
    h = F.mul(num, F.batch_inv(den))
    return num, den, h


def _wire_section(F: Field, srs: PolynomialCommitment, ins: LocalInputs,
                  num, den, h, c: int):
    """Shared tail of the wire identity: grand product, 8 commit/open
    pairs, 6 sumcheck products (hyperplonk.rs:113-141)."""
    commits: List = []
    opens: List = []
    proofs: List = []
    with timed("Acc product"):
        vx0, vx1, v1x = acc_product(F, h)
    for poly in (ins.sid, ins.ssigma, h, num, den, vx0, vx1, v1x):
        commits.append(srs.commit(poly, c=c))
        opens.append(srs.open(poly, ins.challengep2, c=c))
    # zerocheck F(x)=eq(x)*(v1x - vx0*vx1)
    proofs.append(sumcheck_product(F, ins.eq_p2, v1x, ins.challengep2))
    proofs.append(sumcheck_product(F, ins.eq_p2, vx0, ins.challengep2))
    proofs.append(sumcheck_product(F, vx0, vx1, ins.challengep2))
    # zerocheck F(x)=eq(x)*(g*v0x - f)
    proofs.append(sumcheck_product(F, ins.eq_p2, den, ins.challengep2))
    proofs.append(sumcheck_product(F, h, den, ins.challengep2))
    proofs.append(sumcheck_product(F, ins.eq_p2, num, ins.challengep2))
    return proofs, commits, opens


def _gate_section(F: Field, ins: LocalInputs):
    """Six gate-identity sumcheck products (hyperplonk.rs:67-92)."""
    ch = ins.challenge
    proofs = [sumcheck_product(F, ins.eq, ins.q1, ch)]
    sum_ab = F.add(ins.a, ins.b)
    proofs.append(sumcheck_product(F, ins.q1, sum_ab, ch))
    proofs.append(sumcheck_product(F, ins.eq, ins.q2, ch))
    proofs.append(sumcheck_product(F, ins.a, ins.b, ch))
    proofs.append(sumcheck_product(F, ins.q2, ins.a, ch))
    sum_ci = F.add(F.neg(ins.c), ins.input)
    proofs.append(sumcheck_product(F, ins.eq, sum_ci, ch))
    return proofs


def local_hyperplonk(n: int, srs: PolynomialCommitment, ins: LocalInputs = None,
                     seed: int = 0, c: int = 8):
    """The monolithic baseline prover (hyperplonk.rs:15-160).

    Returns ((gate_proofs, gate_commitments), (wire_proofs, wire_commits,
    wire_opens)) with the same element counts as the reference.
    """
    F = srs.curve.fr
    if ins is None:
        ins = local_inputs(F, n, seed)
    with timed("Local HyperPlonk"):
        with timed("Commit"):
            coms = [srs.commit(p, c=c)
                    for p in (ins.a, ins.b, ins.c, ins.input, ins.q1, ins.q2)]
        with timed("HyperPlonk Prover"):
            with timed("Gate identity"):
                gate_proofs = _gate_section(F, ins)
            with timed("Wire identity"):
                num, den, h = _wire_polys(F, ins.m, ins)
                wire_proofs, wire_commits, wire_opens = _wire_section(
                    F, srs, ins, num, den, h, c
                )
            with timed("Open"):
                gate_coms = [
                    (com, srs.open(p, ins.challenge, c=c))
                    for com, p in zip(
                        coms, (ins.a, ins.b, ins.c, ins.input, ins.q1, ins.q2)
                    )
                ]
    return (gate_proofs, gate_coms), (wire_proofs, wire_commits, wire_opens)


def local_hyperplonkpp(n: int, srs: PolynomialCommitment, ins: LocalInputs = None,
                       seed: int = 0, c: int = 8):
    """HyperPlonk++ baseline (hyperplonk.rs:162-316): adds the witness-
    permutation polynomial M'(s) — commit s, sumcheck M·s, three extra
    opens — and the wire polys use s / eq instead of the witness."""
    F = srs.curve.fr
    if ins is None:
        ins = local_inputs(F, n, seed)
    gc = 1 << n
    with timed("Local HyperPlonk++"):
        with timed("Commit"):
            coms = [srs.commit(p, c=c)
                    for p in (ins.a, ins.b, ins.c, ins.input, ins.q1, ins.q2)]
        with timed("HyperPlonk Prover"):
            with timed("Gate identity"):
                gate_proofs = _gate_section(F, ins)
            with timed("Wire identity"):
                s_poly = F.random((gc * 4,), seed * 7907 + 99)  # M' placeholder
                wire_commits = [srs.commit(s_poly, c=c)]
                wire_proofs = [sumcheck_product(F, ins.m, s_poly, ins.challengep2)]
                wire_opens = [
                    srs.open(s_poly, ins.challengep2, c=c),
                    srs.open(ins.m, ins.challengep2, c=c),
                    srs.open(ins.m, ins.challengep2_2, c=c),
                ]
                num, den, h = _wire_polys(F, ins.m, ins, s_poly=s_poly)
                p2, c2, o2 = _wire_section(F, srs, ins, num, den, h, c)
                wire_proofs += p2
                wire_commits += c2
                wire_opens += o2
            with timed("Open"):
                gate_coms = [
                    (com, srs.open(p, ins.challenge, c=c))
                    for com, p in zip(
                        coms, (ins.a, ins.b, ins.c, ins.input, ins.q1, ins.q2)
                    )
                ]
    return (gate_proofs, gate_coms), (wire_proofs, wire_commits, wire_opens)
