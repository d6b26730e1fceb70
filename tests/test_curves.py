"""Device G1 arithmetic vs the host Python-int oracle; pairing laws."""

import jax
import numpy as np
import pytest

from scalable_collaborative_zksnark_tpu.curves import host_curve as hc
from scalable_collaborative_zksnark_tpu.curves.g1 import bls12_381_g1


@pytest.fixture(scope="module")
def pts():
    rng = np.random.RandomState(0)
    ks = [int.from_bytes(rng.bytes(31), "little") % hc.R for _ in range(4)]
    return [hc.g1_mul(hc.G1_GEN, k) for k in ks]


def test_add_double_cancel(pts):
    C = bls12_381_g1()
    P = C.from_affine_ints(pts)
    Q = C.from_affine_ints(pts[::-1])
    assert bool(jax.jit(C.is_on_curve)(P).all())
    add = jax.jit(C.add)
    assert C.to_affine_ints(add(P, Q)) == [hc.g1_add(a, b) for a, b in zip(pts, pts[::-1])]
    assert C.to_affine_ints(jax.jit(C.double)(P)) == [hc.g1_add(a, a) for a in pts]
    # equal-inputs path of add == double
    assert C.to_affine_ints(add(P, P)) == [hc.g1_add(a, a) for a in pts]
    # cancellation and infinity handling
    assert C.to_affine_ints(add(P, C.neg(P))) == [None] * 4
    inf = C.infinity((4,))
    assert C.to_affine_ints(add(inf, P)) == pts
    assert C.to_affine_ints(add(P, inf)) == pts


def test_sum_and_scalar_mul(pts):
    C = bls12_381_g1()
    P = C.from_affine_ints(pts)
    tot = jax.jit(lambda x: C.sum(x, axis=0))(P)
    th = None
    for q in pts:
        th = hc.g1_add(th, q)
    assert C.to_affine_ints(jax.tree.map(lambda a: a[None], tot)) == [th]
    sm = C.scalar_mul_int(P, [5] * 4)
    assert C.to_affine_ints(sm) == [hc.g1_mul(a, 5) for a in pts]


def test_pairing_bilinear():
    e1 = hc.pairing(hc.G1_GEN, hc.G2_GEN)
    assert e1 != hc.F12_ONE
    a, b = 1234, 777
    lhs = hc.pairing(hc.g1_mul(hc.G1_GEN, a), hc.g2_mul(hc.G2_GEN, b))
    assert lhs == hc.f12_pow(e1, a * b % hc.R)
    assert hc.pairing_product(
        [(hc.G1_GEN, hc.G2_GEN), (hc.g1_neg(hc.G1_GEN), hc.G2_GEN)]
    ) == hc.F12_ONE


def test_generators_valid():
    assert hc.g1_is_on_curve(hc.G1_GEN)
    assert hc.g2_is_on_curve(hc.G2_GEN)
    assert hc.g1_mul(hc.G1_GEN, hc.R) is None
    assert hc.g2_mul(hc.G2_GEN, hc.R) is None


def test_scalar_mul_plain_ladder_broadcasts(monkeypatch, pts):
    """The ladder the GPU runs (no native FFI): points broadcast against a
    wider scalar batch, as the c_open proof MSMs call it."""
    from scalable_collaborative_zksnark_tpu import backend
    from scalable_collaborative_zksnark_tpu.curves.g1 import Curve
    from scalable_collaborative_zksnark_tpu.fields.config import int_to_limbs
    from scalable_collaborative_zksnark_tpu.fields.fr import get_field

    monkeypatch.setattr(backend, "native_ffi", lambda: None)
    C = Curve("bls12_381_g1_plain", get_field("bls12_381_fq"), 4,
              get_field("bls12_381_fr"))
    P = jax.tree.map(lambda a: a.reshape(1, 2, -1), C.from_affine_ints(pts[:2]))
    ks = [[3, 5], [7, 0]]  # [2, 2] scalars vs [1, 2] points
    sc = jax.numpy.asarray(
        np.stack([[int_to_limbs(k, 1) for k in row] for row in ks]))
    out = C.scalar_mul(P, sc)
    assert out.x.shape == (2, 2, 24)
    got = C.to_affine_ints(out)
    want = [hc.g1_mul(pts[j], ks[i][j]) if ks[i][j] else None
            for i in range(2) for j in range(2)]
    assert got == want
