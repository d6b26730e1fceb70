"""Oracle tests for the MXU (int8-matmul) field engine.

Every operation is checked bit-exactly against the Field limb oracle
(fields/fr.py) on random AND adversarial inputs (0, 1, p-1, all-max
limbs of intermediate redundancy).  The matmul forms are backend
independent — these tests run them on CPU with the same int32
semantics the GPU's int8 matrix products use.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from scalable_collaborative_zksnark_tpu.fields import mxu
from scalable_collaborative_zksnark_tpu.fields.fr import Field
from scalable_collaborative_zksnark_tpu.fields.config import FIELDS, limbs_to_int


@pytest.fixture(params=["bls12_381_fr", "bls12_381_fq"])
def F(request):
    return Field(FIELDS[request.param])


def _rand(F, shape, seed):
    return F.random(shape, seed)


def _ints(F, limbs):
    a = np.asarray(limbs)
    flat = a.reshape(-1, F.L)
    return [F.from_mont_limbs(v) for v in flat]


def test_to_red_canon_roundtrip(F):
    x = _rand(F, (7,), 11)
    red = mxu.to_red(x)
    back = mxu.canon(F.spec, F, red)
    np.testing.assert_array_equal(np.asarray(back), np.asarray(x))


def test_canon_of_redundant_value(F):
    # worst-case coefficients at several bounds
    mx = mxu.mxu_spec(F.spec)
    rng = np.random.RandomState(3)
    for bound in (256, 1 << 16, 1 << 24, (1 << 31) - 1):
        arr = rng.randint(0, bound, size=(5, mx.W)).astype(np.uint32)
        arr[0, :] = bound - 1  # all-max
        red = mxu.Red(jnp.asarray(arr), bound)
        got = mxu.canon(F.spec, F, red)
        for row, g in zip(arr, np.asarray(got).reshape(-1, F.L)):
            want = mxu.value_of(row) % F.p
            assert limbs_to_int(g) == want
            assert limbs_to_int(g) < F.p


def test_add_sub_red(F):
    a = _rand(F, (9,), 5)
    b = _rand(F, (9,), 6)
    ra, rb = mxu.to_red(a), mxu.to_red(b)
    s = mxu.canon(F.spec, F, mxu.add_red(ra, rb))
    d = mxu.canon(F.spec, F, mxu.sub_red(F.spec, ra, rb))
    np.testing.assert_array_equal(np.asarray(s), np.asarray(F.add(a, b)))
    np.testing.assert_array_equal(np.asarray(d), np.asarray(F.sub(a, b)))


def test_sub_red_redundant_inputs(F):
    mx = mxu.mxu_spec(F.spec)
    rng = np.random.RandomState(9)
    arr_a = rng.randint(0, 1 << 24, size=(4, mx.W)).astype(np.uint32)
    arr_b = rng.randint(0, 1 << 24, size=(4, mx.W)).astype(np.uint32)
    ra = mxu.Red(jnp.asarray(arr_a), 1 << 24)
    rb = mxu.Red(jnp.asarray(arr_b), 1 << 24)
    got = mxu.canon(F.spec, F, mxu.sub_red(F.spec, ra, rb))
    for xa, xb, g in zip(arr_a, arr_b, np.asarray(got).reshape(-1, F.L)):
        want = (mxu.value_of(xa) - mxu.value_of(xb)) % F.p
        assert limbs_to_int(g) == want


def test_mul_shared_matches_field_mul(F):
    x = _rand(F, (33,), 7)
    r = _rand(F, (), 8)
    red = mxu.to_red(x)
    m_r, kmax = mxu.fold_matrix(F.spec, F, r, red.bound, red.W)
    got = mxu.canon(F.spec, F, mxu.mul_shared(F.spec, red, m_r))
    want = F.mul(x, jnp.broadcast_to(r, x.shape))
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_mul_shared_redundant_input(F):
    mx = mxu.mxu_spec(F.spec)
    rng = np.random.RandomState(21)
    bound = 1 << 24
    arr = rng.randint(0, bound, size=(6, mx.W)).astype(np.uint32)
    red = mxu.Red(jnp.asarray(arr), bound)
    r = _rand(F, (), 4)
    m_r, _ = mxu.fold_matrix(F.spec, F, r, red.bound, red.W)
    got = mxu.canon(F.spec, F, mxu.mul_shared(F.spec, red, m_r))
    Rv = mxu.mxu_spec(F.spec).R
    r_hat = limbs_to_int(np.asarray(r))  # r * R mod p
    rinv = pow(Rv, F.p - 2, F.p)
    for row, g in zip(arr, np.asarray(got).reshape(-1, F.L)):
        want = mxu.value_of(row) * r_hat % F.p * rinv % F.p
        assert limbs_to_int(g) == want


def test_mul_shared_edge_values(F):
    ones = np.zeros((4, F.L), np.uint32)
    ones[0] = F.to_mont_int(0)
    ones[1] = F.to_mont_int(1)
    ones[2] = F.to_mont_int(F.p - 1)
    ones[3] = F.to_mont_int(1234567)
    x = jnp.asarray(ones)
    for rv in (0, 1, F.p - 1):
        r = jnp.asarray(F.to_mont_int(rv))
        red = mxu.to_red(x)
        m_r, _ = mxu.fold_matrix(F.spec, F, r, red.bound, red.W)
        got = mxu.canon(F.spec, F, mxu.mul_shared(F.spec, red, m_r))
        want = F.mul(x, jnp.broadcast_to(r, x.shape))
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_dot_red_matches_sum_of_products(F):
    for B in (1, 3, 128, 1000):
        f = _rand(F, (B,), 100 + B)
        g = _rand(F, (B,), 200 + B)
        got = mxu.canon(
            F.spec, F, mxu.dot_red(F.spec, mxu.to_red(f), mxu.to_red(g))
        )
        want = F.sum(F.mul(f, g), axis=-2)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_dot_red_batched(F):
    f = _rand(F, (2, 5, 64), 31)
    g = _rand(F, (2, 5, 64), 32)
    got = mxu.canon(
        F.spec, F, mxu.dot_red(F.spec, mxu.to_red(f), mxu.to_red(g))
    )
    want = F.sum(F.mul(f, g), axis=-2)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_dot_red_large_batch_split(F):
    B = mxu.MAX_CONTRACT + 130
    f = _rand(F, (B,), 41)
    g = _rand(F, (B,), 42)
    got = mxu.canon(
        F.spec, F, mxu.dot_red(F.spec, mxu.to_red(f), mxu.to_red(g))
    )
    want = F.sum(F.mul(f, g), axis=-2)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_dot_red_redundant_inputs(F):
    """dot_red on post-fold (non-canonical) tables — the in-loop case."""
    x = _rand(F, (50,), 61)
    y = _rand(F, (50,), 62)
    r = _rand(F, (), 63)
    rx, ry = mxu.to_red(x), mxu.to_red(y)
    m_r, _ = mxu.fold_matrix(F.spec, F, r, rx.bound, rx.W)
    fx = mxu.mul_shared(F.spec, rx, m_r)  # redundant, bound ~2^22
    fy = mxu.mul_shared(F.spec, ry, m_r)
    got = mxu.canon(F.spec, F, mxu.dot_red(F.spec, fx, fy))
    xf = F.mul(x, jnp.broadcast_to(r, x.shape))
    yf = F.mul(y, jnp.broadcast_to(r, y.shape))
    want = F.sum(F.mul(xf, yf), axis=-2)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_product_phase_matches_rounds_product():
    """MXU full product fold == the canonical _rounds_product loop."""
    from scalable_collaborative_zksnark_tpu.primitives import (
        mxu_sumcheck,
        sumcheck as sc,
    )

    F = Field(FIELDS["bls12_381_fr"])
    M, R = 256, 8
    f = F.random((M,), 71)
    g = F.random((M,), 72)
    chs = F.random((R,), 73)
    want_msgs, want_f, want_g = sc._rounds_product(F, f, g, chs, 0, R)
    got_msgs, got_f, got_g = mxu_sumcheck.product_phase(F, f, g, chs, 0)
    assert len(got_msgs) == len(want_msgs)
    for a, b in zip(got_msgs, want_msgs):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(np.asarray(got_f), np.asarray(want_f))
    np.testing.assert_array_equal(np.asarray(got_g), np.asarray(want_g))


def test_product_phase_batched():
    from scalable_collaborative_zksnark_tpu.primitives import (
        mxu_sumcheck,
        sumcheck as sc,
    )

    F = Field(FIELDS["bls12_381_fr"])
    B, M, R = 3, 64, 6
    f = F.random((B, M), 81)
    g = F.random((B, M), 82)
    chs = F.random((R,), 83)
    want_msgs, want_f, want_g = sc._rounds_product(F, f, g, chs, 0, R)
    got_msgs, got_f, got_g = mxu_sumcheck.product_phase(F, f, g, chs, 0)
    for a, b in zip(got_msgs, want_msgs):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(np.asarray(got_f), np.asarray(want_f))
    np.testing.assert_array_equal(np.asarray(got_g), np.asarray(want_g))


def test_single_phase_matches_rounds_single():
    from scalable_collaborative_zksnark_tpu.primitives import (
        mxu_sumcheck,
        sumcheck as sc,
    )

    F = Field(FIELDS["bls12_381_fr"])
    M, R = 128, 7
    f = F.random((M,), 91)
    chs = F.random((R,), 93)
    want_msgs, want_cur = sc._rounds_single(F, f, chs, 0, R)
    got_msgs, got_cur = mxu_sumcheck.single_phase(F, f, chs, 0)
    for a, b in zip(got_msgs, want_msgs):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(np.asarray(got_cur), np.asarray(want_cur))
