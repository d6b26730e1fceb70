"""Field-arithmetic conformance vs Python-int ground truth.

The reference's L0 is arkworks bigint arithmetic; our oracle here is
Python's arbitrary-precision integers, which independently pin down the
same mathematics (add/sub/mul/inv mod p).
"""

import jax
import numpy as np
import pytest

from scalable_collaborative_zksnark_tpu.fields.fr import get_field

FIELDS = ["bls12_381_fr", "bls12_377_fr", "bls12_381_fq"]


def rand_ints(F, n, seed):
    rng = np.random.RandomState(seed)
    return [int.from_bytes(rng.bytes(2 * F.L), "little") % F.p for _ in range(n)]


@pytest.mark.parametrize("name", FIELDS)
def test_ring_ops(name):
    F = get_field(name)
    xs = rand_ints(F, 16, 0)
    ys = rand_ints(F, 16, 1)
    a, b = F.array_from_ints(xs), F.array_from_ints(ys)
    add = F.array_to_ints(jax.jit(F.add)(a, b))
    sub = F.array_to_ints(jax.jit(F.sub)(a, b))
    mul = F.array_to_ints(jax.jit(F.mul)(a, b))
    neg = F.array_to_ints(jax.jit(F.neg)(a))
    for i in range(16):
        assert add[i] == (xs[i] + ys[i]) % F.p
        assert sub[i] == (xs[i] - ys[i]) % F.p
        assert mul[i] == (xs[i] * ys[i]) % F.p
        assert neg[i] == (-xs[i]) % F.p


@pytest.mark.parametrize("name", ["bls12_381_fr"])
def test_edge_values(name):
    F = get_field(name)
    xs = [0, 1, F.p - 1, F.p - 2, 2]
    a = F.array_from_ints(xs)
    sq = F.array_to_ints(jax.jit(F.sqr)(a))
    for i, x in enumerate(xs):
        assert sq[i] == x * x % F.p
    s = F.array_to_ints(jax.jit(F.add)(a, a))
    for i, x in enumerate(xs):
        assert s[i] == 2 * x % F.p
    z = F.array_to_ints(jax.jit(F.sub)(a, a))
    assert all(v == 0 for v in z)


@pytest.mark.parametrize("name", ["bls12_381_fr", "bls12_381_fq"])
def test_inversion(name):
    F = get_field(name)
    xs = rand_ints(F, 8, 2)
    a = F.array_from_ints(xs)
    inv = F.array_to_ints(jax.jit(F.inv)(a))
    binv = F.array_to_ints(jax.jit(F.batch_inv)(a))
    for i in range(8):
        assert inv[i] == pow(xs[i], -1, F.p)
        assert binv[i] == pow(xs[i], -1, F.p)


def test_batch_inv_zero():
    F = get_field("bls12_381_fr")
    xs = [5, 0, 7, 0]
    a = F.array_from_ints(xs)
    binv = F.array_to_ints(jax.jit(F.batch_inv)(a))
    assert binv[0] == pow(5, -1, F.p)
    assert binv[1] == 0
    assert binv[2] == pow(7, -1, F.p)
    assert binv[3] == 0


@pytest.mark.parametrize("name", ["bls12_381_fr", "bls12_381_fq"])
def test_large_batch_mul_inv(name):
    """Large arrays take the vectorized CPU paths (the IFMA 8-lane
    multiply engages at >= 16 elements; the native inv is a serial
    Montgomery batch inversion) — pin them to the int oracle, with
    edge values (0, 1, p-1, p-2) mixed into the batch."""
    F = get_field(name)
    n = 1 << 10
    xs = rand_ints(F, n, 5)
    ys = rand_ints(F, n, 6)
    xs[:4] = [0, 1, F.p - 1, F.p - 2]
    ys[:4] = [F.p - 1, 0, F.p - 1, 1]
    a, b = F.array_from_ints(xs), F.array_from_ints(ys)
    mul = F.array_to_ints(jax.jit(F.mul)(a, b))
    inv = F.array_to_ints(jax.jit(F.batch_inv)(a))
    for i in range(n):
        assert mul[i] == xs[i] * ys[i] % F.p
        assert inv[i] == (pow(xs[i], -1, F.p) if xs[i] else 0)


def test_sum_large():
    F = get_field("bls12_381_fr")
    # exercises the chunked column accumulation path (> 2^14 terms)
    n = (1 << 14) + 37
    r = F.random((n,), seed=9)
    got = int(F.array_to_ints(jax.jit(lambda x: F.sum(x, axis=0))(r)))
    vals = F.array_to_ints(r)
    assert got == sum(int(v) for v in vals) % F.p


def test_pow_const():
    F = get_field("bls12_377_fr")
    xs = rand_ints(F, 4, 3)
    a = F.array_from_ints(xs)
    e = 0x1234567890ABCDEF
    got = F.array_to_ints(jax.jit(lambda x: F.pow_const(x, e))(a))
    for i in range(4):
        assert got[i] == pow(xs[i], e, F.p)


def test_encode_decode_random():
    F = get_field("bls12_381_fr")
    r = F.random((64,), seed=4)
    ints = F.array_to_ints(r)
    back = F.array_from_ints(list(ints))
    assert np.array_equal(np.asarray(r), np.asarray(back))


def test_ffi_vs_pure_paths():
    """The native FFI kernels and the pure-JAX limb path must agree.

    The pure path is what runs on the GPU; the FFI path is what runs on
    CPU (fields/ffi.py) — divergence would mean CPU tests no longer
    validate the GPU arithmetic.
    """
    from scalable_collaborative_zksnark_tpu.fields import ffi

    if not ffi.available():
        import pytest

        pytest.skip("native FFI toolchain unavailable")
    F = get_field("bls12_381_fr")
    xs = rand_ints(F, 32, 11) + [0, 1, F.p - 1]
    ys = rand_ints(F, 32, 12) + [F.p - 1, 0, F.p - 1]
    a, b = F.array_from_ints(xs), F.array_from_ints(ys)
    got = {
        "mul": F.mul(a, b),
        "add": F.add(a, b),
        "sub": F.sub(a, b),
        "inv": F.inv(a),
    }
    pure = {
        "mul": F._mul_scan(a, b),
        "add": F._cond_sub_p(*F._carry(a + b)),
        "inv": F.pow_const(a, F.p - 2),
    }
    for k in pure:
        assert (np.asarray(got[k]) == np.asarray(pure[k])).all(), k
    subs = F.array_to_ints(got["sub"])
    for i in range(len(xs)):
        assert subs[i] == (xs[i] - ys[i]) % F.p


@pytest.mark.parametrize(
    "name,op",
    [("bls12_381_fr", "add"), ("bls12_381_fr", "sub"), ("bls12_381_fr", "mul"),
     ("bls12_381_fq", "add"), ("bls12_381_fq", "sub")],
)
def test_gpu_path_unrolled_ops_vs_ints(monkeypatch, name, op):
    """The plain arithmetic the GPU runs (limb loops unrolled at trace
    time, no native FFI) vs Python ints.  A fresh Field keeps the jit
    caches of the CPU-path instances out of it.  (The Fq multiply is
    covered by the point-kernel tests: its unrolled XLA:CPU compile
    takes minutes.)"""
    from scalable_collaborative_zksnark_tpu import backend
    from scalable_collaborative_zksnark_tpu.fields.config import FIELDS
    from scalable_collaborative_zksnark_tpu.fields.fr import Field

    monkeypatch.setattr(backend, "native_ffi", lambda: None)
    monkeypatch.setattr(backend, "unrolled_limbs", lambda: True)
    F = Field(FIELDS[name])
    assert not F._scan_form()
    xs = rand_ints(F, 29, 21) + [0, 1, F.p - 1]
    ys = rand_ints(F, 29, 22) + [F.p - 1, 0, F.p - 1]
    a, b = F.array_from_ints(xs), F.array_from_ints(ys)
    ref = {"add": lambda x, y: (x + y) % F.p,
           "sub": lambda x, y: (x - y) % F.p,
           "mul": lambda x, y: x * y % F.p}[op]
    got = F.array_to_ints(getattr(F, op)(a, b))
    assert list(got) == [ref(x, y) for x, y in zip(xs, ys)]
    if op == "mul":  # the unrolled and scan CIOS are the same schedule
        np.testing.assert_array_equal(
            np.asarray(F._mul_unrolled(a, b)), np.asarray(F._mul_scan(a, b))
        )
