"""Tests that need the GPU (``gpu`` marker; they skip on other backends).

Run on the card by ``python chip_smoke.py`` (phase 2) or directly with
``python -m pytest tests/test_gpu.py -m gpu``.  They cover what only
the card compiles: the CUDA field and point kernels and the sumcheck
rounds as the GPU runs them.
"""

import jax
import numpy as np
import pytest

from scalable_collaborative_zksnark_tpu import cuda_kernels
from scalable_collaborative_zksnark_tpu.curves.g1 import bls12_381_g1
from scalable_collaborative_zksnark_tpu.fields.fr import get_field
from scalable_collaborative_zksnark_tpu.utils import kernel_check

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("op", cuda_kernels.OPS)
def test_point_kernel_on_card(gpu, op):
    """Each compiled point kernel: bit-exact vs the plain jnp form over
    a padded batch (300 lanes -> 3 programs), oracle on the planted
    doubling / cancel / infinity lanes."""
    cv = bls12_381_g1()
    p1, p2a, p2j, mask, h1, h2 = kernel_check.sample_points(cv, 300, seed=5)
    args = kernel_check.op_args(op, p1, p2a, p2j, mask)
    got = kernel_check.run_kernel(cv, op, *args)
    want = jax.jit(lambda *a: kernel_check.run_plain(cv, op, *a))(*args)
    assert kernel_check.mismatches(op, got, want) == 0
    kernel_check.check_oracle(cv, op, got, h1, h2, np.asarray(mask))


@pytest.mark.parametrize("name", ["bls12_381_fr", "bls12_381_fq"])
def test_field_ops_on_card(gpu, name):
    """Field mul / add / sub as the GPU runs them (the CUDA field
    kernels, operands broadcast) vs Python ints."""
    F = get_field(name)
    rng = np.random.RandomState(3)
    xs = [int.from_bytes(rng.bytes(48), "little") % F.p for _ in range(61)]
    ys = [int.from_bytes(rng.bytes(48), "little") % F.p for _ in range(61)]
    xs += [0, 1, F.p - 1]
    ys += [F.p - 1, 0, F.p - 1]
    a, b = F.array_from_ints(xs), F.array_from_ints(ys)
    assert list(F.array_to_ints(F.mul(a, b))) == [
        x * y % F.p for x, y in zip(xs, ys)
    ]
    assert list(F.array_to_ints(F.add(a, b))) == [
        (x + y) % F.p for x, y in zip(xs, ys)
    ]
    assert list(F.array_to_ints(F.sub(a, b))) == [
        (x - y) % F.p for x, y in zip(xs, ys)
    ]
    k = F.array_from_ints([5])[0]  # broadcast scalar operand
    assert list(F.array_to_ints(F.mul(k, a))) == [5 * x % F.p for x in xs]


def test_sumcheck_rounds_on_card(gpu):
    """The sumcheck product rounds the GPU runs vs Python ints."""
    from scalable_collaborative_zksnark_tpu.primitives.sumcheck import (
        _rounds_product,
    )

    F = get_field("bls12_381_fr")
    p = F.p
    f = F.random((1, 8), 11)
    g = F.random((1, 8), 12)
    ch = F.random((3,), 13)
    msgs, ff, gf = jax.jit(
        lambda a, b, c: _rounds_product(F, a, b, c, 0, 3)
    )(f, g, ch)
    fi = [int(v) for v in F.array_to_ints(f)[0]]
    gi = [int(v) for v in F.array_to_ints(g)[0]]
    ci = [int(v) for v in F.array_to_ints(ch)]
    for r in range(3):
        h = len(fi) // 2
        lf, hf, lg, hg = fi[:h], fi[h:], gi[:h], gi[h:]
        want = [
            sum(x * y for x, y in zip(lf, lg)) % p,
            sum(x * y for x, y in zip(hf, hg)) % p,
            sum((2 * a - b) * (2 * c - d)
                for a, b, c, d in zip(hf, lf, hg, lg)) % p,
        ]
        assert [int(v) for v in F.array_to_ints(msgs[r])[0]] == want, r
        fi = [(x + ci[r] * (y - x)) % p for x, y in zip(lf, hf)]
        gi = [(x + ci[r] * (y - x)) % p for x, y in zip(lg, hg)]
    assert [int(v) for v in F.array_to_ints(ff)[0]] == fi
    assert [int(v) for v in F.array_to_ints(gf)[0]] == gi
