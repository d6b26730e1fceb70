"""The CUDA field and point kernels (cuda_kernels.py) on the CPU.

The kernels are CUDA, which has no interpret mode; their code
(native/gpu_kernels.h) is built for the CPU as well
(native/host_kernels.cc), so the default suite checks the kernels'
arithmetic here against Python ints, the plain jnp form and the native
oracle.  The wrapper's shapes, the kernel/plain
choice and the window combine / bucket reduce that run on the point ops
are covered here too; the compiled kernels are checked on the card by
tests/test_gpu.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from scalable_collaborative_zksnark_tpu import backend
from scalable_collaborative_zksnark_tpu import native as no
from scalable_collaborative_zksnark_tpu import cuda_kernels
from scalable_collaborative_zksnark_tpu.curves.g1 import (
    BLS12_381_G1_GEN,
    bls12_381_g1,
)
from scalable_collaborative_zksnark_tpu.utils import kernel_check


@pytest.mark.parametrize("op", cuda_kernels.OPS)
def test_point_kernel_host_build_vs_oracle(op):
    """Each kernel's formula code: bit-exact vs the plain jnp form, and
    vs the native oracle on the planted doubling, cancel and infinity
    lanes plus generic ones."""
    if not no.available():
        pytest.skip("native oracle unavailable")
    cv = bls12_381_g1()
    p1, p2a, p2j, mask, h1, h2 = kernel_check.sample_points(cv, 40, seed=2)
    args = kernel_check.op_args(op, p1, p2a, p2j, mask)
    got = kernel_check.run_kernel(cv, op, *args, host=True)
    want = kernel_check.run_plain(cv, op, *args)
    assert kernel_check.mismatches(op, got, want) == 0
    kernel_check.check_oracle(cv, op, got, h1, h2, np.asarray(mask))


@pytest.mark.parametrize("name", ["bls12_381_fr", "bls12_381_fq"])
@pytest.mark.parametrize("op", cuda_kernels.FIELD_OPS)
def test_field_kernel_host_build_vs_ints(name, op):
    """The field kernels' code (host build) vs Python ints and the plain
    limb form, including 0, 1, p-1 and a broadcast operand."""
    from scalable_collaborative_zksnark_tpu.fields.fr import get_field

    F = get_field(name)
    rng = np.random.RandomState(4)
    xs = [int.from_bytes(rng.bytes(48), "little") % F.p for _ in range(29)]
    ys = [int.from_bytes(rng.bytes(48), "little") % F.p for _ in range(29)]
    xs += [0, 1, F.p - 1]
    ys += [F.p - 1, 0, F.p - 1]
    ref = {"mul": lambda x, y: x * y % F.p, "add": lambda x, y: (x + y) % F.p,
           "sub": lambda x, y: (x - y) % F.p}[op]
    a, b = F.array_from_ints(xs), F.array_from_ints(ys)
    out = cuda_kernels.host_field_op(op, name, a, b)
    assert list(F.array_to_ints(out)) == [ref(x, y) for x, y in zip(xs, ys)]
    assert kernel_check.field_mismatches(out, F.plain(op, a, b)) == 0
    kernel_check.check_field_ints(F, op, a, b, out)
    got = F.array_to_ints(cuda_kernels.host_field_op(op, name, a, b[5]))
    assert list(got) == [ref(x, ys[5]) for x in xs]


def test_point_op_wrapper_shapes(monkeypatch):
    """point_op flattens any batch shape to [m, 24] lanes, gives double a
    second operand it never reads, passes the mask as uint32 lanes and
    restores the batch shape (the FFI call itself is faked)."""
    seen = {}

    def fake_ffi_call(target, out_types, vmap_method=None):
        def run(*flat, op):
            seen.update(target=target, op=int(op), vmap=vmap_method,
                        shapes=[a.shape for a in flat],
                        outs=[o.shape for o in out_types])
            return [flat[0] + 1, flat[1], flat[2], flat[6]]

        return run

    monkeypatch.setattr(cuda_kernels, "ensure_registered", lambda: None)
    monkeypatch.setattr(jax.ffi, "ffi_call", fake_ffi_call)
    L = 24
    x = jnp.arange(2 * 3 * L, dtype=jnp.uint32).reshape(2, 3, L)
    mask = jnp.asarray([[True, False, True], [False, True, True]])
    out = cuda_kernels.point_op("add_reset_lazy", cuda_kernels.FQ, (x,) * 6, mask=mask)
    assert seen["target"] == cuda_kernels.TARGET
    assert seen["op"] == cuda_kernels.OPS.index("add_reset_lazy")
    assert seen["vmap"] == "broadcast_all"
    assert seen["shapes"] == [(6, L)] * 6 + [(6,)]
    assert seen["outs"] == [(6, L)] * 3 + [(6,)]
    assert out[0].shape == (2, 3, L) and out[3].shape == (2, 3)
    np.testing.assert_array_equal(np.asarray(out[0]), np.asarray(x) + 1)
    np.testing.assert_array_equal(np.asarray(out[3]), np.asarray(mask))
    out = cuda_kernels.point_op("double", cuda_kernels.FQ, (x,) * 3)
    assert seen["shapes"] == [(6, L)] * 6 + [(6,)] and len(out) == 3


@pytest.mark.parametrize("platform,curve,kernel", [
    ("cpu", "bls12_381", False), ("gpu", "bls12_381", True),
    ("gpu", "bls12_377", False),
])
def test_curve_kernel_choice(monkeypatch, platform, curve, kernel):
    """Curve ops take the fused kernel exactly when the backend module
    says so (the GPU) and the kernel has the curve (BLS12-381), else the
    plain formula."""
    from scalable_collaborative_zksnark_tpu.curves import g1

    calls = []

    def fake_point_op(op, fq_name, coords, mask=None):
        calls.append((op, len(coords), mask is not None))
        out = tuple(coords[:3])
        return out + (jnp.zeros(coords[0].shape[:-1], bool),) if (
            op == "add_reset_lazy") else out

    monkeypatch.setattr(backend, "platform", lambda: platform)
    monkeypatch.setattr(cuda_kernels, "point_op", fake_point_op)
    cv = getattr(g1, f"{curve}_g1")()
    p = cv.infinity((2,))
    same = jnp.asarray([True, False])
    assert (cv._kernel("double", p) is not None) == kernel
    assert (cv._kernel("add_reset_lazy", p, p, mask=same) is not None) == kernel
    want = [("double", 3, False),
            ("add_reset_lazy", 6, True)] if kernel else []
    assert calls == want


def test_horner_kernel_and_bucket_totals_vs_oracle():
    """The window Horner combine and the weighted bucket reduce (XLA
    scan / prefix-scan forms over the point ops) vs the native oracle."""
    if not no.available():
        pytest.skip("native oracle unavailable")
    from scalable_collaborative_zksnark_tpu.primitives.msm import (
        _horner_windows,
        _weighted_bucket_totals,
    )

    cv = bls12_381_g1()
    rng = np.random.RandomState(11)
    pts_int = [no.g1_mul(BLS12_381_G1_GEN, int(rng.randint(1, 10**9))) for _ in range(6)]
    tot3 = jax.tree.map(lambda a: a.reshape(3, 2, -1), cv.from_affine_ints(pts_int))
    got = cv.to_affine_ints(_horner_windows(cv, tot3, 2))
    for b in range(2):
        want = None
        for w in range(3):
            t = no.g1_mul(pts_int[2 * w + b], 1 << (2 * w))
            want = t if want is None else no.g1_add(want, t)
        assert got[b] == want, b

    binds = [
        no.g1_mul(BLS12_381_G1_GEN, int(rng.randint(1, 10**9)))
        if rng.rand() > 0.3
        else None
        for _ in range(16)
    ]
    acc4 = jax.tree.map(lambda a: a.reshape(2, 2, 4, -1), cv.from_affine_ints(binds))
    got = cv.to_affine_ints(_weighted_bucket_totals(cv, acc4))
    i = 0
    for w in range(2):
        for c in range(2):
            want = None
            for k in range(1, 4):
                p = binds[(w * 2 + c) * 4 + k]
                if p is None:
                    continue
                t = no.g1_mul(p, k)
                want = t if want is None else no.g1_add(want, t)
            assert got[i] == want, (w, c)
            i += 1
