"""Checks of the CUDA kernels against the plain form and an oracle.

Shared by chip_smoke.py (phase 3, at real widths), the ``gpu``-marked
tests and scripts/kernel_bench.py: seeded sample points with the
complete-formula special cases planted in the first lanes, the kernel
and plain-form runners, and the comparisons (native oracle for points,
Python ints for field ops).
"""

from __future__ import annotations

import random

import jax.numpy as jnp
import numpy as np

from .. import cuda_kernels
from ..curves.g1 import BLS12_381_G1_GEN, Curve, PointJ

N_BASE = 64
"""Distinct base points (made by the native oracle); lanes reuse them."""

ORACLE_LANES = 16
"""Lanes checked against the native oracle: the planted cases + generic."""

MASKED = ("add_masked", "add_reset", "add_reset_lazy")


def _jacobian(curve: Curve, pts, rng):
    """Affine ints (or None) -> PointJ with a random Z per point."""
    p = curve.fq.p
    xs, ys, zs = [], [], []
    for pt in pts:
        if pt is None:
            xs.append(0), ys.append(1), zs.append(0)
            continue
        z = rng.randrange(1, p)
        xs.append(pt[0] * z * z % p)
        ys.append(pt[1] * z * z * z % p)
        zs.append(z)
    F = curve.fq
    return PointJ(F.array_from_ints(xs), F.array_from_ints(ys),
                  F.array_from_ints(zs))


def sample_points(curve: Curve, m: int, seed: int = 0):
    """(p1, p2_aff, p2_jac, mask, h1, h2) for ``m`` lanes.

    ``h1``/``h2``: the host (affine-int or None) points of the first
    ORACLE_LANES lanes.  Lanes 0-3 plant a doubling pair, a cancelling
    pair, P2 = infinity and P1 = infinity."""
    from .. import native

    rng = random.Random(seed)
    base = [native.g1_mul(BLS12_381_G1_GEN, rng.randrange(1, 1 << 64))
            for _ in range(N_BASE)]
    idx1 = [rng.randrange(N_BASE) for _ in range(m)]
    idx2 = [rng.randrange(N_BASE) for _ in range(m)]
    h1 = [base[i] for i in idx1]
    h2 = [base[i] for i in idx2]
    h2[0] = h1[0]
    h2[1] = (h1[1][0], (-h1[1][1]) % native.P)
    h2[2] = None
    h1[3] = None
    mask = np.asarray([rng.random() < 0.75 for _ in range(m)])
    mask[:4] = True
    p1 = _jacobian(curve, h1, rng)
    p2_aff = curve.from_affine_ints(h2)
    p2_jac = _jacobian(curve, h2, rng)
    return p1, p2_aff, p2_jac, jnp.asarray(mask), h1[:ORACLE_LANES], h2[
        :ORACLE_LANES]


def op_args(op: str, p1, p2_aff, p2_jac, mask):
    """Operands of ``op`` as a flat tuple of arrays."""
    if op == "double":
        return tuple(p1)
    if op == "add":
        return (*p1, *p2_jac)
    if op in MASKED:
        return (*p1, *p2_aff, mask)
    return (*p1, *p2_aff)


def _split(op, args):
    p1 = PointJ(*args[:3])
    p2 = PointJ(*args[3:6]) if op != "double" else None
    mask = args[6] if op in MASKED else None
    return p1, p2, mask


def run_kernel(curve: Curve, op: str, *args, host: bool = False):
    """The fused kernel on the GPU, or (``host``) its CPU build."""
    p1, p2, mask = _split(op, args)
    coords = tuple(p1) + (tuple(p2) if p2 is not None else ())
    if host:
        return cuda_kernels.host_point_op(op, coords, mask=mask)
    return cuda_kernels.point_op(op, curve.fq.spec.name, coords, mask=mask)


def run_plain(curve: Curve, op: str, *args):
    p1, p2, mask = _split(op, args)
    out = curve.point_op_plain(op, p1, p2, mask=mask)
    if op == "add_reset_lazy":
        return tuple(out[0]) + (out[1],)
    return tuple(out)


def mismatches(op: str, got, want) -> int:
    """Lanes where the kernel's coordinates differ from the plain form's.

    ``add_reset_lazy`` leaves its flagged (doubling) lanes to the
    caller, so those lanes are not compared."""
    diff = np.zeros(np.asarray(got[0]).shape[:-1], bool)
    for g, w in zip(got[:3], want[:3]):
        diff |= np.any(np.asarray(g) != np.asarray(w), axis=-1)
    if op == "add_reset_lazy":
        diff &= ~np.asarray(got[3])
    return int(diff.sum())


def expected(op: str, a, b, m: bool):
    """The oracle's affine result for one lane."""
    from .. import native

    if op == "double":
        return native.g1_add(a, a)
    s = native.g1_add(a, b)
    if op in ("add", "add_mixed"):
        return s
    if op == "add_masked":
        return s if m else a
    return s if m else b


def check_oracle(curve: Curve, op: str, got, h1, h2, mask) -> None:
    """Raise unless the first ORACLE_LANES lanes match the native oracle."""
    k = len(h1)
    pts = PointJ(*(jnp.asarray(np.asarray(c)[:k]) for c in got[:3]))
    aff = curve.to_affine_ints(pts)
    for i in range(k):
        if op == "add_reset_lazy" and bool(np.asarray(got[3])[i]):
            continue  # doubling lane, repaired by the caller
        want = expected(op, h1[i], h2[i], bool(mask[i]))
        if aff[i] != want:
            raise AssertionError(f"{op}: lane {i} differs from the oracle")
    if op == "add_reset_lazy":
        flags = np.asarray(got[3])[:k]
        want = [bool(mask[i]) and h1[i] is not None and h1[i] == h2[i]
                for i in range(k)]
        if flags.tolist() != want:
            raise AssertionError(f"{op}: doubling flags {flags} != {want}")


def field_mismatches(got, want) -> int:
    """Elements where two [..., L] limb arrays differ."""
    return int(np.any(np.asarray(got) != np.asarray(want), axis=-1).sum())


def check_field_ints(F, op: str, a, b, got, k: int = ORACLE_LANES) -> None:
    """Raise unless the first ``k`` results match Python-int arithmetic."""
    ref = {"mul": lambda x, y: x * y, "add": lambda x, y: x + y,
           "sub": lambda x, y: x - y}[op]
    xs = F.array_to_ints(np.asarray(a)[:k])
    ys = F.array_to_ints(np.asarray(b)[:k])
    zs = F.array_to_ints(np.asarray(got)[:k])
    for i in range(k):
        if int(zs[i]) != ref(int(xs[i]), int(ys[i])) % F.p:
            raise AssertionError(f"{F.spec.name} {op}: element {i} is wrong")
