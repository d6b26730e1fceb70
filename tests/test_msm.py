"""MSM conformance vs the host oracle (dmsm.rs tests).

- msm vs naive ground truth incl. zero/one scalars (G1::msm oracle,
  dmsm.rs:109);
- d_msm on packed shares: unpack of the output shares equals the true
  MSM in every secret slot (dmsm.rs pack_unpack2_test semantics + the
  leader repack of dmsm.rs:29-40).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from scalable_collaborative_zksnark_tpu.curves import host_curve as hc
from scalable_collaborative_zksnark_tpu.curves.g1 import bls12_381_g1
from scalable_collaborative_zksnark_tpu.fields.config import int_to_limbs
from scalable_collaborative_zksnark_tpu.fields.fr import get_field
from scalable_collaborative_zksnark_tpu.mpc.net import PartyNet
from scalable_collaborative_zksnark_tpu.primitives.msm import d_msm, msm
from scalable_collaborative_zksnark_tpu.pss.pss import PackedSharingParams

C = bls12_381_g1()
Fr = get_field("bls12_381_fr")


def host_msm(pts, scalars):
    acc = None
    for q, s in zip(pts, scalars):
        acc = hc.g1_add(acc, hc.g1_mul(q, s))
    return acc


@pytest.mark.parametrize("c", [4, 8])
def test_msm_matches_oracle(c):
    rng = np.random.RandomState(1)
    n = 16
    ks = [int.from_bytes(rng.bytes(31), "little") % hc.R for _ in range(n)]
    ss = [int.from_bytes(rng.bytes(33), "little") % hc.R for _ in range(n)]
    ss[0], ss[1] = 0, 1  # edge scalars
    pts = [hc.g1_mul(hc.G1_GEN, k) for k in ks]
    P = C.from_affine_ints(pts)
    sarr = jnp.asarray(np.stack([int_to_limbs(s, Fr.L) for s in ss]))
    r = jax.jit(lambda p, s: msm(C, p, s, c=c))(P, sarr)
    got = C.to_affine_ints(jax.tree.map(lambda a: a[None], r))[0]
    assert got == host_msm(pts, ss)


def test_msm_identical_points():
    """All-identical input points (what the leader-mode fake network
    produces when a gathered row is one value broadcast N ways): every
    pair in the tree-reduce is a DOUBLING, exercising the batched
    doubling sweep of the native kernel; also mixes P with -P pairs
    (bucket cancellation) via scalars d and p-d."""
    n = 160
    base_k = 0xDEADBEEF12345
    pt = hc.g1_mul(hc.G1_GEN, base_k)
    pts = [pt] * n
    rng = np.random.RandomState(7)
    ss = [int.from_bytes(rng.bytes(31), "little") % hc.R for _ in range(n)]
    # a few negated duplicates so signed digits produce +P and -P in
    # the same bucket
    ss[10] = hc.R - ss[11]
    ss[12] = hc.R - ss[12]
    P = C.from_affine_ints(pts)
    sarr = jnp.asarray(np.stack([int_to_limbs(s, Fr.L) for s in ss]))
    r = jax.jit(lambda p, s: msm(C, p, s, c=8))(P, sarr)
    got = C.to_affine_ints(jax.tree.map(lambda a: a[None], r))[0]
    assert got == hc.g1_mul(pt, sum(ss) % hc.R)


def test_d_msm_on_shares():
    l, M = 2, 8
    pp = PackedSharingParams(Fr, l)
    net = PartyNet(8 * l)
    rng = np.random.RandomState(3)
    ks = [int.from_bytes(rng.bytes(31), "little") % hc.R for _ in range(M)]
    fs = [int.from_bytes(rng.bytes(31), "little") % hc.R for _ in range(M)]
    pts = [hc.g1_mul(hc.G1_GEN, k) for k in ks]
    expect = host_msm(pts, fs)

    P = C.from_affine_ints(pts)
    Pc = jax.tree.map(lambda a: a.reshape(M // l, l, -1), P)
    Psh = pp.pack_from_public_group(C, Pc)  # [M/l, n]
    fsh = pp.pack_from_public(Fr.array_from_ints(fs).reshape(M // l, l, Fr.L))
    bases = jax.tree.map(lambda a: jnp.moveaxis(a, -2, 0)[:, None], Psh)  # [n,1,M/l]
    scal_std = Fr.decode(jnp.moveaxis(fsh, -2, 0)[:, None])
    res = d_msm(C, pp, net, bases, scal_std, c=4)  # [n, 1]
    secrets = pp.unpack_group(C, jax.tree.map(lambda a: jnp.moveaxis(a[:, 0], 0, -2), res))
    assert C.to_affine_ints(secrets) == [expect] * l
    # one leader round: gather + scatter
    assert net.rounds == 2


def test_bucket_serial_msm_vs_oracle():
    """The bucket-serial Pippenger (pure-JAX path) must match the
    native oracle, including zero scalars, infinity inputs, duplicate
    points (bucket is_dbl path), and both window sizes."""
    from scalable_collaborative_zksnark_tpu.primitives.msm import _msm_1d_buckets
    from scalable_collaborative_zksnark_tpu import native as no

    if not no.available():
        pytest.skip("native oracle unavailable")
    cv = bls12_381_g1()
    F = cv.fr
    N = 280
    ks = [(5 * i * i + 11) % F.p for i in range(1, N + 1)]
    host_pts = [no.g1_mul(hc.G1_GEN, k) for k in ks]
    host_pts[3] = None  # infinity input
    host_pts[9] = host_pts[10]  # duplicate
    pts = cv.from_affine_ints(host_pts)
    si = [(13 * i * i * i + 7) % F.p for i in range(N)]
    si[5] = 0
    scal = jnp.asarray(
        np.stack(
            [
                np.array([(s >> (16 * j)) & 0xFFFF for j in range(F.L)], np.uint32)
                for s in si
            ]
        )
    )
    want = no.g1_msm(
        [p for p in host_pts if p is not None],
        [s for p, s in zip(host_pts, si) if p is not None],
    )
    for c in (8, 4):
        r = _msm_1d_buckets(cv, pts, scal, c)
        got = cv.to_affine_ints(jax.tree.map(lambda a: a[None], r))[0]
        assert got == want, c


def test_msm_ragged_vs_oracle():
    """msm_ragged's segmented bucket core (a pure-JAX path — CPU normally
    short-circuits to the FFI) must match the host oracle across ragged
    sizes, batch dims, broadcast bases, and chunk splitting."""
    from unittest import mock

    from scalable_collaborative_zksnark_tpu.primitives.msm import msm_ragged

    cv = bls12_381_g1()
    F = cv.fr
    rng = np.random.RandomState(7)
    sizes = [5, 17, 3]
    B = 2

    def rand_pts(n):
        ks = [int.from_bytes(rng.bytes(31), "little") % hc.R for _ in range(n)]
        return [hc.g1_mul(hc.G1_GEN, k) for k in ks]

    def rand_scal(n):
        return [int.from_bytes(rng.bytes(31), "little") % hc.R for _ in range(n)]

    host_bases = [rand_pts(n) for n in sizes]
    host_scals = [[rand_scal(n) for _ in range(B)] for n in sizes]
    host_scals[0][0][2] = 0  # edge scalar

    bases = []
    for ent, (n, hb) in enumerate(zip(sizes, host_bases)):
        P = cv.from_affine_ints(hb)
        if ent == 1:  # exercise the batch-free broadcast path
            bases.append(P)
        else:
            bases.append(jax.tree.map(lambda a: jnp.broadcast_to(a[None], (B,) + a.shape), P))
    scal = [
        jnp.asarray(
            np.stack(
                [
                    np.stack([np.array(int_to_limbs(s, F.L), np.uint32) for s in row])
                    for row in hs
                ]
            )
        )
        for hs in host_scals
    ]

    with mock.patch.object(type(cv), "_ffi", lambda self: None):
        outs = msm_ragged(cv, bases, scal, chunk=8)  # chunk < 17 forces split
    for ent in range(len(sizes)):
        got = cv.to_affine_ints(outs[ent])
        for b in range(B):
            want = host_msm(host_bases[ent], host_scals[ent][b])
            assert got[b] == want, (ent, b)


def test_dense_msm_vs_oracle():
    """The dense segmented-scan Pippenger must match the native oracle,
    including zero scalars, infinity inputs, duplicates, and a worst-case
    bucket-skew scalar set (all equal -> one bucket per window)."""
    from scalable_collaborative_zksnark_tpu.primitives.msm import _msm_1d_dense
    from scalable_collaborative_zksnark_tpu import native as no

    if not no.available():
        pytest.skip("native oracle unavailable")
    cv = bls12_381_g1()
    F = cv.fr
    N = 280
    ks = [(5 * i * i + 11) % F.p for i in range(1, N + 1)]
    host_pts = [no.g1_mul(hc.G1_GEN, k) for k in ks]
    host_pts[3] = None
    host_pts[9] = host_pts[10]
    pts = cv.from_affine_ints(host_pts)
    si = [(13 * i * i * i + 7) % F.p for i in range(N)]
    si[5] = 0
    skew = si[:]  # every scalar identical: max bucket load == N
    skew[2:] = [si[1]] * (N - 2)
    for scalars in (si, skew):
        scal = jnp.asarray(
            np.stack(
                [
                    np.array(
                        [(s >> (16 * j)) & 0xFFFF for j in range(F.L)], np.uint32
                    )
                    for s in scalars
                ]
            )
        )
        want = no.g1_msm(
            [p for p in host_pts if p is not None],
            [s for p, s in zip(host_pts, scalars) if p is not None],
        )
        for c in (8, 4):
            r = jax.jit(
                lambda p, s, _c=c: _msm_1d_dense(cv, p, s, _c)
            )(pts, scal)
            got = cv.to_affine_ints(jax.tree.map(lambda a: a[None], r))[0]
            assert got == want, (c, scalars is skew)


def test_msm_ragged_chunked_core_vs_oracle(monkeypatch):
    """The while-loop chunked core stays as a cross-check oracle; force
    it via SCZK_MSM_DENSE=0 and re-run the ragged conformance case."""
    monkeypatch.setenv("SCZK_MSM_DENSE", "0")
    test_msm_ragged_vs_oracle()


def test_msm_batched_dense_vs_oracle():
    """Batched msm() on the dense path (batch dims lowered to equal
    segments of the flat core, not vmap)."""
    from unittest import mock

    cv = bls12_381_g1()
    F = cv.fr
    rng = np.random.RandomState(11)
    B, N = 3, 40
    ks = [int.from_bytes(rng.bytes(31), "little") % hc.R for _ in range(N)]
    host_pts = [hc.g1_mul(hc.G1_GEN, k) for k in ks]
    P = cv.from_affine_ints(host_pts)
    Pb = jax.tree.map(lambda a: jnp.broadcast_to(a[None], (B,) + a.shape), P)
    ss = [[int.from_bytes(rng.bytes(31), "little") % hc.R for _ in range(N)]
          for _ in range(B)]
    scal = jnp.asarray(
        np.stack([np.stack([int_to_limbs(s, F.L) for s in row]) for row in ss])
    )
    with mock.patch.object(type(cv), "_ffi", lambda self: None):
        # N=40 > MIN_MSM_SIZE(32) but <= NAIVE_MAX: force the dense
        # branch by lowering NAIVE_MAX for the call
        import scalable_collaborative_zksnark_tpu.primitives.msm as msm_mod

        with mock.patch.object(msm_mod, "NAIVE_MAX", 16):
            out = msm(cv, Pb, scal, c=4)
    got = cv.to_affine_ints(out)
    for b in range(B):
        assert got[b] == host_msm(host_pts, ss[b]), b


def test_chunked_dense_msm_vs_oracle(monkeypatch):
    """Window-chunked dense core (MAX_DENSE_ENTRIES exceeded — the
    north-star n=22 regime where E = W*N cannot materialize at once)."""
    from scalable_collaborative_zksnark_tpu.primitives import msm as M

    rng = np.random.RandomState(9)
    N = 40
    ks = [int(int.from_bytes(rng.bytes(20), "little")) for _ in range(N)]
    fs = [int.from_bytes(rng.bytes(31), "little") % Fr.p for _ in range(N)]
    pts_int = [hc.g1_mul(hc.G1_GEN, k) for k in ks]
    pts = C.normalize(C.from_affine_ints(pts_int))
    from scalable_collaborative_zksnark_tpu.fields.config import int_to_limbs

    sc = jnp.asarray(np.stack([int_to_limbs(f, Fr.L) for f in fs]))
    want = [host_msm(pts_int[:25], fs[:25]), host_msm(pts_int[25:], fs[25:])]
    monkeypatch.setattr(M, "MAX_DENSE_ENTRIES", 128)  # wc=3 -> 22 chunks
    out = M._msm_ragged_dense(C, pts, sc, (25, 15), 4, True)
    assert C.to_affine_ints(out) == want
