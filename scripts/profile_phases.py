#!/usr/bin/env python
"""Per-phase / per-primitive warm timing of the flagship prover on the GPU.

Times each phased executable of ``dhyperplonk_phased`` in isolation
(warm, block_until_ready-synced, best of --reps) plus the primitive building
blocks (MSM at protocol sizes, the ragged opening chains, the int8
sumcheck phase, the d_msm leader reduce) so optimization targets real
numbers instead of span guesses.

Usage: python scripts/profile_phases.py [--n 16] [--l 8] [--reps 5]
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=16)
    ap.add_argument("--l", type=int, default=8)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--only-prims", action="store_true",
                    help="skip the protocol phases, time primitives only")
    args = ap.parse_args()

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")
    import os

    import jax
    import jax.numpy as jnp

    from scalable_collaborative_zksnark_tpu.utils.benchlib import (
        enable_compile_cache,
    )

    enable_compile_cache()

    from scalable_collaborative_zksnark_tpu.hyperplonk import (
        packed_proving_parameters,
    )
    from scalable_collaborative_zksnark_tpu.hyperplonk import collaborative as co
    from scalable_collaborative_zksnark_tpu.hyperplonk.sharding import (
        pk_arrays,
        pk_merge,
    )
    from scalable_collaborative_zksnark_tpu.mpc.net import PartyNet

    n, l = args.n, args.l
    N = 8 * l
    net = PartyNet(N, mode="leader")
    t0 = time.time()
    pk = packed_proving_parameters(n, l, net)
    jax.block_until_ready(pk.V)
    print(f"setup: {time.time() - t0:.1f}s", file=sys.stderr)
    arrays = pk_arrays(pk)
    F = pk.pp.field
    curve = pk.curve
    gc = 1 << n
    P = net.local_parties
    c = 8

    def timeit(name, fn, *fargs):
        t0 = time.time()
        out = fn(*fargs)
        jax.block_until_ready(out)
        compile_s = time.time() - t0
        best = float("inf")
        for _ in range(args.reps):
            t0 = time.time()
            out = fn(*fargs)
            jax.block_until_ready(out)
            best = min(best, time.time() - t0)
        print(f"{name:34s} warm {best*1e3:9.1f} ms   (first {compile_s:6.1f} s)")
        return out

    # --- protocol phases (the phased executables, in protocol order) ----
    if args.only_prims:
        _prims(args, timeit, pk, net, arrays, F, curve, gc, P)
        return
    local_s_p = F.random((P, gc * 4 // net.n), 2 * 31 + 1)
    local_s = F.random((P, gc * 4 // net.n // pk.pp.l), 2 * 31 + 2)
    eq_top = F.random((net.n,), 2 * 31 + 3)
    s_shares = co._exchange_s(F, net, local_s)

    commit_j = jax.jit(lambda ar: co._commit_step(pk_merge(pk, ar), net, c))
    gate_j = jax.jit(lambda ar: co._gate_identity(pk_merge(pk, ar), net))
    wire_a_j = jax.jit(
        lambda ar, ls, ss: co._wire_part_a(n, pk_merge(pk, ar), net, ls, ss, c)
    )
    wire_b_sums_j = jax.jit(co._make_wire_b_sums(pk, net))
    wire_b_open_j = jax.jit(co._make_wire_b_open(n, pk, net, c))
    wire_c_j = jax.jit(
        lambda ar, lt, et: co._wire_part_c(pk_merge(pk, ar), net, lt, et, c)
    )

    coms = timeit("phase commit", commit_j, arrays)
    timeit("phase gate", gate_j, arrays)
    wa = timeit("phase wire_a", wire_a_j, arrays, local_s_p, s_shares)
    v1x, vx0, vx1, leader_tree = wa[3]
    timeit("phase wire_b_sums (merged)", wire_b_sums_j, arrays, v1x, vx0, vx1)
    timeit("phase wire_b_open (merged)", wire_b_open_j, arrays, v1x, vx0, vx1)
    timeit("phase wire_c", wire_c_j, arrays, leader_tree, eq_top)
    open_j = jax.jit(lambda ar, cm: co._final_opens(pk_merge(pk, ar), net, cm, c))
    timeit("phase open", open_j, arrays, coms)
    _prims(args, timeit, pk, net, arrays, F, curve, gc, P)


def _prims(args, timeit, pk, net, arrays, F, curve, gc, P):
    import jax
    import jax.numpy as jnp

    from scalable_collaborative_zksnark_tpu.hyperplonk.sharding import pk_merge

    l = args.l
    N = 8 * l
    # --- primitive pieces ------------------------------------------------
    from scalable_collaborative_zksnark_tpu.primitives.msm import (
        msm,
        msm_ragged,
    )
    from scalable_collaborative_zksnark_tpu.primitives.poly_comm import (
        c_commit,
        c_open,
    )
    from scalable_collaborative_zksnark_tpu.primitives.sumcheck import (
        c_sumcheck_product,
    )

    M = gc * 4 // l  # share table length (32768 at n=16, l=8)
    Mp = gc * 4 // N  # plain slice length (4096)
    srs_c = pk.c_commitment
    srs_d = pk.d_commitment

    # single flat MSM at the commit size
    lvl = (M).bit_length() - 1 + 3  # level log2(M*l)
    bases = srs_c.packed_powers[(M * l).bit_length() - 1]
    sc = F.decode(F.random((P, M), 999))
    msm_j = jax.jit(lambda s: msm(curve, bases, s, c=8, affine=True))
    timeit(f"msm flat {M}", msm_j, sc)

    # ragged opening chain (the c_open q-vector commitments): sizes M/2..1
    sizes = []
    sz = M // 2
    while sz >= 1:
        sizes.append(sz)
        sz //= 2
    rb = [srs_c.packed_powers[(s_ * l).bit_length() - 1] for s_ in sizes]
    rs = [F.decode(F.random((P, s_), 1000 + i)) for i, s_ in enumerate(sizes)]
    ragged_j = jax.jit(lambda ss: msm_ragged(curve, rb, list(ss), affine=True))
    timeit(f"msm ragged chain {M//2}..1", ragged_j, tuple(rs))

    # one full c_open at the witness size
    copen_j = jax.jit(
        lambda ar: c_open(
            pk_merge(pk, ar).c_commitment, pk.pp, net, pk_merge(pk, ar).V,
            pk.challenge_r1, c=8,
        )
    )
    timeit(f"c_open V ({M})", copen_j, arrays)

    # one batched c_commit (3 tables)
    ccommit_j = jax.jit(
        lambda ar: c_commit(
            pk_merge(pk, ar).c_commitment, pk.pp, net,
            [pk_merge(pk, ar).a_evals, pk_merge(pk, ar).b_evals,
             pk_merge(pk, ar).c_evals], c=8,
        )
    )
    timeit(f"c_commit 3x{M}", ccommit_j, arrays)

    # gate-identity style batched sumcheck product (6 pairs)
    fs = jnp.broadcast_to(pk.eq[:, None], (P, 6) + pk.eq.shape[1:])
    gs = jnp.broadcast_to(pk.S1[:, None], (P, 6) + pk.S1.shape[1:])
    cssum_j = jax.jit(
        lambda f_, g_: c_sumcheck_product(pk.pp, net, f_, g_, pk.challenge)
    )
    timeit(f"c_sumcheck_product 6x{pk.eq.shape[-2]}", cssum_j, fs, gs)

    # d_msm leader reduce in isolation (the rank-1 linear maps)
    from scalable_collaborative_zksnark_tpu.primitives.msm import (
        _dmsm_reduce_vectors,
    )

    w, q = _dmsm_reduce_vectors(pk.pp)
    pts = jax.tree.map(
        lambda a: jnp.broadcast_to(a[:1], (18,) + a.shape[1:]),
        curve.normalize(bases),
    )
    gt = jax.tree.map(lambda a: a.reshape(18, 1, -1), pts)
    gt = jax.tree.map(
        lambda a: jnp.broadcast_to(a[:, :1], (18, N, a.shape[-1])), gt
    )

    def reduce_fn(g):
        t = curve.linear_map(w, g)
        return curve.linear_map(q[: net.local_parties], t)

    timeit("d_msm leader reduce (B=18)", jax.jit(reduce_fn), gt)

    # the open-phase ragged shape: 3-batched chain (final_opens c_open)
    rs3 = [
        F.decode(F.random((P, 3, s_), 2000 + i)) for i, s_ in enumerate(sizes)
    ]
    ragged3_j = jax.jit(lambda ss: msm_ragged(curve, rb, list(ss), affine=True))
    timeit(f"msm ragged chain 3x({M//2}..1)", ragged3_j, tuple(rs3))

    # window-width sweep on the same ragged shape (cost-model check)
    for c_ in (5, 6, 8):
        rj = jax.jit(
            lambda ss, _c=c_: msm_ragged(curve, rb, list(ss), c=_c, affine=True)
        )
        timeit(f"msm ragged chain 3x c={c_}", rj, tuple(rs3))

    # the SORT alone at that ragged shape (suspected fixed cost)
    from scalable_collaborative_zksnark_tpu.fields.config import LIMB_BITS

    total3 = 3 * sum(sizes)
    for c_ in (6, 8):
        W_ = (F.L * LIMB_BITS + c_ - 1) // c_
        keys = jax.random.randint(
            jax.random.PRNGKey(0), (W_, total3), 0, 1 << 30, dtype=jnp.int32
        ).astype(jnp.uint32)
        iota = jnp.broadcast_to(
            jnp.arange(total3, dtype=jnp.uint32)[None], (W_, total3)
        )
        sort_j = jax.jit(
            lambda k, v: jax.lax.sort_key_val(k, v, dimension=1)
        )
        timeit(f"sort_key_val [{W_}, {total3}]", sort_j, keys, iota)

    # one dense-scan mixed-add step shape: add_reset_lazy on 8192 lanes
    from scalable_collaborative_zksnark_tpu.curves.g1 import PointJ

    T = 8192
    acc = curve.normalize(
        jax.tree.map(lambda a: jnp.broadcast_to(a[:1], (T, a.shape[-1])), bases)
    )
    p2 = curve.normalize(
        jax.tree.map(lambda a: jnp.broadcast_to(a[1:2], (T, a.shape[-1])), bases)
    )
    samemask = jnp.ones((T,), bool)

    def steps100(a, b, m):
        def body(i, st):
            x, flag = curve.add_mixed_reset_lazy(st, b, m)
            return x
        return jax.lax.fori_loop(0, 100, body, a)

    timeit("100x add_reset_lazy [8192]", jax.jit(steps100), acc, p2, samemask)


if __name__ == "__main__":
    main()
