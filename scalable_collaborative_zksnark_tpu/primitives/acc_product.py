"""Product-accumulation tree (permcheck grand product): local, c_ and d_.

Parity with /root/reference/dist-primitive/src/dacc_product.rs:

* ``acc_product``  (dacc_product.rs:30-57): given 2^n evaluations x,
  build the level-order product tree ``result = [x | level1 | ... |
  root | 0]`` (node M+j multiplies children 2j, 2j+1 — sub_index,
  dacc_product.rs:18-23) and return the three stride views
  (v(x,0) = result[0::2], v(x,1) = result[1::2], v(1,x) = result[M:]).
* ``d_acc_product``  (dacc_product.rs:365-414): plain data sliced 1/N;
  each party builds a local subtree, pushes only its root; the leader
  stacks the N roots and products them upward (leader tree, length 2N).
* ``c_acc_product``  (dacc_product.rs:296-363): same but parties push
  their top N subtree elements so the leader tree bottom can later be
  re-shared without further communication; leader tree length N^2.
* ``c_acc_product_and_share``  (dacc_product.rs:66-292): the full
  collaborative pipeline — mask, all-to-all unpack2 redistribution,
  local subtrees + leader tree, re-share every tree level (rotating-root
  exchange + leader scatter), unmask, and a 2/N-sampled degree reduction
  (whose output the reference discards — cost model only,
  dacc_product.rs:279-287).

Array shape: a tree level is one fused elementwise multiply of the
even/odd stride halves of the level below — log2(M) elementwise passes over
halving tables.  The reference's per-element loop (dacc_product.rs:309)
becomes ``mul(cur[0::2], cur[1::2])``.  The rotating-root all-to-all is
an axis transpose of the share tensor; the "merge" interleave
(dacc_product.rs:416-428) is a static reshape per level.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import jax.numpy as jnp

from ..fields.fr import Field
from ..mpc.net import PartyNet
from ..pss.pss import PackedSharingParams
from .degree_reduce import degree_reduce_many


def sub_index(i: int) -> Tuple[int, int]:
    """Children of tree node i = (1,x): (x,0) and (x,1) (dacc_product.rs:18)."""
    first_one = i.bit_length() - 1
    x = (i & ~(1 << first_one)) << 1
    return x, x + 1


def _tree_levels(F: Field, x: jnp.ndarray) -> List[jnp.ndarray]:
    """Pairwise-product levels above the input layer (root included)."""
    levels = []
    cur = x
    while cur.shape[-2] > 1:
        cur = F.mul(cur[..., 0::2, :], cur[..., 1::2, :])
        levels.append(cur)
    return levels


def _tree_array(F: Field, x: jnp.ndarray) -> jnp.ndarray:
    """[..., M, L] -> level-order [..., 2M, L] with the last slot zeroed."""
    levels = _tree_levels(F, x)
    zero = F.zeros(x.shape[:-2] + (1,))
    return jnp.concatenate([x] + levels + [zero], axis=-2)


def acc_product(F: Field, x: jnp.ndarray):
    """[..., M, L] -> (v(x,0), v(x,1), v(1,x)) each [..., M, L]."""
    result = _tree_array(F, x)
    M = x.shape[-2]
    return result[..., 0::2, :], result[..., 1::2, :], result[..., M:, :]


def d_acc_product(F: Field, net: PartyNet, parts: jnp.ndarray):
    """parts [P, M_loc, L] -> (subtree [P, 2*M_loc, L], leader_tree [2N, L]).

    Each party ships one element (its subtree root, dacc_product.rs:387);
    the leader's tree is [roots(N) | pairwise levels | root-of-roots | 0].
    """
    subtree = _tree_array(F, parts)
    root = subtree[..., -2, :]  # [P, L]
    g = net.gather_to_root(root, "fr")  # [N, L]
    leader_tree = _tree_array(F, g)  # [2N, L]
    return subtree, leader_tree


def c_acc_product(pp: PackedSharingParams, net: PartyNet, inputs: jnp.ndarray):
    """inputs [P, M, L] (plain masked values) ->
    (subtree [P, 2M, L], leader_tree [N*N, L]).

    Parties push their top N subtree elements (dacc_product.rs:321-329);
    the leader interleaves them level-by-level, party-major, into the
    leader-tree bottom (dacc_product.rs:338-349), then products the N
    roots upward (:353-357).
    """
    F = pp.field
    N = net.n
    subtree = _tree_array(F, inputs)
    assert subtree.shape[-2] >= N
    top = subtree[..., -N:, :]  # [P, N, L]
    g = net.gather_to_root(top, "fr", count=N, vec=True)  # [N, N, L]

    # bottom: for layer_len = N/2, N/4, ..., 1: concat over parties
    parts = []
    start, ll = 0, N // 2
    while ll > 0:
        parts.append(g[:, start : start + ll, :].reshape(N * ll, F.L))
        start += ll
        ll >>= 1
    bottom = jnp.concatenate(parts, axis=0)  # [N*(N-1), L]
    roots = g[:, N - 2, :]  # each party's subtree root
    upper = _tree_array(F, roots)[N:, :]  # [N, L]: levels above + zero slot
    leader_tree = jnp.concatenate([bottom, upper], axis=0)  # [N*N, L]
    return subtree, leader_tree


def _pack_stream(pp: PackedSharingParams, vals: jnp.ndarray) -> jnp.ndarray:
    """[..., K*l, L] plain values -> [..., n, K, L] per-party share streams
    (chunks of l packed then transposed, dacc_product.rs:118-148)."""
    F = pp.field
    K = vals.shape[-2] // pp.l
    chunks = vals.reshape(vals.shape[:-2] + (K, pp.l, F.L))
    shares = pp.pack_from_public(chunks)  # [..., K, n, L]
    return jnp.moveaxis(shares, -2, -3)  # [..., n, K, L]


def _merge(r: jnp.ndarray, l: int) -> jnp.ndarray:
    """The reference's ``merge`` (dacc_product.rs:416-428) on share streams.

    r: [dest, src, K, L] received streams; reassemble global level order:
    for level chunks of size next_pow2(K+1)/2 halving, concat src-major.
    Tail chunks that no longer fit are dropped (covered by leader tree).
    """
    K = r.shape[-2]
    if K == 0:
        return r.reshape(r.shape[:-3] + (0, r.shape[-1]))
    out = []
    num = 1 << ((K + 1).bit_length() - 1)  # next_pow2(K+1) >> 1
    start = 0
    while start + num <= K:
        sl = r[..., start : start + num, :]  # [dest, src, num, L]
        out.append(sl.reshape(sl.shape[:-3] + (-1, sl.shape[-1])))
        start += num
        num >>= 1
    return jnp.concatenate(out, axis=-2)


def c_acc_product_and_share(
    pp: PackedSharingParams,
    net: PartyNet,
    shares: jnp.ndarray,
    masks: jnp.ndarray,
    unmask0: jnp.ndarray,
    unmask1: jnp.ndarray,
    unmask2: jnp.ndarray,
    run_reduce: bool = True,
):
    """shares/masks [P, S, L] -> (share0, share1, share2) [P, K_out, L].

    Full pipeline of dacc_product.rs:66-292.  ``unmask*`` are per-party
    share vectors sized like the outputs.  Like the reference, the final
    degree reduction runs on a 2/N sample of each output purely for cost
    accounting and its result is discarded (dacc_product.rs:279-287).
    """
    F = pp.field
    N = net.n
    S = shares.shape[-2]
    assert S > N, "not enough shares per party"
    B = S // N

    # mask, then all-to-all redistribute: block i of every party -> party i,
    # unpacked to plain values (N concurrent d_unpack2_many, rs:94-104)
    masked = F.mul(shares, masks)
    P = masked.shape[0]
    blocks = masked.reshape(P, N, B, F.L)
    if net.mode == "leader":
        # fake-network path: the materialized party unpacks N self-copies
        # of its own block (serializing_net.rs:158-164 semantics)
        for i in range(N):
            net._count_gather(net.payload_bytes("fr", B, vec=True), root=i)
        g = jnp.broadcast_to(blocks[0, 0][:, None, :], (B, N, F.L))
        per_slot = pp.unpack2(g)  # [B, l, L]
        masked_x = per_slot.reshape(1, B * pp.l, F.L)
    else:
        for i in range(N):
            net._count_gather(net.payload_bytes("fr", B, vec=True), root=i)
        byroot = jnp.moveaxis(blocks, 1, 0)  # [root, src, B, L]
        per_slot = pp.unpack2(jnp.moveaxis(byroot, 1, -2))  # [root, B, l, L]
        masked_x = per_slot.reshape(N, B * pp.l, F.L)

    # local subtrees + leader tree
    subtree, leader_tree = c_acc_product(pp, net, masked_x)
    M = masked_x.shape[-2]

    # share the subtree minus its top N elements (rs:113-149)
    sts = subtree[..., : 2 * M - N, :]
    v0 = sts[..., 0::2, :]
    v1 = sts[..., 1::2, :]
    v2 = sts[..., M : 2 * M - N, :]
    p0 = _pack_stream(pp, v0)  # [P, n_dest, K0, L]
    p1 = _pack_stream(pp, v1)
    p2 = _pack_stream(pp, v2)
    K0, K2 = p0.shape[-2], p2.shape[-2]
    # rotating-root exchange (rs:155-203): transpose src<->dest
    net.all_to_all_rotating_root("fr", count_per_root=K0, vec=True)
    net.all_to_all_rotating_root("fr", count_per_root=K0, vec=True)
    net.all_to_all_rotating_root("fr", count_per_root=K2, vec=True)
    if net.mode == "leader":
        # non-comm placeholder: own shares stand in for received ones
        r0, r1, r2 = p0[:1], p1[:1], p2[:1]  # [1, n(src), K, L]
    else:
        r0 = jnp.moveaxis(p0, 1, 0)  # [dest, src, K0, L]
        r1 = jnp.moveaxis(p1, 1, 0)
        r2 = jnp.moveaxis(p2, 1, 0)
    share0 = _merge(r0, pp.l)
    share1 = _merge(r1, pp.l)
    share2 = _merge(r2, pp.l)

    # leader shares the leader tree (rs:213-263)
    lt0 = _pack_stream(pp, leader_tree[0::2, :])  # [n, Kl, L]
    lt1 = _pack_stream(pp, leader_tree[1::2, :])
    lt2 = _pack_stream(pp, leader_tree[N * N // 2 :, :])
    Kl = lt0.shape[-2]
    out0 = net.scatter_from_root(lt0, "fr", count=Kl, vec=True)
    out1 = net.scatter_from_root(lt1, "fr", count=Kl, vec=True)
    out2 = net.scatter_from_root(lt2, "fr", count=Kl, vec=True)
    share0 = jnp.concatenate([share0, out0], axis=-2)
    share1 = jnp.concatenate([share1, out1], axis=-2)
    share2 = jnp.concatenate([share2, out2], axis=-2)

    # unmask (rs:266-276)
    share0 = F.mul(share0, unmask0[..., : share0.shape[-2], :])
    share1 = F.mul(share1, unmask1[..., : share1.shape[-2], :])
    share2 = F.mul(share2, unmask2[..., : share2.shape[-2], :])

    # 2/N-sampled degree reduction, result discarded (rs:279-287)
    if run_reduce:
        k = share0.shape[-2] // pp.n * 2
        if k:
            degree_reduce_many(pp, net, share0[..., :k, :])
            degree_reduce_many(pp, net, share1[..., :k, :])
            degree_reduce_many(pp, net, share2[..., :k, :])
    return share0, share1, share2
