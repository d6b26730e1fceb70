"""Party-axis unpack helpers and pss2ss — the c_* phase-transition ops.

Parity with /root/reference/dist-primitive/src/unpack.rs:

* ``d_unpack_0``      (unpack.rs:8):  leader unpacks the gathered shares
  and broadcasts secret[0] to everyone.
* ``d_unpack``/``d_unpack2``  (unpack.rs:21-53): gather to an arbitrary
  root and unpack there.
* ``d_unpack2_many``  (unpack.rs:55): batched + transposed variant.
* ``pss2ss``          (unpack.rs:72-97): one packed share per party ->
  l single-secret shares per party (gather 1 element, leader unpacks and
  re-shares each secret with ``pack_single``, scatter l elements).

Array shape: the leader's unpack→repack is a *linear map over the
party axis*; pss2ss in particular is the rank-1 map
``out[j, k] = u[j] * v[k]`` with ``v = unpack(shares)`` and ``u`` the
single-secret packing vector — one small matrix contraction + an outer
product instead of a leader bottleneck.  Uses the reconstructible
``pack_single`` variant (see pss.py for the documented deviation).
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

from ..mpc.net import PartyNet
from ..pss.pss import PackedSharingParams


@functools.lru_cache(maxsize=None)
def _pack_single_u_np(pp: PackedSharingParams):
    """Host-side Montgomery limb table u [n, L]: shares_j = u_j * secret.

    Cached as NUMPY so each jit trace gets a fresh constant — caching a
    device array born inside one trace leaks a tracer into the next
    (observed with per-phase jits)."""
    import numpy as np

    vec = pp.pack_single_reconstructible_vector()
    F = pp.field
    return np.stack([F.to_mont_int(int(v) % F.p) for v in vec])


def _pack_single_u(pp: PackedSharingParams):
    return jnp.asarray(_pack_single_u_np(pp))


def d_unpack_0(pp: PackedSharingParams, net: PartyNet, share: jnp.ndarray) -> jnp.ndarray:
    """share [P, L] -> secret[0] broadcast to all parties [P, L]."""
    g = net.gather_to_root(share, "fr")  # [N, L]
    v0 = pp.unpack(g)[..., 0, :]  # [L]
    out = jnp.broadcast_to(v0, (net.n,) + v0.shape)
    return net.scatter_from_root(out, "fr")


def d_unpack(pp: PackedSharingParams, net: PartyNet, share: jnp.ndarray, receiver: int = 0):
    """share [P, L] -> secrets [l, L] (visible at `receiver`)."""
    g = net.gather_to_root(share, "fr", root=receiver)
    return pp.unpack(g)


def d_unpack2(pp: PackedSharingParams, net: PartyNet, share: jnp.ndarray, receiver: int = 0):
    g = net.gather_to_root(share, "fr", root=receiver)
    return pp.unpack2(g)


def d_unpack2_many(
    pp: PackedSharingParams, net: PartyNet, shares: jnp.ndarray, receiver: int = 0
):
    """shares [P, B, L] -> plain values [B * l, L] at `receiver`.

    Transposes to [B, N, L], unpack2s each slot, and flattens in slot-major
    order (matches transpose+flat_map in unpack.rs:66).
    """
    B = shares.shape[-2]
    g = net.gather_to_root(shares, "fr", count=B, vec=True, root=receiver)  # [N, B, L]
    per_slot = pp.unpack2(jnp.moveaxis(g, 0, -2))  # [B, l, L]
    return per_slot.reshape(per_slot.shape[:-3] + (B * pp.l, pp.field.L))


def pss2ss(pp: PackedSharingParams, net: PartyNet, share: jnp.ndarray,
           count: bool = True) -> jnp.ndarray:
    """share [P, ..., L] (one packed share per party per batch slot) ->
    [P, ..., l, L] regular shares.

    out[j, ..., k] = u[j] * v[..., k]: unpack across the party axis then
    an outer product with the single-secret packing vector.
    Communication: one gather of B field elements + one scatter of B*l
    field elements per party (unpack.rs:82-93); extra batch dims ride the
    same round (the protocols' round-compression axis, SURVEY §2.6.8).
    ``count=False`` moves the data without byte accounting (fused
    multi-open primitives count per logical pss2ss instead).
    """
    F = pp.field
    B = int(np.prod(share.shape[1:-1], dtype=np.int64)) if share.ndim > 2 else 1
    if count:
        g = net.gather_to_root(share, "fr", count=B, vec=B > 1)  # [N, ..., L]
    else:
        g = net.gather_data_only(share)
    cols = jnp.moveaxis(g, 0, -2)  # [..., N, L]
    v = pp.unpack(cols)  # [..., l, L]
    u = _pack_single_u(pp)  # [n, L]
    bshape = v.shape[:-2]
    out = F.mul(
        u.reshape((pp.n,) + (1,) * (len(bshape) + 1) + (F.L,)),
        v[None],
    )  # [n, ..., l, L]
    if count:
        return net.scatter_from_root(out, "fr", count=B * pp.l, vec=True)
    return net.scatter_data_only(out)
