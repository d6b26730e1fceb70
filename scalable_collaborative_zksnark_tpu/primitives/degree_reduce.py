"""Degree reduction: degree-2(t+l) shares -> degree-(t+l) shares.

Parity with /root/reference/dist-primitive/src/degree_reduce.rs: the
leader gathers, runs unpack2 -> pack_from_public, and scatters.  Like the
reference (degree_reduce.rs:16) this omits the double-random-sharing
mask — a benchmarking simplification flagged there too.

Array shape: unpack2∘pack is one fixed linear map along the party
axis, evaluated as two batched small NTT passes — on a sharded mesh this
is a single all-to-all-style contraction, not a leader round-trip.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..mpc.net import PartyNet
from ..pss.pss import PackedSharingParams


def degree_reduce(pp: PackedSharingParams, net: PartyNet, share: jnp.ndarray) -> jnp.ndarray:
    """share [P, L] -> reduced share [P, L]."""
    g = net.gather_to_root(share, "fr")  # [N, L]
    out = pp.pack_from_public(pp.unpack2(g))  # [N, L]
    return net.scatter_from_root(out, "fr")


def degree_reduce_many(
    pp: PackedSharingParams, net: PartyNet, shares: jnp.ndarray
) -> jnp.ndarray:
    """shares [P, B, L] -> reduced [P, B, L] (batched, one round)."""
    B = shares.shape[-2]
    g = net.gather_to_root(shares, "fr", count=B, vec=True)  # [N, B, L]
    cols = jnp.moveaxis(g, 0, -2)  # [B, N, L]
    red = pp.pack_from_public(pp.unpack2(cols))  # [B, N, L]
    out = jnp.moveaxis(red, -2, 0)  # [N, B, L]
    return net.scatter_from_root(out, "fr", count=B, vec=True)
