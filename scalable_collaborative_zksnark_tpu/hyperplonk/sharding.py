"""Multi-chip sharding of the collaborative prover state.

The device-mesh replacement of the reference's process-per-party model
(mpc-net TCP mesh): the MPC party dimension is a *mesh axis*.  Every
share table is an array [N, ...] sharded ``P("party")`` over a
``jax.sharding.Mesh``; all cross-party movement in the protocol is a
pure array op over that axis (unpack matrices, gathers, transposes), so
XLA lowers it to collectives — no leader bottleneck, no sockets.

Helpers here split a ``PackedProvingParameters`` into a pytree of device
arrays (so the protocol can be jitted end-to-end with explicit
``in_shardings``) and compute the party/replicated sharding for each
leaf.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .params import PackedProvingParameters

# dataclass fields that are jax arrays (everything except the metadata
# and the SRS objects)
_NON_ARRAY_FIELDS = {"n", "pp", "curve", "d_commitment", "c_commitment"}


def pk_arrays(pk: PackedProvingParameters) -> Dict[str, Any]:
    """All device state of the prover inputs as one pytree dict."""
    out: Dict[str, Any] = {}
    for f in dataclasses.fields(PackedProvingParameters):
        if f.name not in _NON_ARRAY_FIELDS:
            out[f.name] = getattr(pk, f.name)
    out["_c_packed"] = pk.c_commitment.packed_powers
    out["_d_powers"] = pk.d_commitment.powers_of_g
    out["_d_root"] = pk.d_commitment.root_levels
    return out


def pk_merge(pk: PackedProvingParameters, arrays: Dict[str, Any]) -> PackedProvingParameters:
    """Rebuild a pk whose array leaves come from ``arrays``."""
    c_srs = dataclasses.replace(pk.c_commitment, packed_powers=arrays["_c_packed"])
    d_srs = dataclasses.replace(
        pk.d_commitment,
        powers_of_g=arrays["_d_powers"],
        root_levels=arrays["_d_root"],
    )
    kw = {k: v for k, v in arrays.items() if not k.startswith("_")}
    return dataclasses.replace(pk, c_commitment=c_srs, d_commitment=d_srs, **kw)


def party_shardings(mesh: Mesh, arrays, n_parties: int, axis: str = "party"):
    """NamedSharding pytree: leading party axis sharded, rest replicated."""

    def shard_of(a):
        if hasattr(a, "shape") and a.ndim >= 1 and a.shape[0] == n_parties:
            return NamedSharding(mesh, P(axis, *([None] * (a.ndim - 1))))
        return NamedSharding(mesh, P())

    return jax.tree.map(shard_of, arrays)
