"""Party-axis collective substrate — the device-mesh replacement of mpc-net.

The reference runs N = 8l MPC parties over a TCP mesh
(/root/reference/mpc-net/src/{lib.rs,multi.rs}) with a star topology:
gather-to-leader, scatter-from-leader, leader_compute(f) = gather→f→
scatter, rotating-root variants, and a barrier.  On the accelerator the party
dimension is an *array axis* (shardable over a mesh axis): protocol
state lives in arrays shaped ``[N, ...]`` and every cross-party movement
is a pure array op that XLA lowers to collectives when the party
axis is sharded.  There is deliberately no socket layer to rebuild — the
leader bottleneck disappears because ``f`` in every leader_compute of
the reference is a linear map (unpack/sum/repack), which we fuse into
party-axis matrix contractions at the call sites.

What remains of mpc-net here is its *accounting*: the reference counts
per-party upload/download bytes (multi.rs:389-417 real mode;
serializing_net.rs:144-264 simulated mode) using arkworks compressed
sizes.  We replicate that analytically so `Comm:` numbers are comparable.

Execution modes (mirrors the reference's cargo feature matrix,
README.md:28-33):
* ``sim``    — all N parties computed on-device as a batch axis (the
              `local`/`local-multi-thread` modes; results are real).
* ``leader`` — only one party's compute is materialized; gathers tile the
              party's own data N times (the `leader` mode's fake network,
              serializing_net.rs:158-164); costs are faithful, values not.
SPMD multi-chip execution is ``sim`` with the party axis sharded.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

# arkworks serialize_compressed sizes (bytes)
SIZEOF = {
    "fr": 32,  # 253/255-bit scalars
    "g1": 48,  # compressed G1 affine (381/377-bit x + flags)
    "g2": 96,
}
VEC_PREFIX = 8  # arkworks Vec<T> length prefix (u64)


class PartyNet:
    """Collective vocabulary + per-party byte accounting for N parties."""

    def __init__(self, n_parties: int, mode: str = "sim"):
        assert mode in ("sim", "leader")
        self.n = n_parties
        self.mode = mode
        self.up = [0] * n_parties
        self.down = [0] * n_parties
        self.rounds = 0

    # number of party slots materialized in arrays
    @property
    def local_parties(self) -> int:
        return 1 if self.mode == "leader" else self.n

    # ------------------------------------------------------------------
    # byte accounting helpers
    # ------------------------------------------------------------------
    @staticmethod
    def payload_bytes(kind: str, count: int = 1, vec: bool = False) -> int:
        return (VEC_PREFIX if vec else 0) + SIZEOF[kind] * count

    def _count_gather(self, sz: int, root: int = 0):
        """Everyone sends `sz` bytes to `root` (lib.rs:66-111)."""
        for i in range(self.n):
            if i == root:
                self.down[i] += sz * (self.n - 1)
            else:
                self.up[i] += sz
        self.rounds += 1

    def _count_scatter(self, sz: int, root: int = 0):
        """`root` sends `sz` bytes to everyone else (lib.rs:164-205)."""
        for i in range(self.n):
            if i == root:
                self.up[i] += sz * (self.n - 1)
            else:
                self.down[i] += sz
        self.rounds += 1

    # ------------------------------------------------------------------
    # collectives (array semantics + accounting)
    # ------------------------------------------------------------------
    def gather_to_root(self, x, kind: str, count: int = 1, vec: bool = False, root: int = 0):
        """[P, ...] per-party values -> [N, ...] visible at the root.

        ``sim``: identity (the batch axis already holds all parties).
        ``leader``: tile the single materialized party's value N times —
        exactly the reference's fake-network self-copies.
        """
        self._count_gather(self.payload_bytes(kind, count, vec), root)
        if self.mode == "leader":
            import jax

            return jax.tree.map(
                lambda a: jnp.broadcast_to(a[0:1], (self.n,) + a.shape[1:]), x
            )
        return x

    def gather_data_only(self, x):
        """Data path of a gather whose bytes were already counted as part
        of another payload (e.g. the final sumcheck value travels inside
        the same Vec as the round messages)."""
        if self.mode == "leader":
            import jax

            return jax.tree.map(
                lambda a: jnp.broadcast_to(a[0:1], (self.n,) + a.shape[1:]), x
            )
        return x

    def scatter_from_root(self, x, kind: str, count: int = 1, vec: bool = False, root: int = 0):
        """[N, ...] root-computed per-party values -> [P, ...]."""
        self._count_scatter(self.payload_bytes(kind, count, vec), root)
        return self.scatter_data_only(x)

    def scatter_data_only(self, x):
        """Data path of a scatter whose bytes are counted separately
        (fused multi-call primitives count per logical round)."""
        if self.mode == "leader":
            import jax

            return jax.tree.map(lambda a: a[0:1], x)
        return x

    def leader_compute(self, x, f, kind_in: str, kind_out: str, count_in=1, count_out=1,
                       vec_in=False, vec_out=False):
        """gather → f (party-axis map) → scatter (lib.rs:261-270)."""
        g = self.gather_to_root(x, kind_in, count_in, vec_in)
        out = f(g)
        return self.scatter_from_root(out, kind_out, count_out, vec_out)

    def all_to_all_rotating_root(self, kind: str, count_per_root: int = 1, vec: bool = False):
        """Accounting for N rounds of scatter-from-root-i (the pattern in
        dacc_product.rs:155-203 / dhyperplonk.rs:271-294).  Data movement
        in the array formulation is a reshape/transpose at the call site.
        """
        for root in range(self.n):
            self._count_scatter(self.payload_bytes(kind, count_per_root, vec), root)

    def sync(self):
        """Barrier (lib.rs:273-286) — free under SPMD; counts 1 byte RT."""
        for i in range(self.n):
            self.up[i] += 1
            self.down[i] += 1
        self.rounds += 1

    # ------------------------------------------------------------------
    def comm(self, party: int = 0):
        """(upload, download) for one party — the reference's `get_comm`."""
        return self.up[party], self.down[party]

    def comm_total(self):
        return sum(self.up), sum(self.down)

    def reset_comm(self):
        self.up = [0] * self.n
        self.down = [0] * self.n
        self.rounds = 0

    def comm_snapshot(self):
        """Counter state, for discarding double-counted traces (the AOT
        precompiler shape-traces wire_a/commit once extra)."""
        return (list(self.up), list(self.down), self.rounds)

    def comm_restore(self, snap):
        self.up, self.down, self.rounds = list(snap[0]), list(snap[1]), snap[2]
