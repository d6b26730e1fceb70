"""The party axis sharded over a device mesh vs the same prove on one device.

``sharded_vs_single`` runs ``dhyperplonk`` in sim mode (all N = 8l
parties computed) once on a single device and once with every share
table's party axis sharded ``P("party")`` over ``Mesh(devices, ("party",))``
(hyperplonk/sharding.py), and returns both canonical digests.  Used by
``chip_smoke.py --four``; runs on virtual CPU devices as well.
"""

from __future__ import annotations

import time


def _device_peaks(devices):
    out = []
    for d in devices:
        stats = d.memory_stats() or {}
        out.append(stats.get("peak_bytes_in_use"))
    return out


def sharded_vs_single(devices, n: int, l: int, log=print) -> dict:
    import jax
    from jax.sharding import Mesh

    from ..hyperplonk import dhyperplonk, packed_proving_parameters
    from ..hyperplonk.sharding import party_shardings, pk_arrays, pk_merge
    from ..mpc.net import PartyNet
    from .benchlib import proof_digest

    N = 8 * l
    net = PartyNet(N, mode="sim")
    t0 = time.time()
    pk = packed_proving_parameters(n, l, net)
    arrays = pk_arrays(pk)
    jax.block_until_ready(arrays)
    log(f"sim n{n}/l{l} (N={N}): set-up {time.time() - t0:.1f}s")

    def step(arrs):
        return dhyperplonk(n, pk_merge(pk, arrs), net)

    res = {}
    one = jax.device_put(arrays, devices[0])
    t0 = time.time()
    single = jax.jit(step).lower(one).compile()
    t1 = time.time()
    out = jax.block_until_ready(single(one))
    t2 = time.time()
    out = jax.block_until_ready(single(one))
    res["single_warm_s"] = time.time() - t2
    res["digest_single"] = proof_digest(out)
    log(f"1 device: compile {t1 - t0:.1f}s, first run {t2 - t1:.2f}s, "
        f"warm {res['single_warm_s']:.3f}s, "
        f"digest 0x{res['digest_single']:016X}")
    del out

    mesh = Mesh(list(devices), ("party",))
    shardings = party_shardings(mesh, arrays, N)
    sharded_in = jax.device_put(arrays, shardings)
    spread = {d for leaf in jax.tree.leaves(sharded_in)
              for d in leaf.sharding.device_set}
    assert len(spread) == len(devices), spread
    t0 = time.time()
    with mesh:
        sharded = jax.jit(step, in_shardings=(shardings,)).lower(
            sharded_in).compile()
        t1 = time.time()
        out = jax.block_until_ready(sharded(sharded_in))
        t2 = time.time()
        out = jax.block_until_ready(sharded(sharded_in))
    res["sharded_warm_s"] = time.time() - t2
    res["digest_sharded"] = proof_digest(out)
    log(f"{len(devices)} devices: compile {t1 - t0:.1f}s, first run "
        f"{t2 - t1:.2f}s, warm {res['sharded_warm_s']:.3f}s, "
        f"digest 0x{res['digest_sharded']:016X}")
    log(f"per-device peak_bytes_in_use: {_device_peaks(devices)}")
    log(f"4-card digest {'==' if res['digest_sharded'] == res['digest_single'] else '!='} "
        f"1-card digest")
    return res
