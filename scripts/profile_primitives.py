#!/usr/bin/env python
"""Per-primitive device timing at the flagship config (n=16, l=8).

Times each protocol primitive that appears in the dominant phases
(wire a: 10.1 s, Open: 8.3 s, wire layers: 3.1 s in the round-3 warm
trace) as its OWN jitted executable with a hard device barrier, so the
22 s/party flagship number decomposes into attackable pieces.

Usage: python scripts/profile_primitives.py [--n 16] [--l 8]
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=16)
    ap.add_argument("--l", type=int, default=8)
    ap.add_argument("--only", default="", help="comma list of step names")
    args = ap.parse_args()

    from scalable_collaborative_zksnark_tpu.utils.benchlib import (
        enable_compile_cache,
    )

    enable_compile_cache()

    import jax

    from scalable_collaborative_zksnark_tpu.hyperplonk import (
        packed_proving_parameters,
    )
    from scalable_collaborative_zksnark_tpu.hyperplonk.collaborative import (
        _num_den_h,
        _stackp,
        _dsum_ch,
    )
    from scalable_collaborative_zksnark_tpu.mpc.net import PartyNet
    from scalable_collaborative_zksnark_tpu.primitives.acc_product import (
        d_acc_product,
    )
    from scalable_collaborative_zksnark_tpu.primitives.poly_comm import (
        c_commit,
        c_open,
    )
    from scalable_collaborative_zksnark_tpu.primitives.sumcheck import (
        c_sumcheck_product,
        d_sumcheck_product,
    )

    n, l = args.n, args.l
    N = 8 * l
    net = PartyNet(N, mode="leader")
    t0 = time.time()
    pk = packed_proving_parameters(n, l, net)
    jax.block_until_ready(pk.V)
    print(f"# setup: {time.time() - t0:.1f}s", file=sys.stderr)

    F = pk.pp.field
    pp = pk.pp
    gc = 1 << n
    P = net.local_parties
    from scalable_collaborative_zksnark_tpu.hyperplonk.collaborative import (
        _exchange_s,
    )

    local_s_p = F.random((P, gc * 4 // net.n), 63)
    local_s = F.random((P, gc * 4 // net.n // pp.l), 64)
    s_shares = _exchange_s(F, net, local_s)
    num, den, h_p = _num_den_h(
        F, local_s_p, pk.sid_p, pk.eq_r1_p, pk.ssigma_p, pk.alpha, pk.beta
    )
    grp8 = _stackp([pk.ssigma_p, pk.sid_p, h_p, num, den, h_p, num, den])
    grp5 = _stackp([pk.ssigma_p, pk.sid_p, h_p, num, den])
    grp3 = _stackp([pk.I_p, pk.S1_p, pk.S2_p])
    abc = _stackp([pk.a_evals, pk.b_evals, pk.c_evals])

    c = 8
    steps = {
        # Commit-phase pieces (baseline: whole phase 0.65 s)
        "d_commit_grp3": lambda: pk.d_commitment.d_commit(net, grp3, c=c),
        "c_commit_abc": lambda: c_commit(
            pk.c_commitment, pp, net, [pk.a_evals, pk.b_evals, pk.c_evals], c=c
        ),
        # Open phase (8.3 s total)
        "c_open_abc": lambda: c_open(
            pk.c_commitment, pp, net, abc, pk.challenge, c=c
        ),
        "d_open_grp3": lambda: pk.d_commitment.d_open(
            net, grp3, pk.challenge, c=c
        ),
        # wire a pieces (10.1 s total)
        "d_commit_s": lambda: pk.d_commitment.d_commit(net, local_s_p, c=c),
        "c_sumcheck_sV": lambda: c_sumcheck_product(
            pp, net, s_shares, pk.V, pk.challenge_r1
        ),
        "c_open_V": lambda: c_open(
            pk.c_commitment, pp, net, pk.V, pk.challenge_r1, c=c
        ),
        "d_open_s": lambda: pk.d_commitment.d_open(
            net, local_s_p, pk.challenge_r2, c=c
        ),
        "num_den_h": lambda: _num_den_h(
            F, local_s_p, pk.sid_p, pk.eq_r1_p, pk.ssigma_p, pk.alpha, pk.beta
        ),
        "d_acc_product": lambda: d_acc_product(F, net, h_p),
        "d_commit_grp8": lambda: pk.d_commitment.d_commit(net, grp8, c=c),
        "d_open_grp5": lambda: pk.d_commitment.d_open(
            net, grp5, pk.challenge_r2, c=c
        ),
        "d_sumcheck3": lambda: d_sumcheck_product(
            F,
            net,
            _stackp([den, h_p, num]),
            _stackp([pk.eq_r2_p, den, pk.eq_r2_p]),
            _dsum_ch(net, pk.challenge_r2),
        ),
    }
    # one layered-zerocheck layer at representative halving sizes
    from scalable_collaborative_zksnark_tpu.hyperplonk.collaborative import (
        _zerocheck_layer,
    )

    M0 = gc * 4 // net.n // 2
    for sz in (M0, M0 // 4, M0 // 16):
        v1 = F.random((P, sz), 70 + sz)
        v0 = F.random((P, sz), 71 + sz)
        vx = F.random((P, sz), 72 + sz)
        eqv = F.random((P, sz), 73 + sz)
        steps[f"zc_layer_{sz}"] = (
            lambda v1=v1, v0=v0, vx=vx, eqv=eqv: _zerocheck_layer(
                pk, net, v1, v0, vx, eqv, pk.challenge_r2[1:], c
            )
        )
    only = [s for s in args.only.split(",") if s]
    for name, fn in steps.items():
        if only and name not in only:
            continue
        jfn = jax.jit(fn)
        t0 = time.time()
        out = jfn()
        jax.block_until_ready(out)
        cold = time.time() - t0
        best = float("inf")
        for _ in range(2):
            t0 = time.time()
            out = jfn()
            jax.block_until_ready(out)
            best = min(best, time.time() - t0)
        print(f"{name:18s} warm {best*1e3:9.1f} ms   (cold {cold:6.1f} s)")


if __name__ == "__main__":
    main()
