"""Protocol comparison experiment: flood vs push-pull vs pull vs fanout push.

    python -m p2p_gossip_tpu_torch.protocol_compare [--nodes 2000] [--prob 0.005]
        [--shares 32] [--horizon 64] [--fanout 3] [--seed 0]
        [--coverageFraction 0.99] [--json] [--device cpu]

The JAX package's ``scripts/protocol_compare.py`` on the port: the four
protocols on the same graph and origins, and the coverage / bandwidth
trade-off each makes, the experiment the protocol family exists for:

- flood (the reference's protocol, p2pnode.cc:127): fastest spread, one
  send per peer per processed share (~mean-degree sends per delivery);
- push-pull and pull anti-entropy: guaranteed convergence, digest traffic
  every round whether or not anything is new;
- fanout push (rumor mongering): ~fanout sends per delivery,
  probabilistic coverage.

Prints a table (or one JSON line with ``--json``) with the JAX script's
rows. Runs on the card unless ``--device cpu``; ``wall_s`` is the run's
host clock, which ends in the device-to-host copy of its results.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nodes", type=int, default=2000)
    ap.add_argument("--prob", type=float, default=0.005)
    ap.add_argument("--shares", type=int, default=32)
    ap.add_argument("--horizon", type=int, default=64)
    ap.add_argument("--fanout", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--coverageFraction", type=float, default=0.99)
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain torch versions)")
    return ap.parse_args(argv)


def compare_protocols(args, graph=None) -> list[dict]:
    """The four runs' rows, in the JAX script's order and fields.
    ``graph`` is ``erdos_renyi(args.nodes, args.prob, seed=args.seed)``
    when given (a caller that already built it)."""
    import p2p_gossip_tpu_torch as pt
    from p2p_gossip_tpu_torch.engine.sync import run_flood_coverage
    from p2p_gossip_tpu_torch.models.protocols import run_pushk_sim, run_pushpull_sim
    from p2p_gossip_tpu_torch.utils.analysis import message_redundancy, propagation_latency
    from p2p_gossip_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    g = pt.erdos_renyi(args.nodes, args.prob, seed=args.seed) if graph is None else graph
    rng = np.random.default_rng(args.seed)
    origins = rng.integers(0, g.n, args.shares).astype(np.int32)
    sched = pt.Schedule(g.n, origins, np.zeros(args.shares, dtype=np.int32))
    frac = args.coverageFraction

    def measure(name, run):
        t0 = time.perf_counter()
        stats, cov = run()  # the results are host arrays: the run has ended
        wall = time.perf_counter() - t0
        red = message_redundancy(stats)
        # All shares generate at t=0, so latency-to-coverage is
        # time-to-coverage: one computation serves both fields.
        s = propagation_latency(cov, g.n, fractions=(frac,)).summary(frac)
        return {
            "protocol": name,
            "reached_fraction": s["reached"],
            "ttc_median_ticks": s["median"],
            "final_coverage_mean": float(cov[-1].mean()),
            "sends_per_delivery": (None if red["sends_per_delivery"] is None
                                   else round(red["sends_per_delivery"], 2)),
            "total_sent": int(stats.sent.sum()),
            "p95_latency_ticks": s["p95"],
            "wall_s": round(wall, 3),
        }

    return [
        measure("flood", lambda: run_flood_coverage(g, origins, args.horizon, device=dev)),
        measure("pushpull", lambda: run_pushpull_sim(
            g, sched, args.horizon, seed=args.seed, record_coverage=True, device=dev)),
        measure("pull", lambda: run_pushpull_sim(
            g, sched, args.horizon, seed=args.seed, record_coverage=True, mode="pull",
            device=dev)),
        measure(f"pushk(k={args.fanout})", lambda: run_pushk_sim(
            g, sched, args.horizon, fanout=args.fanout, seed=args.seed,
            record_coverage=True, device=dev)),
    ]


def format_table(args, graph, rows) -> str:
    cols = list(rows[0].keys())
    widths = [max(len(c), *(len(str(r[c])) for r in rows)) for c in cols]
    lines = [
        f"N={graph.n} edges={graph.num_edges} shares={args.shares} "
        f"horizon={args.horizon} target={args.coverageFraction:.0%}",
        "  ".join(c.ljust(w) for c, w in zip(cols, widths)),
    ]
    lines += ["  ".join(str(r[c]).ljust(w) for c, w in zip(cols, widths)) for r in rows]
    return "\n".join(lines)


def main(argv=None) -> int:
    import p2p_gossip_tpu_torch as pt
    from p2p_gossip_tpu_torch.utils.device import resolve_device

    args = parse_args(argv)
    resolve_device(args.device)  # no card and no --device cpu: raise before the build
    graph = pt.erdos_renyi(args.nodes, args.prob, seed=args.seed)
    rows = compare_protocols(args, graph)
    if args.json:
        print(json.dumps({"config": vars(args), "results": rows}))
    else:
        print(format_table(args, graph, rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
