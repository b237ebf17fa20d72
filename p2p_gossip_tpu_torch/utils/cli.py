"""``python -m p2p_gossip_tpu_torch`` — the flood engine from the command
line, with the reference's four flags and defaults (p2pnetwork.cc:300-305:
``--numNodes 10 --connectionProb 0.3 --simTime 60 --Latency 5``) and its
`PrintStatistics` report. One tick is one link latency, as in the JAX
package's CLI: the graph is Erdős–Rényi, shares follow the reference's
U(2, 5) s renewal process, and both derive from ``--seed``."""

from __future__ import annotations

import argparse
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="p2p_gossip_tpu_torch",
        description="P2P gossip network simulation on PyTorch/CUDA.",
    )
    p.add_argument("--numNodes", type=int, default=10, help="Number of nodes")
    p.add_argument(
        "--connectionProb", type=float, default=0.3,
        help="Probability of connection between nodes",
    )
    p.add_argument(
        "--simTime", type=float, default=60.0, help="Simulation time in seconds"
    )
    p.add_argument("--Latency", type=float, default=5.0, help="latency in ms")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--chunkSize", type=int, default=4096, help="Shares per device pass"
    )
    p.add_argument(
        "--device", default="cuda",
        help="torch device (default cuda; cpu runs the plain torch versions)",
    )
    return p


def run(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from p2p_gossip_tpu_torch.engine.sync import run_sync_sim
    from p2p_gossip_tpu_torch.models.generation import uniform_renewal_schedule
    from p2p_gossip_tpu_torch.models.topology import erdos_renyi
    from p2p_gossip_tpu_torch.utils.stats import format_final_statistics

    if args.numNodes < 2:
        print("error: --numNodes must be >= 2", file=sys.stderr)
        return 2
    if args.Latency <= 0 or args.simTime < 0 or args.chunkSize < 1:
        print(
            "error: --Latency must be > 0, --simTime >= 0, --chunkSize >= 1",
            file=sys.stderr,
        )
        return 2
    tick_dt = args.Latency / 1000.0
    horizon = int(round(args.simTime / tick_dt))
    g = erdos_renyi(args.numNodes, args.connectionProb, seed=args.seed)
    sched = uniform_renewal_schedule(g.n, args.simTime, tick_dt, seed=args.seed)
    print(
        f"Starting gossip network simulation: {g.n} nodes, "
        f"{g.num_edges} links, {sched.num_shares} shares scheduled, "
        f"{horizon} ticks ({args.simTime:g}s at {args.Latency:g}ms), "
        f"device={args.device}"
    )
    t0 = time.perf_counter()
    stats = run_sync_sim(
        g, sched, horizon, chunk_size=args.chunkSize, device=args.device
    )
    wall = time.perf_counter() - t0
    print(format_final_statistics(stats, per_node=g.n <= 1000), end="")
    print(
        f"Simulated {args.simTime:g}s ({horizon} ticks, "
        f"{stats.extra['ticks_executed']} executed) in {wall:.3f}s wall "
        f"({stats.totals()['processed'] / max(wall, 1e-9):.3g} node-updates/s)"
    )
    return 0


def main() -> None:
    sys.exit(run())
