"""Runs ``models.protocols.run_pushpull_sim`` (push-pull anti-entropy,
BASELINE.json config 5): one share an origin, all on tick 0, every round
of the horizon, the (horizon, origins) coverage rows recorded, in passes
of the mix's ``chunk_size`` shares, on a graph staged once in set-up as
its CSR with the configuration's per-link delays
(``PartnerGraph.build``, ``device_graph=``). The partner seed derives
from the drawn schedule (`reference.pushpull.partner_seeds`), the same in
the program's call and the reference.

The entry reports no ``ticks``; `ticks` gives the rounds the loop ran
(horizon x passes, ``stats.extra["rounds_executed"]``)."""

from __future__ import annotations

import numpy as np

from gossipbench.entries.sync_sim import COUNTERS, release  # noqa: F401
from gossipbench.gen import delays as gen_delays
from gossipbench.reference import flood, pushpull

TRAFFIC_KEYS = ("horizon", "chunk_size")
CONFIG_KEYS = ("delays",)


def prepare(device, config):
    from p2p_gossip_tpu_torch.models.protocols import PartnerGraph  # the staging API

    return {"device": device, "delays": config["delays"], "build": PartnerGraph.build}


def stage(ctx, n, edges):
    """The program's CSR from the edge list, then its partner staging with
    the configuration's delays, drawn on the benchmark's CSR (the same
    entries in the same order: checked)."""
    from p2p_gossip_tpu_torch.models.topology import Graph

    graph = Graph.from_edges(n, edges)
    indptr, indices = flood.csr_from_edges(n, edges)
    if not (np.array_equal(graph.indptr, indptr) and np.array_equal(graph.indices, indices)):
        raise RuntimeError("the program's CSR is not the benchmark's: the delays would move")
    delays = gen_delays.edge_delays(ctx["delays"], n, indptr, indices)
    pg = ctx["build"](graph, delays, device=ctx["device"])
    return {"graph": graph, "pg": pg, "ctx": ctx}


def run(staged, origins, gen_ticks, traffic):
    from p2p_gossip_tpu_torch.models.generation import Schedule
    from p2p_gossip_tpu_torch.models.protocols import run_pushpull_sim

    graph, pg = staged["graph"], staged["pg"]
    seed = int(pushpull.partner_seeds(origins, gen_ticks, 1)[0])
    stats, coverage = run_pushpull_sim(
        graph, Schedule(graph.n, origins, gen_ticks), int(traffic["horizon"]), seed=seed,
        record_coverage=True, device_graph=pg, chunk_size=int(traffic["chunk_size"]),
        device=pg.device)
    return {
        "counters": {k: getattr(stats, k) for k in COUNTERS},
        "ticks": None,
        "coverage": coverage,
        "rounds": int(stats.extra["rounds_executed"]),
    }


def ticks(result, staged, traffic) -> int:
    return result["rounds"]


def reference(world, graph, origins, gen_ticks, traffic, config, *, occupancy=False,
              lose_seed=None):
    """The plain reference of one simulation, with its coverage rows."""
    n, indptr, indices = graph
    p = pushpull.Problem(n, indptr, indices,
                         gen_delays.edge_delays(config["delays"], n, indptr, indices),
                         origins, gen_ticks, int(traffic["horizon"]),
                         int(pushpull.partner_seeds(origins, gen_ticks, 1)[0]))
    return pushpull.solve(p, world.device, occupancy=occupancy, lose_seed=lose_seed)
