"""Driver of ``engine.sync.run_flood_coverage``: one share an origin, all
on tick 0, the (horizon, origins) coverage rows recorded, on a graph
staged once in set-up (``device_graph=``), at the entry's default pad.

The entry does not report the ticks its loop ran; they follow from its
coverage rows by the loop's stop rule (`ticks`)."""

from __future__ import annotations

import numpy as np

from gossipbench.entries.sync_sim import (  # noqa: F401
    CONFIG_KEYS, COUNTERS, prepare, release, stage)
from gossipbench.reference import flood

TRAFFIC_KEYS = ("horizon",)


def run(staged, origins, gen_ticks, traffic):
    from p2p_gossip_tpu_torch.engine.sync import run_flood_coverage

    graph, dg = staged["graph"], staged["dg"]
    stats, coverage = run_flood_coverage(graph, origins, int(traffic["horizon"]),
                                         constant_delay=staged["ctx"]["delay"],
                                         device_graph=dg, device=dg.device)
    return {
        "counters": {k: getattr(stats, k) for k in COUNTERS},
        "ticks": None,
        "coverage": coverage,
    }


def reference(world, graph, origins, gen_ticks, traffic, config, *, occupancy=False,
              lose_seed=None):
    """The plain reference of one simulation: every origin in one pass,
    with its coverage rows."""
    n, indptr, indices = graph
    p = flood.Problem(n, indptr, indices, origins, gen_ticks, int(traffic["horizon"]),
                      int(config["delay_ticks"]))
    return flood.solve(p, world, coverage=True, occupancy=occupancy, lose_seed=lose_seed)


def ticks(result, staged, traffic) -> int:
    """Ticks the loop ran: a tick whose coverage row grew processed a
    share (tick 0 generates), and the loop stops once the last ``delay +
    1`` ticks (the frontiers in flight) processed nothing."""
    cov = result["coverage"]
    h = cov.shape[0]
    busy = np.zeros(h, dtype=bool)
    busy[0] = True
    busy[1:] = (cov[1:] != cov[:-1]).any(axis=1)
    return flood.loop_ticks(busy, 0, 0, staged["ctx"]["delay"] + 1, h)
