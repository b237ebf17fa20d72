"""Runs ``batch.campaign.run_protocol_campaign`` with push-pull: R
replicas of one simulation, each with the drawn schedule's origins on
tick 0 and its own partner seed (`reference.pushpull.partner_seeds`,
from the schedule), stacked in one batch, every round of the horizon, at
the campaign's default pass; a graph staged once in set-up as its CSR
(``PartnerGraph.build``, one delay on every link). Counters come back
(R, N), handed on flat (R*N,) as the check reads counters, and coverage
rows (R, horizon, shares).

The entry reports no ``ticks``; `ticks` gives the rounds the loop ran
(horizon x passes, the campaign's ``extra["rounds_executed"]``)."""

from __future__ import annotations

import numpy as np

from gossipbench.entries.sync_sim import release  # noqa: F401
from gossipbench.reference import pushpull

TRAFFIC_KEYS = ("horizon", "replicas")
CONFIG_KEYS = ("delay_ticks",)


def prepare(device, config):
    from p2p_gossip_tpu_torch.models.protocols import PartnerGraph  # the staging API

    return {"device": device, "delay": int(config["delay_ticks"]), "build": PartnerGraph.build}


def stage(ctx, n, edges):
    from p2p_gossip_tpu_torch.models.topology import Graph

    graph = Graph.from_edges(n, edges)
    pg = ctx["build"](graph, constant_delay=ctx["delay"], device=ctx["device"])
    return {"graph": graph, "pg": pg, "ctx": ctx}


def run(staged, origins, gen_ticks, traffic):
    from p2p_gossip_tpu_torch.batch.campaign import ReplicaSet, run_protocol_campaign

    graph, pg = staged["graph"], staged["pg"]
    r = int(traffic["replicas"])
    reps = ReplicaSet(n=graph.n, origins=np.tile(origins, (r, 1)),
                      gen_ticks=np.tile(gen_ticks, (r, 1)),
                      seeds=pushpull.partner_seeds(origins, gen_ticks, r))
    result = run_protocol_campaign(graph, reps, int(traffic["horizon"]), protocol="pushpull",
                                   device_graph=pg, device=pg.device)
    generated, received = result.generated.reshape(-1), result.received.reshape(-1)
    return {
        "counters": {"generated": generated, "received": received, "forwarded": received,
                     "sent": result.sent.reshape(-1), "processed": generated + received},
        "ticks": None,
        "coverage": result.coverage,
        "rounds": int(result.extra["rounds_executed"]),
    }


def ticks(result, staged, traffic) -> int:
    return result["rounds"]


def reference(world, graph, origins, gen_ticks, traffic, config, *, occupancy=False,
              lose_seed=None):
    """R solo references, one a partner seed (the campaign's bitwise
    contract: replica r is the solo run with its seed)."""
    n, indptr, indices = graph
    seeds = pushpull.partner_seeds(origins, gen_ticks, int(traffic["replicas"]))
    problems = [pushpull.Problem(n, indptr, indices, None, origins, gen_ticks,
                                 int(traffic["horizon"]), int(s),
                                 delay=int(config["delay_ticks"])) for s in seeds]
    out, occ = pushpull.campaign(problems, world.device, occupancy=occupancy,
                                 lose_seed=lose_seed)
    return {k: v if k == "coverage" else v.reshape(-1) for k, v in out.items()}, occ
