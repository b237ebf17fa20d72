"""Driver of ``engine.sync.run_sync_sim``: the flood of a whole schedule on
one card, on a graph staged once in set-up (``device_graph=``), in
passes of the mix's ``chunk_size`` shares."""

from __future__ import annotations

from gossipbench.reference import flood

COUNTERS = ("generated", "received", "forwarded", "sent", "processed")

#: The traffic keys (besides ``entry``, ``about``, ``gen``, ``check_sims``)
#: and configuration keys this entry reads; a file with another is refused.
TRAFFIC_KEYS = ("horizon", "chunk_size")
CONFIG_KEYS = ("delay_ticks",)


def prepare(device, config):
    return {"device": device, "delay": int(config["delay_ticks"])}


def stage(ctx, n, edges):
    """The program's staging from the edge list: its CSR, then the device
    graph (degree buckets, one delay on every link)."""
    from p2p_gossip_tpu_torch.engine.sync import DeviceGraph
    from p2p_gossip_tpu_torch.models.topology import Graph

    graph = Graph.from_edges(n, edges)
    dg = DeviceGraph.build(graph, constant_delay=ctx["delay"], device=ctx["device"])
    return {"graph": graph, "dg": dg, "ctx": ctx}


def run(staged, origins, gen_ticks, traffic):
    from p2p_gossip_tpu_torch.engine.sync import run_sync_sim
    from p2p_gossip_tpu_torch.models.generation import Schedule

    graph, dg = staged["graph"], staged["dg"]
    stats = run_sync_sim(graph, Schedule(graph.n, origins, gen_ticks), int(traffic["horizon"]),
                         constant_delay=staged["ctx"]["delay"],
                         chunk_size=int(traffic["chunk_size"]), device_graph=dg,
                         device=dg.device)
    return {
        "counters": {k: getattr(stats, k) for k in COUNTERS},
        "ticks": int(stats.extra["ticks_executed"]),
        "coverage": None,
    }


def reference(world, graph, origins, gen_ticks, traffic, config, *, occupancy=False,
              lose_seed=None):
    """The plain reference of one simulation, passes of ``chunk_size``."""
    n, indptr, indices = graph
    p = flood.Problem(n, indptr, indices, origins, gen_ticks, int(traffic["horizon"]),
                      int(config["delay_ticks"]), int(traffic["chunk_size"]))
    return flood.solve(p, world, occupancy=occupancy, lose_seed=lose_seed)


def ticks(result, staged, traffic) -> int:
    return result["ticks"]


def release(staged):
    staged.clear()
