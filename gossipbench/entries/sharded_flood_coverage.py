"""Driver of ``parallel.engine_sharded.run_sharded_flood_coverage``: the
coverage flood over a (shares, nodes) mesh of ranks, one card a rank,
called by every rank on the same inputs, on a graph staged once a rank
in set-up (``sharded_graph=``). The configuration's ``mesh`` block gives
the shape, the exchange and the ring mode. Every rank gets the global
counters and coverage rows back."""

from __future__ import annotations

from gossipbench.entries.sync_sim import COUNTERS, release  # noqa: F401
from gossipbench.reference import flood

TRAFFIC_KEYS = ("horizon", "chunk_size")
CONFIG_KEYS = ("delay_ticks", "mesh")


def prepare(device, config):
    from p2p_gossip_tpu_torch.parallel.mesh import make_mesh

    m = config["mesh"]
    mesh = make_mesh(n_node_shards=int(m["nodes"]), n_share_shards=int(m["shares"]),
                     device=device)
    return {"device": device, "delay": int(config["delay_ticks"]), "mesh": mesh,
            "exchange": m["exchange"], "ring_mode": m["ring_mode"]}


def stage(ctx, n, edges):
    """The program's CSR from the edge list, then this rank's shard."""
    from p2p_gossip_tpu_torch.models.topology import Graph
    from p2p_gossip_tpu_torch.parallel.engine_sharded import stage_sharded_graph

    graph = Graph.from_edges(n, edges)
    sg = stage_sharded_graph(graph, ctx["mesh"], constant_delay=ctx["delay"])
    return {"graph": graph, "sg": sg, "ctx": ctx}


def run(staged, origins, gen_ticks, traffic):
    from p2p_gossip_tpu_torch.parallel.engine_sharded import run_sharded_flood_coverage

    ctx = staged["ctx"]
    stats, coverage = run_sharded_flood_coverage(
        staged["graph"], origins, int(traffic["horizon"]), ctx["mesh"],
        constant_delay=ctx["delay"], chunk_size=int(traffic["chunk_size"]),
        ring_mode=ctx["ring_mode"], exchange=ctx["exchange"], sharded_graph=staged["sg"])
    return {
        "counters": {k: getattr(stats, k) for k in COUNTERS},
        "ticks": int(stats.extra["ticks_executed"]),
        "coverage": coverage,
        "resident_bytes": int(stats.extra["resident_bytes"]),
    }


def ticks(result, staged, traffic) -> int:
    return result["ticks"]


def reference(world, graph, origins, gen_ticks, traffic, config, *, occupancy=False,
              lose_seed=None):
    """The plain reference of one simulation, with its coverage rows, its
    blocks shared out over the ranks."""
    n, indptr, indices = graph
    p = flood.Problem(n, indptr, indices, origins, gen_ticks, int(traffic["horizon"]),
                      int(config["delay_ticks"]), int(traffic["chunk_size"]))
    return flood.solve(p, world, coverage=True, occupancy=occupancy, lose_seed=lose_seed)
