"""Million-node flood on one card: the project's north star (BASELINE.json
config 3), the counterpart of the JAX package's ``scripts/scale_1m.py``.

    python -m p2p_gossip_tpu_torch.scale [--nodes 1000000] [--prob 0.001]
        [--shares 4096] [--cache er1m.npz] [--topology er|ba --baM 3]

A 1M-node Erdős–Rényi p = 0.001 graph (~5e8 undirected links) built by the
C++ builder (`runtime.native`; a few minutes) or loaded from an npz cache
(``--cache``: the JAX package's file and fingerprint, so a cache either
package writes serves both), staged on the card, and 4,096 shares flooded
from random origins at t = 0: one warm run, one timed run, per-share
time-to-99%-coverage. ``--chunk 0`` sizes the share pass with the
resident-memory model (`engine.sync.auto_chunk_shares` against
`device_budget_bytes`: ``P2P_HBM_BUDGET_GB`` or the card's free memory).

Prints one JSON line on stdout in the JAX script's shape (``metric``,
``value`` in seconds, ``unit``, ``vs_baseline`` = 60 s / value), naming
the card where the JAX script names its platform; diagnostics go to
stderr, ending in one ``scale-record: {...}`` JSON line with every
measurement unrounded (build, cache save/load, staging, peak host RSS,
modeled and measured peak device memory, wall, ticks, node-updates/s,
kernel launches). ``--cpu`` runs on the CPU (the kernels' plain versions);
without it the run needs CUDA and raises otherwise.

``--mesh SxN`` (share shards x node shards, the JAX script's spelling)
runs the sharded flood (`parallel.engine_sharded.run_sharded_flood_coverage`)
on every rank of the world instead: under ``torchrun --nproc-per-node K``
(NCCL; gloo with ``--cpu``), as one process a world of one rank. The graph
is staged once for the rank's shard (``stage_s``); an explicit ``--chunk``
is forwarded as the pass width and the auto budget is off (a mesh's relief
comes from its node axis). With ``--cache`` rank 0 builds and saves the
npz while the others wait, then load it. Every rank holds the whole host
graph (the CSR: ~4 GB a rank at 1M ER p = 0.001). Rank 0 prints; the
record gains the mesh shape and each rank's peak device bytes, modeled
``resident_bytes`` and peak host RSS.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import resource
import sys
import time

import numpy as np


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _quiet(msg: str) -> None:
    pass


def _rss_peak_bytes() -> int:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024  # Linux: KiB


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m p2p_gossip_tpu_torch.scale")
    ap.add_argument("--nodes", type=int, default=1_000_000)
    ap.add_argument("--prob", type=float, default=0.001)
    ap.add_argument("--shares", type=int, default=4096)
    ap.add_argument(
        "--chunk", type=int, default=0,
        help="Shares per device pass (0 = auto: the widest pad whose "
        "modeled resident memory, engine.sync.flood_resident_hbm_bytes, "
        "fits P2P_HBM_BUDGET_GB or the card's free memory)",
    )
    ap.add_argument("--horizon", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--cache", type=str, default="",
        help="npz path to cache the built graph across runs",
    )
    ap.add_argument(
        "--topology", choices=("er", "ba"), default="er",
        help="er = the north-star ER config; ba = BASELINE config 4's "
        "Barabasi-Albert scale-free topology (--baM edges per node)",
    )
    ap.add_argument("--baM", type=int, default=3)
    ap.add_argument(
        "--cpu", action="store_true",
        help="Run on the CPU (the kernels' plain torch versions)",
    )
    ap.add_argument(
        "--mesh", type=str, default="",
        help="SxN (share shards x node shards): the sharded flood over the "
        "world's ranks instead of the single-device engine",
    )
    return ap


def _mesh_shape(spec: str) -> tuple[int, int]:
    try:
        shares, nodes = (int(x) for x in spec.lower().split("x"))
    except ValueError:
        raise SystemExit(f"error: --mesh {spec!r}: expected SxN, e.g. 1x4") from None
    return shares, nodes


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    from p2p_gossip_tpu_torch.engine.sync import (
        MIN_CHUNK_SHARES,
        DeviceGraph,
        auto_chunk_shares,
        device_budget_bytes,
        flood_resident_hbm_bytes,
        run_flood_coverage,
        time_to_coverage,
    )
    from p2p_gossip_tpu_torch.models.topology import load_or_build_graph_cache
    from p2p_gossip_tpu_torch.ops import kernels
    from p2p_gossip_tpu_torch.ops.bitmask import num_words
    from p2p_gossip_tpu_torch.ops.ell import DEFAULT_DEGREE_BLOCK
    from p2p_gossip_tpu_torch.runtime import native
    from p2p_gossip_tpu_torch.utils.device import resolve_device

    mesh = None
    rank = 0
    if args.mesh:
        import torch.distributed as dist

        from p2p_gossip_tpu_torch.parallel.mesh import initialize_multihost, local_device

        share_shards, node_shards = _mesh_shape(args.mesh)
        dev = local_device("cpu" if args.cpu else None)
        rank, _ = initialize_multihost(device=dev)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
    else:
        dev = resolve_device("cpu" if args.cpu else None)
    on_card = dev.type == "cuda"
    device_name = torch.cuda.get_device_name(dev) if on_card else "cpu"
    record: dict = {"device": device_name, "nodes": args.nodes,
                    "topology": args.topology}
    say = _quiet if rank else log  # rank 0 reports

    def world_barrier():
        dist.all_reduce(torch.zeros(1, device=dev))

    t_build = {}

    def build():
        t0 = time.perf_counter()
        if args.topology == "ba":
            graph = native.native_barabasi_albert(args.nodes, m=args.baM, seed=args.seed)
        else:
            graph = native.native_erdos_renyi(args.nodes, args.prob, seed=args.seed)
        t_build["s"] = time.perf_counter() - t0
        say(f"graph built: {t_build['s']:.1f}s")
        return graph

    # Under a mesh with --cache, rank 0 builds and saves while the others
    # wait, then load: no two ranks write one npz.
    shared_cache = bool(args.mesh and args.cache)
    if shared_cache and rank:
        world_barrier()
    t0 = time.perf_counter()
    graph = load_or_build_graph_cache(
        args.cache, topology=args.topology, nodes=args.nodes, prob=args.prob,
        ba_m=args.baM, seed=args.seed, build=build, log=say,
    )
    t_graph = time.perf_counter() - t0
    if shared_cache and not rank:
        world_barrier()
    if "s" in t_build:
        record["build_s"] = t_build["s"]
        if args.cache:
            record["cache_save_s"] = t_graph - t_build["s"]
    else:
        record["cache_load_s"] = t_graph
    if args.cache:
        record["cache_bytes"] = os.path.getsize(args.cache)
    record.update(edges=graph.num_edges, dmax=graph.max_degree,
                  rss_peak_after_graph=_rss_peak_bytes())
    say(f"N={graph.n} edges={graph.num_edges} dmax={graph.max_degree} "
        f"device={device_name}")

    # A mesh pads every pass to its own chunk default: no auto budget there.
    budget = device_budget_bytes(dev) if args.chunk == 0 and not args.mesh else 0.0
    base_alloc = torch.cuda.memory_allocated(dev) if on_card else 0
    t0 = time.perf_counter()
    if args.mesh:
        from p2p_gossip_tpu_torch.parallel.engine_sharded import (
            run_sharded_flood_coverage,
            stage_sharded_graph,
        )
        from p2p_gossip_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh(node_shards, share_shards, device=dev)
        say(f"mesh: {share_shards} share shards x {node_shards} node shards")
        sg = stage_sharded_graph(graph, mesh)
        sg.on_device(dev)  # the device copies count in stage_s, as DeviceGraph's do
        buckets = sum(sg.bucket_counts)
    else:
        dg = DeviceGraph.build(graph, device=dev)
        buckets = len(dg.buckets) if dg.buckets is not None else 0
    if on_card:
        torch.cuda.synchronize(dev)
    record.update(stage_s=time.perf_counter() - t0,
                  rss_peak_after_staging=_rss_peak_bytes(), buckets=buckets)
    say(f"device staging: {record['stage_s']:.1f}s, {record['buckets']} degree "
        f"buckets, peak host RSS {record['rss_peak_after_staging'] / 2**30:.2f} GiB")

    rng = np.random.default_rng(args.seed)
    origins = rng.integers(0, graph.n, args.shares).astype(np.int32)
    # pad: the chunk_size handed to run_flood_coverage (None = the engine's
    # default MIN_CHUNK_SHARES pad); chunk: the origins of one pass.
    if args.chunk:
        chunk = max(32, min(args.chunk, args.shares))
        pad = chunk
    elif args.mesh:
        pad, chunk = None, args.shares
    else:
        pad = auto_chunk_shares(graph.degree, args.shares, DEFAULT_DEGREE_BLOCK, budget)
        chunk = args.shares if pad is None else min(pad, args.shares)
    w = num_words(pad if pad is not None else max(args.shares, MIN_CHUNK_SHARES))
    record.update(budget_bytes=budget, pad=pad, chunk=chunk, words=w)
    if not args.mesh:
        model = flood_resident_hbm_bytes(graph.degree, w, DEFAULT_DEGREE_BLOCK, dg.ring_size)
        record["model_bytes"] = model
        say(f"resident model at W={w}: {model / 1e9:.2f} GB"
            + (f" (budget {budget / 1e9:.1f} GB" + (
                f", padding to {pad} shares)" if pad is not None else ", fits)")
               if budget else ""))
    resident = []  # the sharded runner's modeled peak of this rank, a pass
    mesh_ticks = []  # the sharded runner's executed ticks, a pass

    def flood_all():
        """Shares are independent: chunked passes, counters add."""
        processed = 0
        covs = []
        for lo in range(0, args.shares, chunk):
            if mesh is not None:
                stats, cov = run_sharded_flood_coverage(
                    graph, origins[lo : lo + chunk], args.horizon, mesh, sharded_graph=sg,
                    **({"chunk_size": pad} if args.chunk else {}),
                )
                resident.append(stats.extra["resident_bytes"])
                mesh_ticks.append(stats.extra["ticks_executed"])
            else:
                stats, cov = run_flood_coverage(
                    graph, origins[lo : lo + chunk], args.horizon,
                    device_graph=dg, chunk_size=pad, device=dev,
                )
            processed += stats.totals()["processed"]
            covs.append(cov)
        return processed, np.concatenate(covs, axis=1)

    t0 = time.perf_counter()
    flood_all()
    record["warm_wall_s"] = time.perf_counter() - t0
    say(f"warmup: {record['warm_wall_s']:.2f}s")

    kernels.reset_launches()
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    mesh_ticks.clear()
    t0 = time.perf_counter()
    processed, cov = flood_all()
    wall = time.perf_counter() - t0
    launches = dict(kernels.launches)
    ttc = time_to_coverage(cov, graph.n, 0.99)
    full = processed == args.shares * graph.n
    # The ticks executed: the sharded runner's count, or one coverage_per_slot
    # launch a tick on the card.
    ticks = sum(mesh_ticks) if mesh is not None else (
        launches["coverage_per_slot"] if on_card else None)
    peak = torch.cuda.max_memory_allocated(dev) - base_alloc if on_card else None
    record.update(
        wall_s=wall, processed=int(processed), full_coverage=bool(full),
        node_updates_per_s=processed / max(wall, 1e-9),
        ticks=ticks, ms_per_tick=wall / ticks * 1e3 if ticks else None,
        ttc99_median=float(np.median(ttc)), ttc99_max=int(ttc.max()),
        launches=launches, peak_device_bytes=peak,
        # The (horizon, shares) per-tick coverage rows, as int64 bytes.
        coverage_sha256=hashlib.sha256(cov.astype(np.int64).tobytes()).hexdigest(),
    )
    if mesh is not None:
        # Rank by rank: peak device bytes, the runner's modeled resident
        # bytes (the largest pass), peak host RSS.
        ranks = [None] * dist.get_world_size()
        dist.all_gather_object(ranks, (peak, max(resident), _rss_peak_bytes()))
        record.update(
            mesh={"shares": share_shards, "nodes": node_shards},
            rank_peak_device_bytes=[r[0] for r in ranks],
            rank_resident_bytes=[r[1] for r in ranks],
            rank_rss_peak_bytes=[r[2] for r in ranks],
        )
    say(
        f"flood: {processed} node-updates in {wall:.3f}s, full coverage: "
        f"{full}, ttc99 median {int(np.median(ttc))} / max {int(ttc.max())} "
        f"ticks"
    )
    say("scale-record: " + json.dumps(record))
    if rank:
        return 0
    shape = f"BA(m={args.baM}) graph" if args.topology == "ba" else f"p={args.prob:g} graph"
    where = f"({args.mesh} mesh)" if args.mesh else "(one device)"
    print(json.dumps({
        "metric": f"wall seconds to 99% coverage, {args.shares} shares on a "
        f"{graph.n}-node {shape} {where} [{device_name}]",
        "value": round(wall, 2),
        "unit": "s",
        "vs_baseline": round(60.0 / max(wall, 1e-9), 2),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
