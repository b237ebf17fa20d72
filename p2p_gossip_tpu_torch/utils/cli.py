"""``python -m p2p_gossip_tpu_torch`` — the simulator from the command line,
with the reference's four flags and defaults (p2pnetwork.cc:300-305:
``--numNodes 10 --connectionProb 0.3 --simTime 60 --Latency 5``), its
periodic and final reports (`PrintPeriodicStats`, `PrintStatistics`), and
the JAX package CLI's single-device flags with that CLI's names, defaults,
validation and messages: topologies, generation models, delay models,
churn, link loss, the connect window, checkpoints, the flood-coverage
experiment, the random-partner protocols (``--protocol pushpull|pull|
pushk``), the ``--json`` line, the ``--anim`` NetAnim file (with
``--animMessages``' per-message events), the ``--telemetry`` stream and
``--heartbeat`` file (`p2p_gossip_tpu_torch.telemetry`), Monte-Carlo
campaigns (``--replicas R``: replica r runs with seed ``--seed + r``),
grid sweeps (``--sweep SPEC.json``, `p2p_gossip_tpu_torch.batch`),
component logs (``--log``, `utils.logging`), npz graph caches
(``--graphFile``), the C++ graph builders (``--graphBuilder``), the
reference's parallel-link quirk (``--refParallelLinks``) and the engines
(``--backend``): ``tpu``, the default, is the device engine (the card, or
``--device cpu``), named as in the JAX CLI so one command line runs in
either package; ``sharded`` the sharded flood engine, or with
``--protocol`` the sharded protocols, over a (shares, nodes) mesh of
``torch.distributed`` ranks (``--meshNodes``, ``--meshShares``,
``--ringMode``; under ``torchrun --nproc-per-node K`` rank 0 prints the
report, run plainly it is a world of one); ``event``
the Python event engine and ``native`` the C++ one, both on the host
(``--linkQueueing`` needs one of them). One tick is one link latency, and
every random model derives from ``--seed`` as in the JAX package, so the
same flags print the same report. ``--degreeBlock`` changes no result:
the CUDA gather has no degree block (the sharded engine's bucket planner
quantizes its rows by it, as the JAX package's does)."""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


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
    p.add_argument(
        "--backend", choices=("tpu", "sharded", "event", "native"),
        default="tpu",
        help="Execution engine: tpu = the device engine (default; the card, "
        "or --device cpu), sharded = the sharded flood engine (with --protocol, "
        "the sharded protocols) over a mesh of torch.distributed ranks (torchrun "
        "--nproc-per-node K; one rank when run plainly), event = the Python "
        "event engine, native = the C++ event engine (both on the host)",
    )
    p.add_argument(
        "--meshNodes", type=int, default=0,
        help="Node-axis shards for --backend sharded (default: all ranks)",
    )
    p.add_argument(
        "--meshShares", type=int, default=1,
        help="Share-axis shards for --backend sharded",
    )
    p.add_argument(
        "--ringMode", choices=("auto", "replicated", "sharded"),
        default="auto",
        help="History-ring layout for --backend sharded: replicated "
        "(full ring per rank, write-time all_gather) or sharded "
        "(per-rank rows, read-time slice all_gathers — fits rings the "
        "replicated layout can't). auto picks by delay model and size.",
    )
    p.add_argument(
        "--topology",
        choices=("er", "ba", "ring", "ws", "grid", "torus", "complete"),
        default="er",
        help="Topology family (er = reference's random topology; ws = "
        "Watts-Strogatz small-world; grid/torus = 2D lattice)",
    )
    p.add_argument(
        "--refParallelLinks", action="store_true",
        help="Model the reference's parallel-link REGISTER quirk: when a "
        "forced connectivity edge duplicates a sampled one, both endpoints "
        "list each other twice and every broadcast sends the duplicate an "
        "extra copy (dropped by its seen-set on arrival, so dynamics are "
        "unchanged). Reproduces the reference's inflated Total-sent and "
        "Peer-count numbers (p2pnetwork.cc:83,129; p2pnode.cc:186). er "
        "topology with the python graph builder only",
    )
    p.add_argument(
        "--graphBuilder", choices=("auto", "native", "python"),
        default="python",
        help="Graph construction for er/ba: the C++ builder (built from "
        "native/gossip_native.cc at first use) or numpy. The two draw from "
        "different random streams, so one --seed gives a different (equally "
        "valid) graph per builder. auto = native when the library builds. "
        "Use native for million-node graphs",
    )
    p.add_argument("--baM", type=int, default=3, help="Edges per node for --topology ba")
    p.add_argument("--wsK", type=int, default=4, help="Lattice degree for --topology ws")
    p.add_argument(
        "--wsBeta", type=float, default=0.1,
        help="Rewiring probability for --topology ws",
    )
    p.add_argument(
        "--gridCols", type=int, default=0,
        help="Columns for --topology grid/torus (default: ~sqrt(numNodes))",
    )
    p.add_argument(
        "--protocol", choices=("push", "pushpull", "pull", "pushk"),
        default="push",
        help="Gossip protocol: push flooding (reference), push-pull "
        "anti-entropy, pull-only anti-entropy, or fanout-limited push",
    )
    p.add_argument(
        "--fanout", type=int, default=2,
        help="Random neighbor picks per round for --protocol pushk",
    )
    p.add_argument(
        "--genModel", choices=("uniform", "poisson"), default="uniform",
        help="Share generation model (uniform = reference's U(genLo, genHi))",
    )
    p.add_argument("--genLo", type=float, default=2.0)
    p.add_argument("--genHi", type=float, default=5.0)
    p.add_argument("--poissonRate", type=float, default=0.3, help="shares/s/node")
    p.add_argument(
        "--delayModel",
        choices=("constant", "lognormal", "serialization"),
        default="constant",
        help="Per-edge delay model: constant (reference default), "
        "lognormal (heterogeneous links), or serialization (latency + "
        "message size / link bandwidth, the reference's 5 Mbps "
        "point-to-point links)",
    )
    p.add_argument("--delayMeanTicks", type=float, default=2.0)
    p.add_argument("--delaySigma", type=float, default=0.5)
    p.add_argument("--delayMaxTicks", type=int, default=8)
    p.add_argument(
        "--shareBytes", type=int, default=30,
        help="Message size for --delayModel serialization (the reference "
        "share struct is ~30 bytes on the wire)",
    )
    p.add_argument(
        "--bandwidthMbps", type=float, default=5.0,
        help="Link bandwidth for --delayModel serialization "
        "(reference: 5 Mbps, p2pnetwork.cc:113)",
    )
    p.add_argument(
        "--linkQueueing", action="store_true",
        help="FIFO link queueing (the reference's NS-3 DataRate queue, "
        "p2pnetwork.cc:113): concurrent messages on one link serialize "
        "through a per-link queue sized by --shareBytes / --bandwidthMbps, "
        "on top of the propagation delay model. --backend event|native "
        "with --protocol push only; not with --delayModel serialization",
    )
    p.add_argument(
        "--churnProb", type=float, default=0.0,
        help="Node churn: probability each node suffers a random outage "
        "(per outage slot; 0 disables churn). Down nodes lose arriving "
        "shares and skip generations.",
    )
    p.add_argument(
        "--lossProb", type=float, default=0.0,
        help="Per-link message loss probability: each directed link drops "
        "all messages crossing it during an erasure tick with this "
        "probability (0 disables). Deterministic in --seed.",
    )
    p.add_argument(
        "--churnDowntime", type=float, default=5.0,
        help="Mean outage duration in seconds (geometric, min one tick)",
    )
    p.add_argument(
        "--churnOutages", type=int, default=1,
        help="Maximum outages per node over the run",
    )
    p.add_argument(
        "--connectAtTick", type=int, default=0,
        help="Socket warm-up window: peers connect at this tick "
        "(reference: 5s, p2pnetwork.cc:93-96); shares generated earlier "
        "stay with their origin and charge no sends. 0 = connected at t0",
    )
    p.add_argument(
        "--statsInterval", type=float, default=10.0,
        help="Periodic stats interval in seconds",
    )
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--chunkSize", type=int, default=4096, help="Shares per device pass"
    )
    p.add_argument(
        "--degreeBlock", type=int, default=0,
        help="The JAX engine's degree-bucket block (0 = its default); "
        "changes no result: the CUDA gather has no degree block (the "
        "sharded engine's bucket planner quantizes by it)",
    )
    p.add_argument(
        "--perNodeStats", action="store_true", default=None,
        help="Print per-node lines (default: on for N <= 1000)",
    )
    p.add_argument(
        "--checkpoint", type=str, default="",
        help="Checkpoint file: save progress between share chunks and resume "
        "an interrupted run from it (the JAX package's file format)",
    )
    p.add_argument(
        "--checkpointEvery", type=int, default=1,
        help="Chunks between checkpoint writes (default 1)",
    )
    p.add_argument(
        "--floodCoverage", type=int, default=0, metavar="S",
        help="Coverage-time experiment instead of the gossip run: flood S "
        "shares from random origins at t=0 and report per-share "
        "time-to-99%% coverage",
    )
    p.add_argument(
        "--replicas", type=int, default=1, metavar="R",
        help="Monte-Carlo campaign: run R seed-ensemble replicas in batches "
        "through the same kernels (p2p_gossip_tpu_torch.batch) and report "
        "ensemble statistics (ttc percentiles, counter CIs) instead of one "
        "run's numbers. Replica r uses seed (--seed + r), including its own "
        "link-loss stream under --lossProb; composes with --floodCoverage, "
        "--protocol and --checkpoint",
    )
    p.add_argument(
        "--sweep", type=str, default="", metavar="SPEC.json",
        help="Run a campaign sweep from a JSON grid spec (axes over "
        "protocol/p/lossProb/churnProb/fanout x seeds), emitting one JSON "
        "line per cell plus a campaign report on stderr. Ignores the "
        "single-run flags; see examples/sweep_small.json",
    )
    p.add_argument(
        "--coverageFraction", type=float, default=0.99,
        help="Coverage fraction reported by --floodCoverage (default 0.99)",
    )
    p.add_argument(
        "--anim", type=str, default="",
        help="Write a NetAnim-style XML trace to this path",
    )
    p.add_argument(
        "--animMessages", action="store_true",
        help="Embed per-message packet events in the --anim trace (--backend "
        "event with --protocol push only)",
    )
    p.add_argument(
        "--log", type=str, default="",
        help="NS_LOG-style component log spec, e.g. "
        "'Engine.Event=debug:Engine.Sync=info' or '*=info' (also honors "
        "the P2P_LOG environment variable); lines go to stderr",
    )
    p.add_argument(
        "--graphFile", type=str, default="",
        help="npz graph cache: load the topology from this file if it "
        "exists, else build per --topology and save it (the JAX package's "
        "format: a file either package writes loads in the other)",
    )
    p.add_argument(
        "--json", action="store_true",
        help="Emit one machine-readable JSON line with config, totals, "
        "and wall time after the reference-format report",
    )
    p.add_argument(
        "--telemetry", type=str, default="", metavar="OUT.jsonl",
        help="Stream telemetry to this JSONL file: host spans "
        "(build_graph/schedule/simulate/dispatch/d2h phases) plus per-tick "
        "metric rows and state digests kept on the device and harvested at "
        "chunk boundaries (the JAX package's event schema). Also honors "
        "P2P_TELEMETRY=<path>. Off by default: disabled runs launch no "
        "extra kernel",
    )
    p.add_argument(
        "--heartbeat", type=str, default="", metavar="PATH",
        help="Atomically rewrite this liveness file on every chunk "
        "boundary: last chunk index, ticks done, coverage %%, digest head. "
        "Works with telemetry off. Also honors P2P_HEARTBEAT=<path>",
    )
    p.add_argument(
        "--device", default="cuda",
        help="torch device (default cuda; cpu runs the plain torch versions)",
    )
    return p


PARTNERED = ("pushpull", "pull", "pushk")


def _error(msg: str) -> int:
    print(f"error: {msg}", file=sys.stderr)
    return 2


def _pull_credit_error(g, chunk_size, sched) -> str | None:
    """The pull protocol's credit precondition as the JAX CLI's error
    message (None when it holds)."""
    from p2p_gossip_tpu_torch.models.protocols import (
        PullCreditBoundError,
        _check_pull_credit_bound,
    )

    try:
        _check_pull_credit_bound(g, chunk_size, sched)
    except PullCreditBoundError as e:
        return str(e)
    return None


def _run_protocol(args, g, sched, horizon, delays, churn, loss, **kw):
    """``--protocol pushpull|pull|pushk`` through the port's protocols, on
    the mesh under ``--backend sharded``; returns (stats, coverage or
    None)."""
    from p2p_gossip_tpu_torch.models.protocols import run_pushk_sim, run_pushpull_sim

    common = dict(
        ell_delays=delays, seed=args.seed, chunk_size=args.chunkSize,
        churn=churn, loss=loss, **kw,
    )
    if args.backend == "sharded":
        from p2p_gossip_tpu_torch.parallel.protocols_sharded import (
            run_sharded_partnered_sim,
        )

        out = run_sharded_partnered_sim(
            g, sched, horizon, args.mesh, protocol=args.protocol, fanout=args.fanout,
            ring_mode=args.ringMode, **common,
        )
        return out if kw.get("record_coverage") else (out, None)
    common["device"] = args.device
    if args.protocol == "pushk":
        return run_pushk_sim(g, sched, horizon, fanout=args.fanout, **common)
    return run_pushpull_sim(g, sched, horizon, mode=args.protocol, **common)


def _build_graph(args, use_native: bool):
    """The ``--topology`` graph (with the parallel-link extra under
    ``--refParallelLinks``, else None), or an error message."""
    from p2p_gossip_tpu_torch.models import topology as topo

    if args.topology in ("er", "ba") and use_native:
        from p2p_gossip_tpu_torch.runtime import native

        if args.topology == "er":
            return native.native_erdos_renyi(
                args.numNodes, args.connectionProb, seed=args.seed
            ), None
        return native.native_barabasi_albert(args.numNodes, m=args.baM, seed=args.seed), None
    if args.topology == "er":
        if args.refParallelLinks:
            return topo.erdos_renyi(
                args.numNodes, args.connectionProb, seed=args.seed,
                return_parallel_extra=True,
            )
        return topo.erdos_renyi(args.numNodes, args.connectionProb, seed=args.seed), None
    if args.topology == "ba":
        return topo.barabasi_albert(args.numNodes, m=args.baM, seed=args.seed), None
    if args.topology == "ws":
        return topo.watts_strogatz(
            args.numNodes, k=args.wsK, beta=args.wsBeta, seed=args.seed
        ), None
    if args.topology in ("grid", "torus"):
        if args.gridCols:
            cols = args.gridCols
        else:
            # Most-square factorization: first divisor at or below sqrt(n).
            cols = next(
                c for c in range(int(np.sqrt(args.numNodes)), 0, -1)
                if args.numNodes % c == 0
            )
        rows = -(-args.numNodes // cols)
        if rows * cols != args.numNodes:
            return (
                f"--numNodes {args.numNodes} is not rows*cols (cols={cols}); "
                "pass --gridCols"
            )
        return topo.grid_graph(rows, cols, torus=args.topology == "torus"), None
    if args.topology == "complete":
        return topo.complete_graph(args.numNodes), None
    return topo.ring_graph(args.numNodes), None


def _load_graph_file(args):
    """``--graphFile`` when the file exists: (graph, None), or (None, an
    error message); (None, None) when there is no file to load. The cache
    is keyed by the JAX CLI's fingerprint of every topology flag."""
    import os

    from p2p_gossip_tpu_torch.models.topology import load_graph_cache

    if not (args.graphFile and os.path.exists(args.graphFile)):
        return None, None
    try:
        graph, cached_fp = load_graph_cache(args.graphFile)
    except ValueError as e:
        return None, f"--graphFile {e}"
    if cached_fp is not None and cached_fp != _graph_fingerprint(args):
        return None, (
            f"--graphFile {args.graphFile} was built with different topology "
            "parameters; delete it or match the original flags"
        )
    if graph.n != args.numNodes:
        return None, (
            f"--graphFile holds a {graph.n}-node graph, --numNodes is "
            f"{args.numNodes}"
        )
    return graph, None


def _graph_fingerprint(args) -> str:
    from p2p_gossip_tpu_torch.utils.checkpoint import fingerprint

    return fingerprint(
        "topology", args.topology, args.numNodes, args.connectionProb,
        args.seed, args.baM, args.wsK, args.wsBeta, args.gridCols,
        args.graphBuilder,
    )


def _graph_flag_error(args, loaded) -> str | None:
    """The JAX CLI's refusals of ``--refParallelLinks`` and
    ``--graphBuilder`` combinations, in its order."""
    if args.refParallelLinks and (args.topology != "er" or loaded is not None):
        return (
            "--refParallelLinks needs a freshly built er topology (the quirk "
            "depends on which forced edges duplicate sampled ones in the "
            "builder's own sampling stream)"
        )
    if args.refParallelLinks and args.graphBuilder == "native":
        return (
            "--refParallelLinks requires --graphBuilder python (the native "
            "builder uses a different RNG stream)"
        )
    if args.refParallelLinks and args.protocol != "push":
        return (
            "--refParallelLinks models the reference's broadcast quirk; it "
            "only applies to --protocol push (flood)"
        )
    if args.refParallelLinks and args.connectAtTick:
        # with_parallel_links charges extra sends for every broadcast,
        # including warm-up ones the reference never sends.
        return (
            "--refParallelLinks cannot be combined with --connectAtTick (the "
            "quirk's reporting transform charges extra sends for warm-up "
            "broadcasts that the reference never sends)"
        )
    return None


def _link_queueing_error(args) -> str | None:
    """The JAX CLI's refusals of ``--linkQueueing``, in its order."""
    if args.backend not in ("event", "native"):
        return (
            "--linkQueueing requires --backend event|native (per-message "
            "engines; tick engines model serialization via --delayModel "
            "serialization)"
        )
    if args.protocol != "push":
        return (
            "--linkQueueing supports --protocol push only (the partnered "
            "protocols are round-based digests, not per-message transmissions)"
        )
    if args.delayModel == "serialization":
        return (
            "--linkQueueing is incompatible with --delayModel serialization "
            "(it would charge the serialization time twice); use constant or "
            "lognormal for the propagation part"
        )
    if args.shareBytes < 0 or args.bandwidthMbps <= 0:
        return "--shareBytes must be >= 0 and --bandwidthMbps > 0"
    return None


def _run_host_engine(args, g, sched, horizon, delays, churn, loss, snapshot_ticks, fifo):
    """``--backend event|native``: the Python or C++ event engine on the
    host (the protocols through their host legs)."""
    if args.backend == "native":
        from p2p_gossip_tpu_torch.runtime import native

        if args.protocol in PARTNERED:
            return native.run_native_partnered_sim(
                g, sched, horizon, protocol=args.protocol, fanout=args.fanout,
                ell_delays=delays, seed=args.seed, churn=churn, loss=loss,
            )
        return native.run_native_sim(
            g, sched, horizon, ell_delays=delays, snapshot_ticks=snapshot_ticks,
            churn=churn, loss=loss, connect_tick=args.connectAtTick, fifo_links=fifo,
        )
    from p2p_gossip_tpu_torch.engine import event

    if args.protocol in PARTNERED:
        return event.run_event_partnered_sim(
            g, sched, horizon, protocol=args.protocol, fanout=args.fanout,
            seed=args.seed, churn=churn, loss=loss,
        )
    return event.run_event_sim(
        g, sched, horizon, ell_delays=delays, snapshot_ticks=snapshot_ticks,
        churn=churn, loss=loss, record_messages=args.animMessages,
        connect_tick=args.connectAtTick, fifo_links=fifo,
    )


def _run_flood_coverage_cli(args, g, horizon, delays, churn, loss) -> int:
    """Coverage-time experiment: S shares from random origins at t=0,
    flooded or, with ``--protocol``, spread by that protocol; per-share
    time-to-``coverageFraction`` in ticks and seconds, the
    propagation-latency table and the redundancy line."""
    from p2p_gossip_tpu_torch import telemetry
    from p2p_gossip_tpu_torch.engine.sync import run_flood_coverage, time_to_coverage
    from p2p_gossip_tpu_torch.models.generation import Schedule
    from p2p_gossip_tpu_torch.utils.analysis import (
        format_propagation_report,
        message_redundancy,
        propagation_latency,
    )

    tick_dt = args.Latency / 1000.0
    rng = np.random.default_rng(args.seed)
    origins = rng.integers(0, g.n, args.floodCoverage).astype(np.int32)
    t0 = time.perf_counter()
    with telemetry.span("simulate", device=args.device, protocol=args.protocol,
                        experiment="flood_coverage"):
        if args.backend == "sharded":
            err = _print_mesh(args)
            if err is not None:
                return err
        if args.protocol in PARTNERED:
            sched = Schedule(g.n, origins, np.zeros(len(origins), dtype=np.int32))
            if args.protocol == "pull":
                err = _pull_credit_error(g, args.chunkSize, sched)
                if err is not None:
                    return _error(err)
            stats, coverage = _run_protocol(
                args, g, sched, horizon, delays, churn, loss, record_coverage=True
            )
        elif args.backend == "sharded":
            from p2p_gossip_tpu_torch.parallel.engine_sharded import (
                run_sharded_flood_coverage,
            )

            stats, coverage = run_sharded_flood_coverage(
                g, origins, horizon, args.mesh, ell_delays=delays,
                chunk_size=args.chunkSize, block=args.degreeBlock or None,
                churn=churn, loss=loss, ring_mode=args.ringMode,
            )
        else:
            stats, coverage = run_flood_coverage(
                g, origins, horizon, ell_delays=delays, churn=churn, loss=loss,
                device=args.device,
            )
    wall = time.perf_counter() - t0
    ttc = time_to_coverage(coverage, g.n, args.coverageFraction)
    reached = ttc >= 0
    print(
        f"=== {'Flood' if args.protocol == 'push' else args.protocol} "
        f"Coverage ({args.floodCoverage} shares, target "
        f"{args.coverageFraction:.0%} of {g.n} nodes) ==="
    )
    if reached.any():
        ticks = ttc[reached]
        print(
            f"Shares reaching target: {int(reached.sum())}/{len(ttc)}\n"
            f"Time to {args.coverageFraction:.0%} coverage: "
            f"min {ticks.min()} / median {int(np.median(ticks))} / "
            f"max {ticks.max()} ticks "
            f"({ticks.min() * tick_dt:g}s / {np.median(ticks) * tick_dt:g}s / "
            f"{ticks.max() * tick_dt:g}s)"
        )
    else:
        print(f"Shares reaching target: 0/{len(ttc)} within {horizon} ticks")
    print(
        f"Final coverage: min {coverage[-1].min()} / "
        f"mean {coverage[-1].mean():.1f} / max {coverage[-1].max()} nodes"
    )
    report = propagation_latency(coverage, g.n)
    print(format_propagation_report(report, tick_ms=args.Latency), end="")
    red = message_redundancy(stats)
    spd = red["sends_per_delivery"]  # None when nothing was delivered
    print(
        f"Redundancy: {'n/a' if spd is None else f'{spd:.2f}'} sends per "
        f"delivery ({red['wasted_fraction']:.1%} duplicate or lost)"
    )
    print(
        f"Simulated {horizon} ticks in {wall:.3f}s wall "
        f"({stats.totals()['processed'] / max(wall, 1e-9):.3g} node-updates/s)"
    )
    if args.json:
        print(json.dumps({
            "config": {
                "numNodes": g.n,
                "edges": int(g.num_edges),
                "protocol": args.protocol,
                "device": args.device,
                "shares": int(args.floodCoverage),
                "coverageFraction": args.coverageFraction,
                "Latency": args.Latency,
                "seed": args.seed,
            },
            "reached": int(reached.sum()),
            "ttc_ticks": {
                "min": int(ttc[reached].min()),
                "median": float(np.median(ttc[reached])),
                "max": int(ttc[reached].max()),
            } if reached.any() else None,
            "final_coverage": {
                "min": int(coverage[-1].min()),
                "mean": float(coverage[-1].mean()),
                "max": int(coverage[-1].max()),
            },
            "sends_per_delivery": spd,
            "wasted_fraction": red["wasted_fraction"],
            "wall_s": round(wall, 4),
        }))
    return 0


def _run_campaign_cli(args, g, horizon, delays, loss) -> int:
    """``--replicas R``: a seed-ensemble campaign. Replica r's schedule,
    churn and link-loss stream derive from seed (--seed + r) with the solo
    CLI's stream offsets (`models.seeds`), so any replica is the solo run
    ``--seed (--seed + r)``. Prints the JAX CLI's ensemble report."""
    from p2p_gossip_tpu_torch import telemetry
    from p2p_gossip_tpu_torch.batch.campaign import (
        flood_replicas,
        gossip_replicas,
        run_coverage_campaign,
        run_gossip_campaign,
        run_protocol_campaign,
    )
    from p2p_gossip_tpu_torch.batch.stats import ensemble_summary
    from p2p_gossip_tpu_torch.models.protocols import PullCreditBoundError
    from p2p_gossip_tpu_torch.models.seeds import replica_loss_seeds

    seeds = [args.seed + r for r in range(args.replicas)]
    loss_seeds = replica_loss_seeds(seeds) if loss is not None else None
    run_kw = dict(
        checkpoint_path=args.checkpoint or None,
        checkpoint_every=args.checkpointEvery,
        device=args.device,
    )
    churn_kw = dict(
        churn_prob=args.churnProb,
        mean_down_ticks=max(args.churnDowntime / (args.Latency / 1000.0), 1.0),
        max_outages=args.churnOutages,
    )
    with telemetry.span("replicas", count=args.replicas):
        if args.floodCoverage:
            replicas = flood_replicas(g, args.floodCoverage, seeds, horizon, **churn_kw)
        else:
            replicas = gossip_replicas(
                g, args.simTime, args.Latency / 1000.0, seeds, horizon,
                gen_lo=args.genLo, gen_hi=args.genHi, **churn_kw,
            )
    try:
        with telemetry.span("simulate", device=args.device, protocol=args.protocol,
                            experiment="campaign"):
            if args.protocol in PARTNERED:
                result = run_protocol_campaign(
                    g, replicas, horizon, protocol=args.protocol,
                    fanout=args.fanout, ell_delays=delays, loss=loss,
                    loss_seeds=loss_seeds,
                    record_coverage=bool(args.floodCoverage), **run_kw,
                )
            elif args.floodCoverage:
                result = run_coverage_campaign(
                    g, replicas, horizon, ell_delays=delays, loss=loss,
                    loss_seeds=loss_seeds, **run_kw,
                )
            else:
                result = run_gossip_campaign(
                    g, replicas, horizon, ell_delays=delays, loss=loss,
                    loss_seeds=loss_seeds, chunk_size=args.chunkSize, **run_kw,
                )
    except (PullCreditBoundError, NotImplementedError) as e:
        return _error(str(e))
    summary = ensemble_summary(result, args.coverageFraction)

    kind = f"{args.floodCoverage} flood shares" if args.floodCoverage else "gossip schedule"
    print(f"=== Campaign: {args.replicas} replicas x {kind}, {g.n} nodes ===")
    ttc = summary.get("ttc")
    if ttc is not None:
        ticks = ttc.get("ticks")
        if ticks:
            print(
                f"Time to {ttc['fraction']:.0%} coverage: mean "
                f"{ticks['mean']:.1f} / p50 {ticks['p50']:g} / p95 "
                f"{ticks['p95']:g} / p99 {ticks['p99']:g} ticks "
                f"(p99 {ticks['p99'] * args.Latency:g} ms); "
                f"{ttc['reached'] * 100:.1f}% of replica-shares reached"
            )
        else:
            print(
                f"Time to {ttc['fraction']:.0%} coverage: no replica-share "
                f"reached within {horizon} ticks"
            )
    for name in ("processed", "received", "sent"):
        c = summary["counters"][name]
        ci = c["ci95"]
        print(
            f"Total {name} per replica: mean {c['mean']:.1f}"
            + (f" (95% CI {ci[0]:.1f}-{ci[1]:.1f})" if ci else "")
        )
    red = summary["redundancy"]["sends_per_delivery"]
    if red:
        print(
            f"Redundancy: {red['mean']:.2f} sends per delivery "
            f"(p95 {red['p95']:.2f} across replicas)"
        )
    updates = summary["counters"]["processed"]["mean"] * args.replicas
    print(
        f"Campaign wall {result.wall_s:.3f}s (batch {result.batch_size}, "
        f"device {args.device}; {updates / max(result.wall_s, 1e-9):.3g} "
        "node-updates/s)"
    )
    if args.json:
        print(json.dumps({
            "config": {
                "numNodes": g.n,
                "edges": int(g.num_edges),
                "protocol": args.protocol,
                "device": args.device,
                "replicas": args.replicas,
                "floodCoverage": args.floodCoverage,
                "lossProb": args.lossProb,
                "churnProb": args.churnProb,
                "Latency": args.Latency,
                "seed": args.seed,
            },
            "summary": summary,
        }))
    return 0


def _run_sweep_cli(args) -> int:
    """``--sweep SPEC.json``: one JSON line per grid cell on stdout, the
    campaign report on stderr (the JAX CLI's sweep branch)."""
    import os

    from p2p_gossip_tpu_torch.batch.stats import format_campaign_report
    from p2p_gossip_tpu_torch.batch.sweep import run_sweep

    if not os.path.exists(args.sweep):
        return _error(f"--sweep {args.sweep} not found")
    with open(args.sweep, encoding="utf-8") as f:
        try:
            spec = json.load(f)
        except json.JSONDecodeError as e:
            return _error(f"--sweep {args.sweep}: {e}")
    try:
        records = run_sweep(
            spec, emit=lambda rec: print(json.dumps(rec), flush=True),
            device=args.device,
        )
    except ValueError as e:
        return _error(f"--sweep: {e}")
    print(format_campaign_report(records), end="", file=sys.stderr)
    return 0


def _print_mesh(args) -> int | None:
    """Build the ``--meshNodes`` x ``--meshShares`` mesh into ``args.mesh``
    and print the JAX CLI's mesh line. Returns the exit code when this
    rank is done: 2 when the mesh does not fit the world (the JAX CLI dies
    with a traceback there), 0 on a rank the mesh leaves out (it idles,
    as a device outside a JAX mesh does)."""
    from p2p_gossip_tpu_torch.parallel.mesh import make_mesh

    try:
        args.mesh = make_mesh(args.meshNodes or None, args.meshShares,
                              device=args.mesh_device)
    except ValueError as e:
        return _error(f"--meshNodes/--meshShares: {e}")
    if args.mesh.coordinate is None:
        return 0
    print(
        f"Mesh: {args.mesh.shape['shares']} share-shards x "
        f"{args.mesh.shape['nodes']} node-shards"
    )
    return None


def run(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.backend != "sharded":
        return _run(args)
    # SPMD: every rank runs the whole CLI (each collective needs them
    # all) and rank 0 prints the report. Run plainly, a world of one.
    import contextlib
    import io

    import torch.distributed as dist

    from p2p_gossip_tpu_torch.parallel.mesh import initialize_multihost, local_device

    try:
        args.mesh_device = local_device(None if args.device == "cuda" else args.device)
    except (RuntimeError, ValueError) as e:
        return _error(f"--device: {e}")
    owned = not dist.is_initialized()
    rank, _ = initialize_multihost(device=args.mesh_device)
    if rank:  # rank 0 writes the files; the ranks agree on telemetry's rings
        args.telemetry = args.heartbeat = args.anim = ""
    quiet = contextlib.redirect_stdout(io.StringIO()) if rank else contextlib.nullcontext()
    try:
        with quiet:
            return _run(args)
    finally:
        if owned:
            dist.destroy_process_group()


def _run(args) -> int:
    from p2p_gossip_tpu_torch import telemetry
    from p2p_gossip_tpu_torch.engine.sync import run_sync_sim
    from p2p_gossip_tpu_torch.models.churn import random_churn
    from p2p_gossip_tpu_torch.models.generation import (
        poisson_schedule,
        uniform_renewal_schedule,
    )
    from p2p_gossip_tpu_torch.models.latency import (
        fifo_link_model,
        lognormal_delays,
        lognormal_edge_delays,
        serialization_ticks,
    )
    from p2p_gossip_tpu_torch.models.linkloss import LinkLossModel
    from p2p_gossip_tpu_torch.models.seeds import churn_stream_seed, loss_stream_seed
    from p2p_gossip_tpu_torch.utils import logging as p2plog
    from p2p_gossip_tpu_torch.utils.stats import format_final_statistics

    # Refused only where the JAX CLI dies with a traceback; --numNodes 1 and
    # a negative --simTime run there (an all-zero report) and run here too.
    if args.numNodes < 1 or args.Latency <= 0 or args.chunkSize < 1:
        return _error("--numNodes must be >= 1, --Latency > 0, --chunkSize >= 1")
    tick_dt = args.Latency / 1000.0
    if args.log:
        try:
            p2plog.configure(args.log)
        except ValueError as e:
            return _error(f"--log: {e}")
    p2plog.set_time_resolution(tick_dt)
    if args.telemetry:
        # The flag wins over P2P_TELEMETRY (configure replaces an
        # environment-initialized stream).
        try:
            telemetry.configure(args.telemetry, rings=True)
        except OSError as e:
            return _error(f"--telemetry: {e}")
    if args.heartbeat:
        telemetry.configure_heartbeat(args.heartbeat)  # wins over P2P_HEARTBEAT
    horizon = int(round(args.simTime / tick_dt))
    if args.sweep:
        return _run_sweep_cli(args)

    loaded, err = _load_graph_file(args)
    if err is None:
        err = _graph_flag_error(args, loaded)
    if err is not None:
        return _error(err)
    use_native = False
    if (loaded is None and args.graphBuilder != "python"
            and args.topology in ("er", "ba") and not args.refParallelLinks):
        from p2p_gossip_tpu_torch.runtime import native

        use_native = native.available()
        if args.graphBuilder == "native" and not use_native:
            return _error(
                "--graphBuilder native: the native library is not built (run "
                "`make -C native`)"
            )
    elif args.graphBuilder == "native" and loaded is None:
        # A warm --graphFile cache needs no builder at all.
        return _error(
            f"--graphBuilder native has no {args.topology} builder (only er/ba)"
        )
    parallel_extra = None
    with telemetry.span("build_graph", topology=args.topology):
        if loaded is not None:
            g = loaded
        else:
            built = _build_graph(args, use_native)
            if isinstance(built, str):
                return _error(built)
            g, parallel_extra = built
            if args.graphFile:
                from p2p_gossip_tpu_torch.models.topology import save_graph_cache

                save_graph_cache(args.graphFile, g, fp=_graph_fingerprint(args))
    with telemetry.span("schedule", model=args.genModel):
        if args.genModel == "uniform":
            sched = uniform_renewal_schedule(
                g.n, args.simTime, tick_dt, args.genLo, args.genHi, seed=args.seed
            )
        else:
            sched = poisson_schedule(
                g.n, args.simTime, tick_dt, args.poissonRate, seed=args.seed
            )

    # The device engine's random-partner protocols take one delay per CSR
    # entry (their picks index the CSR row); the flood, the sharded and
    # the host engines take the (N, dmax) ELL layout.
    per_entry = args.protocol in PARTNERED and args.backend == "tpu"
    delays = None
    if args.delayModel == "lognormal":
        draw = lognormal_edge_delays if per_entry else lognormal_delays
        delays = draw(
            g, args.delayMeanTicks, args.delaySigma, args.delayMaxTicks,
            seed=args.seed,
        )
    elif args.delayModel == "serialization":
        if args.shareBytes < 0 or args.bandwidthMbps <= 0:
            return _error("--shareBytes must be >= 0 and --bandwidthMbps > 0")
        ticks = serialization_ticks(
            message_bytes=args.shareBytes,
            bandwidth_mbps=args.bandwidthMbps, tick_dt=tick_dt,
        )
        shape = g.indices.shape if per_entry else (g.n, g.ell_width)
        delays = np.full(shape, ticks, dtype=np.int32)
        print(
            f"serialization delay model: {args.shareBytes} B at "
            f"{args.bandwidthMbps:g} Mbps on {args.Latency:g} ms latency "
            f"-> {ticks} tick(s)/hop",
            file=sys.stderr,
        )
    fifo = None
    if args.linkQueueing:
        err = _link_queueing_error(args)
        if err is not None:
            return _error(err)
        fifo = fifo_link_model(
            message_bytes=args.shareBytes, bandwidth_mbps=args.bandwidthMbps,
            tick_dt=tick_dt,
        )
        print(
            f"FIFO link queueing: {args.shareBytes} B at "
            f"{args.bandwidthMbps:g} Mbps -> {fifo.ser_micro} micro-ticks "
            "serialization per message per link",
            file=sys.stderr,
        )

    if args.degreeBlock < 0:
        return _error("--degreeBlock must be >= 0")
    if args.meshNodes < 0 or args.meshShares < 1:
        return _error("--meshNodes must be >= 0 and --meshShares >= 1")
    loss = None
    if not 0.0 <= args.lossProb <= 1.0:
        return _error(f"--lossProb must be in [0, 1], got {args.lossProb:g}")
    if args.lossProb > 0.0:
        loss = LinkLossModel(args.lossProb, seed=loss_stream_seed(args.seed))
    churn = None
    if not 0.0 <= args.churnProb <= 1.0:
        return _error(f"--churnProb must be in [0, 1], got {args.churnProb:g}")
    if args.churnProb > 0.0:
        churn = random_churn(
            g.n, horizon,
            outage_prob=args.churnProb,
            mean_down_ticks=max(args.churnDowntime / tick_dt, 1.0),
            max_outages=args.churnOutages,
            seed=churn_stream_seed(args.seed),
        )

    # The JAX CLI names the er/ba construction on the start line.
    if loaded is not None:
        graph_note = ", graph-builder=cache"
    elif args.topology in ("er", "ba"):
        graph_note = f", graph-builder={'native' if use_native else 'python'}"
    else:
        graph_note = ""
    engine = f"device={args.device}" if args.backend == "tpu" else f"backend={args.backend}"
    print(
        f"Starting gossip network simulation: {g.n} nodes, "
        f"{g.num_edges} links, {sched.num_shares} shares scheduled, "
        f"{horizon} ticks ({args.simTime:g}s at {args.Latency:g}ms), "
        f"{engine}{graph_note}"
    )
    if churn is not None:
        n_outages = int((churn.down_end > churn.down_start).sum())
        print(
            f"Churn enabled: {n_outages} outages scheduled across {g.n} "
            f"nodes (mean downtime {args.churnDowntime:g}s)"
        )
    interval_ticks = int(round(args.statsInterval / tick_dt))
    snapshot_ticks = (
        list(range(interval_ticks, horizon, interval_ticks))
        if interval_ticks > 0
        else []
    )

    if args.protocol == "pushk" and args.fanout < 1:
        return _error("--fanout must be >= 1")
    if args.connectAtTick < 0:
        return _error(f"--connectAtTick must be >= 0, got {args.connectAtTick}")
    if args.connectAtTick and (args.protocol != "push" or args.floodCoverage):
        return _error(
            "--connectAtTick supports only --protocol push without "
            "--floodCoverage (the warm-up window is a flood-gossip "
            "reference semantic)"
        )
    if args.animMessages and not (
        args.anim and args.backend == "event" and args.protocol == "push"
        and not args.floodCoverage
    ):
        return _error(
            "--animMessages requires --anim with --backend event and "
            "--protocol push (per-message recording lives in the exact event "
            "path)"
        )
    if args.replicas < 1:
        return _error(f"--replicas must be >= 1, got {args.replicas}")
    if args.replicas > 1 and args.backend != "tpu":
        return _error(
            "--replicas requires --backend tpu (the vmapped campaign engine; "
            "use --sweep for other-backend ensembles)"
        )
    if args.replicas > 1 and args.anim:
        return _error(
            "--replicas does not support --anim (per-replica artifacts are "
            "a sweep-runner concern)"
        )
    if args.replicas > 1 and not args.floodCoverage and args.genModel != "uniform":
        return _error(
            "--replicas without --floodCoverage supports --genModel uniform only"
        )
    if args.floodCoverage:
        if args.floodCoverage < 0:
            return _error(
                f"--floodCoverage must be positive, got {args.floodCoverage}"
            )
        if args.backend not in ("tpu", "sharded"):
            return _error("--floodCoverage requires --backend tpu|sharded")
        if not 0.0 < args.coverageFraction <= 1.0:
            return _error(
                "--coverageFraction must be in (0, 1], got "
                f"{args.coverageFraction:g}"
            )
        if args.replicas > 1:
            return _run_campaign_cli(args, g, horizon, delays, loss)
        return _run_flood_coverage_cli(args, g, horizon, delays, churn, loss)
    if (args.protocol in PARTNERED and args.backend == "event"
            and args.delayModel != "constant"):
        return _error(
            f"--protocol {args.protocol} --backend event supports only "
            "--delayModel constant (the numpy oracle is the one-tick-delay "
            "specification)"
        )
    if args.checkpoint and args.backend not in ("tpu", "sharded"):
        return _error("--checkpoint requires --backend tpu|sharded")
    if args.checkpointEvery < 1:
        return _error("--checkpointEvery must be >= 1")
    if args.protocol == "pull" and args.backend in ("tpu", "sharded"):
        # Only the bitmask engines carry the uint32 credit accumulator; the
        # event and native engines accumulate sent in int64.
        err = _pull_credit_error(g, args.chunkSize, sched)
        if err is not None:
            return _error(err)
    if args.replicas > 1:
        return _run_campaign_cli(args, g, horizon, delays, loss)

    t0 = time.perf_counter()
    ckpt = dict(
        checkpoint_path=args.checkpoint or None, checkpoint_every=args.checkpointEvery
    )
    with telemetry.span("simulate", device=args.device, protocol=args.protocol,
                        backend=args.backend):
        if args.backend == "sharded":
            err = _print_mesh(args)
            if err is not None:
                return err
        if args.backend in ("tpu", "sharded") and args.protocol in PARTNERED:
            stats, _ = _run_protocol(args, g, sched, horizon, delays, churn, loss, **ckpt)
        elif args.backend == "sharded":
            from p2p_gossip_tpu_torch.parallel.engine_sharded import run_sharded_sim

            stats = run_sharded_sim(
                g, sched, horizon, args.mesh, ell_delays=delays,
                chunk_size=args.chunkSize, block=args.degreeBlock or None,
                churn=churn, snapshot_ticks=snapshot_ticks, loss=loss,
                connect_tick=args.connectAtTick, ring_mode=args.ringMode, **ckpt,
            )
        elif args.backend != "tpu":
            stats = _run_host_engine(
                args, g, sched, horizon, delays, churn, loss, snapshot_ticks, fifo
            )
        else:
            stats = run_sync_sim(
                g, sched, horizon, ell_delays=delays, chunk_size=args.chunkSize,
                churn=churn, snapshot_ticks=snapshot_ticks, loss=loss,
                connect_tick=args.connectAtTick, device=args.device, **ckpt,
            )
    wall = time.perf_counter() - t0
    if parallel_extra is not None:
        # A reporting transform: the duplicate copies never change the
        # dynamics (NodeStats.with_parallel_links).
        stats = stats.with_parallel_links(parallel_extra)
        print(
            f"parallel-link quirk: {int(parallel_extra.sum()) // 2} doubled "
            f"pair(s) across {int((parallel_extra > 0).sum())} node(s)",
            file=sys.stderr,
        )
    # Periodic reports (PrintPeriodicStats, p2pnetwork.cc:201-204); the
    # protocols keep no snapshots, as in the JAX package.
    for snap in stats.extra.get("snapshots", []):
        avg = snap["processed"] // max(g.n, 1)
        print(
            f"=== Periodic Stats at {snap['tick'] * tick_dt:g}s ===\n"
            f"Total shares generated: {snap['generated']}\n"
            f"Average shares per node: {avg}\n"
            f"Total socket connections: {snap['connections']}"
        )
    per_node = args.perNodeStats if args.perNodeStats is not None else g.n <= 1000
    totals = stats.totals()
    print(format_final_statistics(stats, per_node=per_node), end="")
    # The JAX sharded engine reports no executed-tick count.
    executed = None if args.backend == "sharded" else stats.extra.get("ticks_executed")
    print(
        f"Simulated {args.simTime:g}s ({horizon} ticks"
        f"{'' if executed is None else f', {executed} executed'}) in {wall:.3f}s "
        f"wall ({totals['processed'] / max(wall, 1e-9):.3g} node-updates/s)"
    )
    if args.json:
        print(json.dumps({
            "config": {
                "numNodes": g.n,
                "edges": int(g.num_edges),
                "topology": args.topology,
                "protocol": args.protocol,
                "backend": args.backend,
                "device": args.device,
                "simTime": args.simTime,
                "Latency": args.Latency,
                "seed": args.seed,
            },
            "totals": totals,
            "wall_s": round(wall, 4),
            "node_updates_per_s": round(totals["processed"] / max(wall, 1e-9), 1),
        }))
    if args.anim:
        from p2p_gossip_tpu_torch.utils.anim import write_animation_xml

        write_animation_xml(
            g, args.anim, tick_dt=tick_dt, messages=stats.extra.get("messages")
        )
        print(f"NetAnim trace written to {args.anim}")
    return 0


def main() -> None:
    sys.exit(run())
