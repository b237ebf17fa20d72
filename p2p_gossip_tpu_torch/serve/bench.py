"""Serving benchmark — a mixed request trace through one gossip server (the
counterpart of the JAX package's ``scripts/serve_bench.py`` on one device).

A deterministic trace (two topologies x the four protocols, plus a lossy
and a churn flood, replica counts cycling 1/2/4, globally unique replica
seeds) is submitted to one `GossipServer` and drained. Printed first:
requests/s, p50/p99 turnaround, mean slot occupancy, dispatches and wall
per dispatch. Unless ``--no-verify``, every request's counters and
coverage are then re-derived by a solo port campaign with its seeds
(`batch.campaign`, one request at a time, a protocol's shares in one
pass) and compared bitwise — the
server's contract (slot placement and batch composition are semantically
inert); a mismatch fails the run. The last line is one JSON object.

    python -m p2p_gossip_tpu_torch.serve.bench [--requests 24] [--slots 8]
        [--nodes 100000] [--shares 4096] [--horizon 64] [--seed 0]
        [--smoke] [--no-verify] [--device cuda|cpu] [--out FILE] [--mesh]

The defaults are the full-width trace (ER N = 100,000 p = 0.001 and BA
m = 3, 4,096 shares, horizon 64); ``--device cpu --smoke`` is the tests'
size (N = 128, 4 shares, horizon 16, 12 requests).

``--mesh`` serves on `parallel.mesh.make_slot_mesh` over every rank of the
world (`initialize_multihost`): under ``torchrun --nproc-per-node K`` the
K ranks (NCCL; gloo with ``--device cpu``), as one process a 1 x 1 mesh.
Every rank drains the trace; the first verifies and prints, and the JSON
line gains ``"mesh": "RxN"`` (replica shards x node shards).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

# Mean degree of the trace's Erdős–Rényi topology: p = 0.001 at N = 100,000.
ER_MEAN_DEGREE = 100
SMOKE = dict(requests=12, nodes=128, shares=4, horizon=16, mean_degree=8)
REPLICA_CYCLE = (1, 2, 4)


def topologies(nodes: int, mean_degree: float = ER_MEAN_DEGREE) -> list[dict]:
    """The trace's two topologies: Erdős–Rényi with ``mean_degree`` and
    Barabási–Albert m = 3, both from seed 0."""
    return [
        {"family": "erdos_renyi", "n": nodes, "p": min(1.0, mean_degree / nodes), "seed": 0},
        {"family": "barabasi_albert", "n": nodes, "m": 3, "seed": 0},
    ]


def build_trace(requests: int, seed: int = 0, nodes: int = 100_000, shares: int = 4096,
                horizon: int = 64, mean_degree: float = ER_MEAN_DEGREE) -> list[dict]:
    """Deterministic mixed trace: round-robin over the scenarios (each
    topology x flood, pushpull, pull, pushk with fanout 2; a flood at
    ``loss_prob`` 0.05 and one under churn on the first topology) with
    replica counts cycling 1/2/4 and globally unique replica seeds from
    ``seed``, so every request is distinct work."""
    topos = topologies(nodes, mean_degree)
    scenarios = [{"topology": t, "protocol": p}
                 for t in topos for p in ("flood", "pushpull", "pull", "pushk")]
    scenarios.append({"topology": topos[0], "protocol": "flood", "loss_prob": 0.05})
    scenarios.append({"topology": topos[0], "protocol": "flood", "churn_prob": 0.1,
                      "mean_down_ticks": 4.0})
    trace, next_seed = [], int(seed)
    for i in range(requests):
        reps = REPLICA_CYCLE[i % len(REPLICA_CYCLE)]
        trace.append({
            "request_id": f"req-{i:04d}", "shares": shares, "horizon": horizon,
            "seeds": list(range(next_seed, next_seed + reps)), "fanout": 2,
            **scenarios[i % len(scenarios)],
        })
        next_seed += reps
    return trace


def solo_result(request_dict: dict, graph, device):
    """The solo port campaign of one request: its replicas in one batch,
    with its seeds, loss and churn; a protocol's shares in one pass (the
    server's dispatches pass 128 shares at a time, and results do not
    depend on the pass width, so the check holds the chunking too, in
    1/32 of the rounds at 4,096 shares)."""
    from p2p_gossip_tpu_torch.batch.campaign import (
        flood_replicas,
        run_coverage_campaign,
        run_protocol_campaign,
    )
    from p2p_gossip_tpu_torch.models.linkloss import LinkLossModel
    from p2p_gossip_tpu_torch.models.seeds import replica_loss_seeds
    from p2p_gossip_tpu_torch.serve.request import SimRequest

    req = SimRequest.from_dict(request_dict)
    replicas = flood_replicas(
        graph, req.shares, list(req.seeds), req.horizon, churn_prob=req.churn_prob,
        mean_down_ticks=req.mean_down_ticks, max_outages=req.max_outages,
    )
    loss = LinkLossModel(req.loss_prob) if req.loss_prob > 0 else None
    lseeds = replica_loss_seeds(list(req.seeds)) if loss else None
    if req.protocol == "flood":
        return run_coverage_campaign(graph, replicas, req.horizon, loss=loss,
                                     loss_seeds=lseeds, device=device)
    return run_protocol_campaign(graph, replicas, req.horizon, protocol=req.protocol,
                                 fanout=req.fanout, record_coverage=True, loss=loss,
                                 loss_seeds=lseeds, chunk_size=req.shares, device=device)


RESULT_FIELDS = ("generated", "received", "sent", "coverage")


def same_result(got, want) -> bool:
    """Bitwise equality of the per-replica counters and coverage rows
    (values, not dtypes: the server accumulates int64 coverage)."""
    return all(np.array_equal(np.asarray(getattr(got, f)), np.asarray(getattr(want, f)))
               for f in RESULT_FIELDS)


def run_trace(trace: list[dict], slots: int = 8, device=None, graphs: dict | None = None,
              log=print, mesh=None, exchange: str = "dense", on_step=None):
    """Submit every request of ``trace`` to one fresh `GossipServer` on
    ``device`` (or on ``mesh`` with its ``exchange``: every rank of the
    mesh calls this) and drain it. ``graphs`` (topology fingerprint ->
    Graph) pre-fills the server's graph cache, for a caller that built a
    trace graph already; ``on_step`` sees each dispatch's summary. Returns
    (server, summary dict); raises if a request did not finish."""
    from p2p_gossip_tpu_torch.serve.server import GossipServer

    if mesh is not None:
        server = GossipServer(slots=slots, mesh=mesh, exchange=exchange)
    else:
        server = GossipServer(slots=slots, device=device)
    server._graphs.update(graphs or {})
    t0 = time.perf_counter()
    for request_dict in trace:
        server.submit(request_dict)
    walls = []
    while (summary := server.step()) is not None:
        walls.append(summary["wall_s"])
        if on_step is not None:
            on_step(summary)
    wall = time.perf_counter() - t0
    turnarounds = []
    for request_dict in trace:
        state = server._states[request_dict["request_id"]]
        if state.status != "done":
            raise RuntimeError(f"request {request_dict['request_id']} ended {state.status}")
        turnarounds.append(state.turnaround_s)
    signatures = len({s.request.signature_key() for s in server._states.values()})
    summary = {
        "requests": len(trace), "signatures": signatures, "slots": slots,
        "dispatches": len(walls), "wall_s": wall,
        "requests_per_s": len(trace) / wall,
        "p50_turnaround_s": float(np.percentile(turnarounds, 50)),
        "p99_turnaround_s": float(np.percentile(turnarounds, 99)),
        "slot_occupancy": server.slot_occupancy(),
        "ms_per_dispatch": 1e3 * float(np.mean(walls)) if walls else 0.0,
    }
    log(f"serve: {len(trace)} requests ({signatures} signatures) in {len(walls)} dispatches "
        f"of {slots} slots, {wall:.3f} s -> {summary['requests_per_s']:.3f} requests/s")
    log(f"serve: turnaround p50 {summary['p50_turnaround_s']:.4f} s, p99 "
        f"{summary['p99_turnaround_s']:.4f} s; mean slot occupancy "
        f"{summary['slot_occupancy']:.4f}; {summary['ms_per_dispatch']:.2f} ms a dispatch")
    return server, summary


def verify(server, trace: list[dict], log=print) -> int:
    """Hold every request's result against its solo port campaign on the
    server's device; returns the number of mismatches."""
    bad = 0
    for request_dict in trace:
        rid = request_dict["request_id"]
        graph = server._graph(server._states[rid].request)
        if not same_result(server.result(rid), solo_result(request_dict, graph, server.device)):
            bad += 1
            log(f"serve: BITWISE MISMATCH on {rid}")
    log(f"serve: verified {len(trace)} requests against solo campaigns: "
        f"{'bitwise equal' if not bad else f'{bad} mismatches'}")
    return bad


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--nodes", type=int, default=100_000)
    ap.add_argument("--shares", type=int, default=4096)
    ap.add_argument("--horizon", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true",
                    help="the tests' size: 12 requests, N = 128, 4 shares, horizon 16")
    ap.add_argument("--no-verify", action="store_true",
                    help="skip the per-request solo bitwise comparison")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", help="also append the JSON line to FILE")
    ap.add_argument("--mesh", action="store_true",
                    help="serve on make_slot_mesh(--slots) over every rank of the world")
    args = ap.parse_args(argv)
    size = dict(requests=args.requests, nodes=args.nodes, shares=args.shares,
                horizon=args.horizon, mean_degree=ER_MEAN_DEGREE)
    if args.smoke:
        size = dict(SMOKE, requests=min(args.requests, SMOKE["requests"]))

    import torch

    from p2p_gossip_tpu_torch.utils.device import resolve_device

    mesh, first = None, True
    if args.mesh:
        from p2p_gossip_tpu_torch.parallel.mesh import (
            initialize_multihost,
            local_device,
            make_slot_mesh,
        )

        device = local_device(None if args.device == "cuda" else args.device)
        rank, _ = initialize_multihost(device=device)
        first = rank == 0
        if not first:  # the first rank writes; the ranks agree on telemetry's rings
            for var in ("P2P_TELEMETRY", "P2P_HEARTBEAT"):
                os.environ.pop(var, None)
        mesh = make_slot_mesh(args.slots, device=device)
    else:
        device = resolve_device(args.device)
    out = print if first else (lambda *a, **k: None)
    trace = build_trace(size["requests"], args.seed, size["nodes"], size["shares"],
                        size["horizon"], size["mean_degree"])
    kind = "cpu" if device.type == "cpu" else torch.cuda.get_device_name(device)
    shape = None if mesh is None else "x".join(str(v) for v in mesh.shape.values())
    out(f"serve bench: {len(trace)} requests, slots={args.slots}, N={size['nodes']}, "
        f"{size['shares']} shares, horizon {size['horizon']} on {kind}"
        + (f", mesh {shape} (replicas x nodes)" if mesh is not None else ""), flush=True)
    server, summary = run_trace(trace, args.slots, device, log=out, mesh=mesh)
    bad = None if args.no_verify or not first else verify(server, trace, log=out)
    row = {"bench": "serve", "device": kind, "smoke": bool(args.smoke),
           "nodes": size["nodes"], "shares": size["shares"], "horizon": size["horizon"],
           **({"mesh": shape} if mesh is not None else {}),
           **summary, "verified": 0 if bad is None else len(trace),
           "bitwise_ok": None if bad is None else bad == 0}
    line = json.dumps(row)
    out(line)
    if args.out and first:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0 if not bad else 1


if __name__ == "__main__":
    sys.exit(main())
