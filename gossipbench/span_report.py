"""The program's spans in one cell, read from the profiler:

    python3 -m gossipbench.span_report --workload NAME --seed N --seconds S

sets the cell up as a run does, with the program's spans on from its
staging, then profiles S seconds of simulations (``torch.profiler``, the
telemetry sink on with its device rings off, as in a traced run) and
prints one JSON line: each span's count, total and self seconds; the
device time credited to the innermost span open at each launch
(`program_spans.Attribution`); and the quantities these give a tick, a
simulation and the staging. ``--device cpu`` runs on the CPU (no device
operation to credit), for the tests.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from gossipbench import harness, program_spans, spec


def _busy(device):
    out = []
    for s, e, _, _ in sorted(device):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return sum(e - s for s, e in out)


def _top(seconds: dict, k: int = 8) -> list:
    return sorted(seconds.items(), key=lambda kv: -kv[1])[:k]


def _clock_offsets(att, sink_events, epoch):
    """How far the offset between the two clocks moves over the window,
    in milliseconds: the profiler's start of each ``tick`` less the
    sink's (``time.perf_counter``), last tick less first, and the range.
    A span moved onto the profiler's clock by one offset strays by as
    much."""
    prof = [att.base_ns * 1e-9 + s for s, _, name in att.spans if name == "tick"]
    pc = sorted(epoch + e["ts"] for e in sink_events if e["name"] == "tick")
    if not prof or len(prof) != len(pc):
        return None
    off = [(a - b) * 1e3 for a, b in zip(prof, pc)]
    return {"last_less_first": off[-1] - off[0], "max_less_min": max(off) - min(off)}


def measure(cell: spec.Cell, seed: int, seconds: float, device: torch.device) -> dict:
    from p2p_gossip_tpu_torch.telemetry import sink

    entry = spec.entry(cell.entry)
    n = int(cell.config["graph"]["n"])
    ctx = entry.prepare(device, cell.config)
    edges = harness.graph_edges(cell.config, seed, write=False)
    sink.configure(None, rings=False)
    try:
        t = time.perf_counter()
        staged = entry.stage(ctx, n, edges)
        harness._sync(device)
        stage_s = time.perf_counter() - t
        staging = program_spans.seconds_by_name(program_spans.sink_spans())
        entry.run(staged, *harness.draw(cell, seed, harness._WARM), cell.traffic)
        harness._sync(device)
        sink.configure(None, rings=False)
        epoch = sink.epoch()
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        sims = ticks = 0
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < seconds:
                result = entry.run(staged, *harness.draw(cell, seed, harness._SIM, sims),
                                   cell.traffic)
                ticks += int(entry.ticks(result, staged, cell.traffic))
                sims += 1
            harness._sync(device)
            window_s = time.perf_counter() - t0
        sink_events = program_spans.sink_spans()
    finally:
        sink.close()
    entry.release(staged)
    att = program_spans.Attribution(prof.profiler.kineto_results.events())
    totals = att.span_totals()
    by_span = att.device_by_span()
    busy = _busy(att.device)
    under = [None if k is None else att.spans[k][2] for k in att.innermost()]
    gather_or = [u for (_, _, name, _), u in zip(att.device, under) if "gather_or" in name]
    ok, checked = att.sync_after_tick_work()
    span_s = {k: v[1] for k, v in totals.items()}
    per_tick = (lambda s: s * 1e3 / ticks) if ticks else (lambda s: None)
    return {
        "cell": cell.name, "seed": seed, "device": device.type,
        "sims": sims, "ticks": ticks, "window_s": window_s, "busy_s": busy,
        "tick_spans": totals.get("tick", [0])[0],
        "stage_s": stage_s, "stage_csr_s": staging.get("stage.csr"),
        "stage_buckets_s": staging.get("stage.buckets"),
        "gather_ms_per_tick": per_tick(by_span.get("gather", 0.0)),
        "update_ms_per_tick": per_tick(by_span.get("update", 0.0)),
        "tick_host_ms": per_tick(span_s.get("tick", 0.0) - span_s.get("sync", 0.0)),
        "entry_host_ms_per_sim": (sum(span_s.get(k, 0.0) for k in ("inputs", "d2h", "stats"))
                                  * 1e3 / sims) if sims else None,
        "unattributed_share_of_busy": by_span.get("unattributed", 0.0) / busy if busy else None,
        "gather_or_launches": len(gather_or),
        "gather_or_under_gather": gather_or.count("gather"),
        "sync_after_tick_work": [ok, checked],
        "sync_margin_us_by_tenth": [None if m is None else m * 1e6
                                    for m in att.sync_margin_by_tenth()],
        "sink_clock_offset_ms": _clock_offsets(att, sink_events, epoch),
        "spans": totals,
        "device_by_span": by_span,
        "ops_by_span": {k: _top(att.ops_by_span(k)) for k in by_span if k != "unattributed"},
        "host_calls_by_span": {k: _top(att.host_calls_by_span(k)) for k in totals},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="gossipbench.span_report")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--root", default=None, help="folder of BENCHMARK.json (tests)")
    args = ap.parse_args(argv)
    torch.set_num_threads(4)
    device = torch.device("cuda", 0) if args.device == "cuda" else torch.device("cpu")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    cell = spec.cell(args.workload, root=args.root or spec.ROOT)
    print(json.dumps(measure(cell, args.seed, args.seconds, device)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
