"""Chrome-trace (Trace Event Format) exporter — open a telemetry stream
in ``chrome://tracing`` or https://ui.perfetto.dev.

Two timelines, two pids:

- pid 1 ``host`` — every span as a complete ("ph": "X") event, ts/dur
  in microseconds on the run's monotonic clock. Nesting renders from
  the timestamps alone, exactly as the spans nested.
- pid 2 ``device ticks`` — every ring column as a counter ("ph": "C")
  series, one sample per simulated tick, with the TICK INDEX as the
  microsecond timestamp. Ticks are harvested once a chunk and carry no
  wall-clock time, so the device timeline is in simulation time; the
  enclosing chunk span on pid 1 says what wall interval it maps to.
  Digest streams ride pid 2 the same way; progress beats land on pid 1
  as instant events at their wall offset.

A stream need not carry every event type — a spans-only stream
(``configure(rings=False)``) exports just the host timeline, and a
rings-only stream just the device one.

Round-trip helpers (`spans_from_chrome`) exist so the export is
testable without a browser.
"""

from __future__ import annotations

import json


def to_chrome_trace(events) -> dict:
    """Telemetry events (dicts, schema.py) -> Trace Event Format dict."""
    trace: list[dict] = [
        {"ph": "M", "pid": 1, "name": "process_name",
         "args": {"name": "host"}},
        {"ph": "M", "pid": 2, "name": "process_name",
         "args": {"name": "device ticks"}},
    ]
    ring_seq = 0
    for event in events:
        etype = event.get("type")
        if etype == "span":
            row = {
                "ph": "X",
                "pid": 1,
                "tid": 1,
                "name": event["name"],
                "ts": round(event["ts"] * 1e6, 3),
                "dur": round(event["dur"] * 1e6, 3),
            }
            args = dict(event.get("attrs", {}))
            args["depth"] = event.get("depth", 0)
            row["args"] = args
            trace.append(row)
        elif etype == "ring":
            ring_seq += 1
            label = event["kernel"]
            for key in ("chunk", "replica", "shard"):
                if key in event:
                    label += f"[{key}={event[key]}]"
            t0 = int(event.get("t0", 0))
            for col, series in event.get("metrics", {}).items():
                for i, val in enumerate(series):
                    trace.append({
                        "ph": "C",
                        "pid": 2,
                        "name": f"{label}:{col}",
                        "ts": t0 + i,
                        "args": {col: val},
                    })
        elif etype == "digest":
            # Flight-recorder stream on the device timeline: the raw
            # uint32 per tick. The numeric value is a hash (only
            # equality means anything), but two runs' traces overlay to
            # a visual divergence point.
            label = event["kernel"]
            for key in ("chunk", "replica", "shard"):
                if key in event:
                    label += f"[{key}={event[key]}]"
            t0 = int(event.get("t0", 0))
            for i, val in enumerate(event.get("values", [])):
                trace.append({
                    "ph": "C",
                    "pid": 2,
                    "name": f"digest:{label}",
                    "ts": t0 + i,
                    "args": {"digest": val},
                })
        elif etype == "progress":
            # Liveness beats as instant events on the host timeline at
            # their wall offset — the gaps between them are the stall
            # detector's raw signal, visible at a glance.
            args = {
                k: event[k]
                for k in ("chunk", "chunks_total", "ticks_done",
                          "coverage_pct", "eta_s", "digest_head")
                if k in event
            }
            trace.append({
                "ph": "i",
                "s": "g",
                "pid": 1,
                "tid": 1,
                "name": f"progress:{event.get('kernel', '?')}",
                "ts": round(float(event.get("elapsed_s", 0.0)) * 1e6, 3),
                "args": args,
            })
        elif etype == "counter":
            trace.append({
                "ph": "C",
                "pid": 1,
                "name": event["name"],
                "ts": 0,
                "args": {"value": event["value"]},
            })
        elif etype == "meta":
            trace.append({
                "ph": "M", "pid": 1, "name": "run",
                "args": event.get("run", {}),
            })
    return {"traceEvents": trace, "displayTimeUnit": "ms"}


def spans_from_chrome(trace: dict) -> list[dict]:
    """Recover span events from an exported trace (name/ts/dur/depth in
    the original seconds units) — the round-trip the tests assert."""
    spans = []
    for row in trace.get("traceEvents", []):
        if row.get("ph") == "X" and row.get("pid") == 1:
            spans.append({
                "type": "span",
                "name": row["name"],
                "ts": row["ts"] / 1e6,
                "dur": row["dur"] / 1e6,
                "depth": row.get("args", {}).get("depth", 0),
            })
    return spans


def write_chrome_trace(events, path: str) -> None:
    with open(path, "w", encoding="utf-8") as f:
        json.dump(to_chrome_trace(events), f)


def load_stream(path: str) -> list[dict]:
    """Read a telemetry JSONL file into event dicts (malformed lines are
    skipped — exporting a partially-written stream should still work)."""
    events = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                events.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    return events
