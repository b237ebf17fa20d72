"""Telemetry event schema — the one definition every producer and
consumer shares, kept value for value equal to the JAX package's
``telemetry/schema.py`` so a stream from either package validates and
renders under the other's tools.

A telemetry stream is JSONL: one JSON object per line, each carrying a
``type`` field. Producers are the sink (`telemetry/sink.py`); consumers
are the Chrome-trace exporter (`telemetry/chrometrace.py`), the digest
comparison (`telemetry/compare.py`) and the JAX package's run report.
Standard library only.

Event types (SCHEMA_VERSION 2 — version 1 streams remain valid; v2 adds
the ``request``/``slot`` server events, docs/OBSERVABILITY.md):

  meta     first line of every stream: {"type": "meta", "schema": 1,
           "run": {"argv": [...], "utc": iso8601, ...}}
  span     one closed host span: {"type": "span", "name", "ts", "dur",
           "depth", "attrs"} — ts/dur in seconds on the run's monotonic
           clock (ts is the span's start relative to sink configure).
  ring     one harvested device metric ring: {"type": "ring",
           "kernel", "t0", "ticks", "columns": METRIC_COLUMNS,
           "metrics": {column: [per-tick ints]}} plus optional
           provenance ("chunk", "replica", "seed", "shard").
  counter  a scalar sample: {"type": "counter", "name", "value"} —
           the JAX package samples its jit-cache sizes and compiled
           costs this way; the port emits none of its own yet.
  digest   one harvested per-tick state-digest ring (telemetry/digest.py):
           {"type": "digest", "kernel", "t0", "ticks",
           "values": [uint32 per executed tick]} plus the same optional
           provenance keys as ring events — the flight-recorder stream
           the divergence bisector aligns.
  progress one per-chunk liveness beat (telemetry/progress.py):
           {"type": "progress", "kernel", "elapsed_s"} plus optional
           "chunk", "chunks_total", "ticks_done", "coverage_pct",
           "eta_s", "digest_head" (8-hex-digit string), and — when the
           gossip server multiplexes runs (serve/server.py) —
           "active_requests"/"queue_depth".
  request  one request-lifecycle transition of the gossip server
           (serve/server.py): {"type": "request", "request_id",
           "event": one of REQUEST_EVENTS} plus optional "signature"
           (static-signature key), "protocol", "replicas",
           "replicas_done", "queue_depth", "turnaround_s", "reason"
           (rejections), and "cost" (the admission controller's modeled
           bytes/flops object).
  slot     one continuous-batching dispatch of the gossip server
           (serve/scheduler.py): {"type": "slot", "signature", "slots",
           "occupied", "request_ids": [...]} plus optional "batch"
           (dispatch ordinal) and "wall_s".

Ring columns (uint32 values — see docs/OBSERVABILITY.md for the
per-engine semantics and the overflow bound):

  frontier_bits   node-share bits newly entering the seen universe this
                  tick (dedup'ed; includes generations)
  frontier_nodes  nodes contributing a nonzero new frontier this tick
  newly_infected  first-time receives this tick (excludes generations —
                  sums to the run's total ``received`` counter)
  msgs_gathered   message bits arriving over links this tick, post
                  OR-reduce, post link-loss (pre node-churn drop)
  or_work         message volume the tick injects: for flood, edge
                  messages issued by the new frontier (sum of degree
                  over frontier nodes); for the partnered protocols,
                  share bits transmitted in digests/pushes this round
  loss_dropped    message bits lost in flight to the link-loss coin
                  this tick (0 when loss is off)
  exchange_words  uint32 words of frontier/state slices received over
                  the mesh interconnect this tick, totalled over node
                  shards: the dense all_gathers (x delay splits on a
                  sharded ring), the fixed delta all_to_all footprint
                  plus any dense fallbacks (exchange="delta"), or 0 on
                  a single shard. Push-direction digest traffic is NOT
                  included — this column prices the state-slice
                  exchange the dense/delta paths trade off.
  staleness       added staleness ticks consumed this tick under the
                  bounded-staleness async exchange (exchange="async",
                  parallel/async_ticks.py): the sum over async delay
                  groups x node shards of (max(d, K) - d) for each
                  group whose remote (cross-shard) frontier view held
                  any bit — i.e. how many ticks late the bits folded in
                  this tick ran, charged only when remote bits were
                  actually pending. 0 on every synchronous path and for
                  K=1 (the sync-equivalent anchor).
  stale_folds     count of stale remote-fold events this tick (async
                  delay groups with max(d, K) > d whose remote view
                  held pending bits, summed over node shards) — the
                  denominator for ``staleness``: staleness/stale_folds
                  is the mean added lateness per fold, bounded by K-1.
                  0 on every synchronous path.
"""

from __future__ import annotations

SCHEMA_VERSION = 2

#: Schema versions a consumer accepts: v1 streams (pre-server) carry no
#: request/slot events but stay valid under every v2 validator.
SUPPORTED_SCHEMAS = (1, 2)

METRIC_COLUMNS = (
    "frontier_bits",
    "frontier_nodes",
    "newly_infected",
    "msgs_gathered",
    "or_work",
    "loss_dropped",
    "exchange_words",
    "staleness",
    "stale_folds",
)
NUM_METRICS = len(METRIC_COLUMNS)

EVENT_TYPES = (
    "meta", "span", "ring", "counter", "digest", "progress", "request",
    "slot",
)

#: Request-lifecycle transitions the server emits (serve/server.py).
REQUEST_EVENTS = (
    "submitted", "admitted", "rejected", "dispatched", "preempted",
    "resumed", "done",
)


def validate_event(event) -> list[str]:
    """Schema errors for one event dict ([] = valid). Never raises on
    malformed input — every problem comes back as a message."""
    errs: list[str] = []
    if not isinstance(event, dict):
        return [f"event is {type(event).__name__}, not an object"]
    etype = event.get("type")
    if etype not in EVENT_TYPES:
        return [f"unknown event type {etype!r} (valid: {EVENT_TYPES})"]
    if etype == "meta":
        if event.get("schema") not in SUPPORTED_SCHEMAS:
            errs.append(
                f"meta.schema is {event.get('schema')!r}, expected one of "
                f"{SUPPORTED_SCHEMAS}"
            )
        if not isinstance(event.get("run"), dict):
            errs.append("meta.run must be an object")
    elif etype == "span":
        if not isinstance(event.get("name"), str) or not event.get("name"):
            errs.append("span.name must be a non-empty string")
        for key in ("ts", "dur"):
            val = event.get(key)
            if not isinstance(val, (int, float)) or val < 0:
                errs.append(f"span.{key} must be a number >= 0")
        if not isinstance(event.get("depth"), int) or event["depth"] < 0:
            errs.append("span.depth must be an int >= 0")
        if "attrs" in event and not isinstance(event["attrs"], dict):
            errs.append("span.attrs must be an object")
    elif etype == "ring":
        if not isinstance(event.get("kernel"), str) or not event.get("kernel"):
            errs.append("ring.kernel must be a non-empty string")
        if list(event.get("columns", [])) != list(METRIC_COLUMNS):
            errs.append(
                f"ring.columns must be {list(METRIC_COLUMNS)}, got "
                f"{event.get('columns')!r}"
            )
        ticks = event.get("ticks")
        if not isinstance(ticks, int) or ticks < 0:
            errs.append("ring.ticks must be an int >= 0")
        if not isinstance(event.get("t0"), int) or event.get("t0", -1) < 0:
            errs.append("ring.t0 must be an int >= 0")
        metrics = event.get("metrics")
        if not isinstance(metrics, dict):
            errs.append("ring.metrics must be an object")
        else:
            for col in METRIC_COLUMNS:
                series = metrics.get(col)
                if not isinstance(series, list):
                    errs.append(f"ring.metrics.{col} must be a list")
                elif isinstance(ticks, int) and len(series) != ticks:
                    errs.append(
                        f"ring.metrics.{col} has {len(series)} entries, "
                        f"ticks says {ticks}"
                    )
                elif not all(
                    isinstance(v, int) and v >= 0 for v in series
                ):
                    errs.append(
                        f"ring.metrics.{col} must hold non-negative ints"
                    )
    elif etype == "digest":
        if not isinstance(event.get("kernel"), str) or not event.get("kernel"):
            errs.append("digest.kernel must be a non-empty string")
        ticks = event.get("ticks")
        if not isinstance(ticks, int) or ticks < 0:
            errs.append("digest.ticks must be an int >= 0")
        if not isinstance(event.get("t0"), int) or event.get("t0", -1) < 0:
            errs.append("digest.t0 must be an int >= 0")
        values = event.get("values")
        if not isinstance(values, list):
            errs.append("digest.values must be a list")
        else:
            if isinstance(ticks, int) and len(values) != ticks:
                errs.append(
                    f"digest.values has {len(values)} entries, ticks "
                    f"says {ticks}"
                )
            if not all(
                isinstance(v, int) and 0 <= v < (1 << 32) for v in values
            ):
                errs.append("digest.values must hold uint32 ints")
    elif etype == "progress":
        if not isinstance(event.get("kernel"), str) or not event.get("kernel"):
            errs.append("progress.kernel must be a non-empty string")
        val = event.get("elapsed_s")
        if not isinstance(val, (int, float)) or val < 0:
            errs.append("progress.elapsed_s must be a number >= 0")
        for key in ("chunk", "chunks_total", "ticks_done",
                    "active_requests", "queue_depth"):
            if key in event and (
                not isinstance(event[key], int) or event[key] < 0
            ):
                errs.append(f"progress.{key} must be an int >= 0")
        for key in ("coverage_pct", "eta_s"):
            if key in event and not isinstance(event[key], (int, float)):
                errs.append(f"progress.{key} must be a number")
        if "digest_head" in event and not (
            isinstance(event["digest_head"], str)
            and len(event["digest_head"]) == 8
        ):
            errs.append("progress.digest_head must be an 8-hex-char string")
    elif etype == "counter":
        if not isinstance(event.get("name"), str) or not event.get("name"):
            errs.append("counter.name must be a non-empty string")
        if not isinstance(event.get("value"), (int, float)):
            errs.append("counter.value must be a number")
    elif etype == "request":
        rid = event.get("request_id")
        if not isinstance(rid, str) or not rid:
            errs.append("request.request_id must be a non-empty string")
        if event.get("event") not in REQUEST_EVENTS:
            errs.append(
                f"request.event is {event.get('event')!r}, expected one of "
                f"{REQUEST_EVENTS}"
            )
        for key in ("replicas", "replicas_done", "queue_depth"):
            if key in event and (
                not isinstance(event[key], int) or event[key] < 0
            ):
                errs.append(f"request.{key} must be an int >= 0")
        if "turnaround_s" in event and (
            not isinstance(event["turnaround_s"], (int, float))
            or event["turnaround_s"] < 0
        ):
            errs.append("request.turnaround_s must be a number >= 0")
        for key in ("signature", "protocol", "reason"):
            if key in event and (
                not isinstance(event[key], str) or not event[key]
            ):
                errs.append(f"request.{key} must be a non-empty string")
        if "cost" in event and not isinstance(event["cost"], dict):
            errs.append("request.cost must be an object")
    elif etype == "slot":
        sig = event.get("signature")
        if not isinstance(sig, str) or not sig:
            errs.append("slot.signature must be a non-empty string")
        slots = event.get("slots")
        if not isinstance(slots, int) or slots < 1:
            errs.append("slot.slots must be an int >= 1")
        occupied = event.get("occupied")
        if not isinstance(occupied, int) or occupied < 0:
            errs.append("slot.occupied must be an int >= 0")
        elif isinstance(slots, int) and slots >= 1 and occupied > slots:
            errs.append(
                f"slot.occupied ({occupied}) exceeds slot.slots ({slots})"
            )
        rids = event.get("request_ids")
        if not isinstance(rids, list) or not all(
            isinstance(r, str) and r for r in rids
        ):
            errs.append(
                "slot.request_ids must be a list of non-empty strings"
            )
        if "batch" in event and (
            not isinstance(event["batch"], int) or event["batch"] < 0
        ):
            errs.append("slot.batch must be an int >= 0")
        if "wall_s" in event and (
            not isinstance(event["wall_s"], (int, float))
            or event["wall_s"] < 0
        ):
            errs.append("slot.wall_s must be a number >= 0")
    return errs


def validate_stream(lines) -> list[str]:
    """Validate an iterable of JSONL lines; returns every error with its
    1-based line number prefixed. The first event must be a meta."""
    import json

    errs: list[str] = []
    first_seen = False
    for i, line in enumerate(lines, start=1):
        line = line.strip()
        if not line:
            continue
        try:
            event = json.loads(line)
        except json.JSONDecodeError as e:
            errs.append(f"line {i}: not JSON ({e})")
            continue
        if not first_seen:
            first_seen = True
            if not (isinstance(event, dict) and event.get("type") == "meta"):
                errs.append("line 1: first event must be type 'meta'")
        errs.extend(f"line {i}: {msg}" for msg in validate_event(event))
    if not first_seen:
        errs.append("stream is empty (no events)")
    return errs
