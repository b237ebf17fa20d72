"""Live run streaming: per-chunk progress events + a heartbeat file.

A long run is otherwise silent between its start and its final
counters. This module gives every chunk driver two cheap liveness
channels, both fed from the existing per-chunk harvest point (no
per-tick host traffic):

- ``progress`` events in the telemetry JSONL stream: chunk index,
  cumulative ticks, coverage %, ETA extrapolated from elapsed wall time,
  and the head of the chunk's digest stream (when digests are on) — the
  flight recorder's cockpit view, which the JAX package's
  ``scripts/run_report.py`` renders.
- a heartbeat FILE, atomically rewritten (tmp + ``os.replace``) on every
  progress emission. A watcher reads its mtime age for stall detection
  on long runs: a live run keeps the mtime fresh; a wedged device hang
  does not. The heartbeat is independent of the JSONL sink —
  set ``P2P_HEARTBEAT=<path>`` (or `configure_heartbeat`) and it works
  even with telemetry off, because liveness must not require paying for
  instrumented kernels.
"""

from __future__ import annotations

import json
import os
import threading
import time

from p2p_gossip_tpu_torch.telemetry import sink

ENV_HEARTBEAT = "P2P_HEARTBEAT"

_lock = threading.Lock()
_heartbeat_path: str | None = None
_heartbeat_configured = False


def configure_heartbeat(path: str | None) -> None:
    """Set (or clear, with None) the heartbeat file path, overriding the
    ``P2P_HEARTBEAT`` environment variable."""
    global _heartbeat_path, _heartbeat_configured
    with _lock:
        _heartbeat_path = path
        _heartbeat_configured = True


def heartbeat_path() -> str | None:
    """The active heartbeat path: `configure_heartbeat`'s value if it was
    ever called, else ``P2P_HEARTBEAT`` (re-read per call so battery
    subprocesses inherit it without any import-order dance)."""
    with _lock:
        if _heartbeat_configured:
            return _heartbeat_path
    return os.environ.get(ENV_HEARTBEAT) or None


def write_heartbeat(payload: dict, path: str | None = None) -> None:
    """Atomically rewrite the heartbeat file: write a sibling tmp file,
    fsync, ``os.replace``. A reader never sees a torn write, and the
    file's mtime is the liveness signal (`heartbeat_age_s`)."""
    path = path if path is not None else heartbeat_path()
    if not path:
        return
    record = {
        "utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "pid": os.getpid(),
        **payload,
    }
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(tmp, "w", encoding="utf-8") as f:
            f.write(json.dumps(record))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except OSError:
        # Liveness reporting must never take a run down.
        try:
            if os.path.exists(tmp):
                os.remove(tmp)
        except OSError:
            pass


def read_heartbeat(path: str) -> dict | None:
    """The heartbeat payload, or None when missing/unreadable/torn."""
    try:
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
    except (OSError, ValueError):
        return None
    return data if isinstance(data, dict) else None


def heartbeat_age_s(path: str) -> float | None:
    """Seconds since the heartbeat file was last rewritten (mtime-based,
    immune to clock text in the payload), or None when it is missing."""
    try:
        return max(0.0, time.time() - os.stat(path).st_mtime)
    except OSError:
        return None


def is_stale(path: str, max_age_s: float) -> bool:
    """True when the heartbeat is missing or older than ``max_age_s`` —
    the stall predicate the watchers act on."""
    age = heartbeat_age_s(path)
    return age is None or age > max_age_s


def emit_progress(
    kernel: str,
    *,
    chunk: int | None = None,
    chunks_total: int | None = None,
    ticks_done: int | None = None,
    coverage_pct: float | None = None,
    digest_head: int | None = None,
    active_requests: int | None = None,
    queue_depth: int | None = None,
    **provenance,
):
    """One per-chunk progress beat: a ``progress`` event into the JSONL
    sink (when enabled) and a heartbeat-file rewrite (when configured).
    ETA extrapolates elapsed wall time over completed chunks — coarse by
    design; it exists so a 6-hour battery stage is distinguishable from
    a wedge, not to forecast.

    ``active_requests``/``queue_depth`` are the gossip server's
    multiplexing counters (serve/server.py): when one process drains
    many requests, the per-chunk cadence alone can't tell "slow batch"
    from "deep queue" — the watchers' stall heuristics read these from
    the heartbeat payload to keep their thresholds meaningful."""
    hb_path = heartbeat_path()
    if not sink.enabled() and not hb_path:
        return
    elapsed = round(time.perf_counter() - sink.epoch(), 4)
    event: dict = {
        "type": "progress",
        "kernel": kernel,
        "elapsed_s": elapsed,
    }
    if chunk is not None:
        event["chunk"] = int(chunk)
    if chunks_total is not None:
        event["chunks_total"] = int(chunks_total)
        done = (int(chunk) + 1) if chunk is not None else None
        if done and chunks_total and elapsed > 0:
            frac = min(1.0, done / int(chunks_total))
            if frac > 0:
                event["eta_s"] = round(elapsed * (1.0 - frac) / frac, 2)
    if ticks_done is not None:
        event["ticks_done"] = int(ticks_done)
    if coverage_pct is not None:
        event["coverage_pct"] = round(float(coverage_pct), 4)
    if digest_head is not None:
        event["digest_head"] = f"{int(digest_head) & 0xFFFFFFFF:08x}"
    if active_requests is not None:
        event["active_requests"] = int(active_requests)
    if queue_depth is not None:
        event["queue_depth"] = int(queue_depth)
    for key, val in provenance.items():
        if val is not None:
            event[key] = val
    if sink.enabled():
        sink.emit(event)
    if hb_path:
        write_heartbeat({k: v for k, v in event.items() if k != "type"},
                        hb_path)
