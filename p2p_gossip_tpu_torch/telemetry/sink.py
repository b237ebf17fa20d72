"""Telemetry sink — where every event lands, and the one on/off switch.

Off by default: until ``configure()`` runs (or ``P2P_TELEMETRY=<path>``
is set in the environment), ``enabled()`` is False, spans are no-ops,
and the engines keep no metric or digest ring: they consult
``rings_enabled()`` once per run, and with it off a tick launches
exactly the kernels it launches without telemetry (the tests pin this
with launch counts).

Two enablement axes, deliberately separate:

- ``enabled()``   — host spans + event emission. Cheap (a dict append
  or one JSONL write per event; the tick loops' spans emit four a
  tick).
- ``rings_enabled()`` — device metric and digest rings. These add work
  to every tick (integer reductions, the digest kernel, an extra gather
  or scatter), so code that measures performance can record spans
  without perturbing the kernels it times: ``configure(path=None,
  rings=False)``.

Events buffer in memory when ``path`` is None and stream to a JSONL
file otherwise (line-buffered appends; one file per run). The first
event of every configured stream is the ``meta`` line.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from datetime import datetime, timezone

from p2p_gossip_tpu_torch.telemetry.schema import SCHEMA_VERSION

ENV_VAR = "P2P_TELEMETRY"

_lock = threading.Lock()
_configured = False          # configure() ran (or env init happened)
_env_checked = False         # env auto-init attempted once
_rings = False
_path: str | None = None
_file = None
_buffer: list[dict] = []
_epoch = time.perf_counter()  # monotonic origin for span timestamps
_event_count = 0


def _meta_event(extra: dict | None = None) -> dict:
    run = {
        "argv": list(sys.argv),
        "utc": datetime.now(timezone.utc).isoformat(timespec="seconds"),
        "pid": os.getpid(),
    }
    if extra:
        run.update(extra)
    return {"type": "meta", "schema": SCHEMA_VERSION, "run": run}


def configure(
    path: str | None = None,
    *,
    rings: bool = True,
    run_info: dict | None = None,
) -> None:
    """Turn telemetry on. ``path`` streams events to that JSONL file
    (parent directory must exist); None keeps them in memory (drain with
    ``events()``). ``rings=False`` records host spans only, leaving the
    tick's kernels untouched. Reconfiguring closes any previous stream
    first."""
    global _configured, _rings, _path, _file, _epoch, _event_count
    with _lock:
        _close_locked()
        _configured = True
        _rings = bool(rings)
        _path = path
        _epoch = time.perf_counter()
        _event_count = 0
        _buffer.clear()
        if path is not None:
            _file = open(path, "a", buffering=1, encoding="utf-8")
    emit(_meta_event(run_info))


def _ensure_env_init() -> None:
    """One-shot auto-configure from P2P_TELEMETRY. Explicit configure()
    wins."""
    global _env_checked
    if _configured or _env_checked:
        return
    with _lock:
        if _configured or _env_checked:
            return
        _env_checked = True
        path = os.environ.get(ENV_VAR, "")
    if path:
        configure(path, rings=True)


def enabled() -> bool:
    """Host-side telemetry (spans + events) on?"""
    _ensure_env_init()
    return _configured


def rings_enabled() -> bool:
    """Device-side metric and digest rings on? Engines consult this once
    per run; with it off they run exactly the uninstrumented tick."""
    _ensure_env_init()
    return _configured and _rings


def epoch() -> float:
    """Monotonic origin for span timestamps (perf_counter units). Before
    any configure() the module-import instant stands in, so heartbeat-
    only runs (sink never configured) still report a sane elapsed_s."""
    return _epoch


def emit(event: dict) -> None:
    """Append one event to the active stream; silently dropped when
    telemetry is off (producers don't need to guard every call)."""
    global _event_count
    if not _configured:
        return
    with _lock:
        if not _configured:  # raced with close()
            return
        _event_count += 1
        if _file is not None:
            _file.write(json.dumps(event) + "\n")
        # Mirror into the buffer either way: in-process consumers
        # (the tests, chip_smoke.py, the benchmark's readers) read
        # events() without re-parsing the file. Unbounded: the tick
        # loops' spans add four events a tick, ~1 KB, so a configured
        # sink is for runs of bounded length (tens of thousands of
        # ticks), not for a server left running.
        _buffer.append(event)


def events() -> list[dict]:
    """Every event emitted since configure(), in order."""
    with _lock:
        return list(_buffer)


def event_count() -> int:
    return _event_count


def path() -> str | None:
    return _path


def close() -> None:
    """Flush and disable. Idempotent."""
    with _lock:
        _close_locked()


def _close_locked() -> None:
    global _configured, _file, _rings
    if _file is not None:
        try:
            _file.flush()
            _file.close()
        except OSError:
            pass
    _file = None
    _configured = False
    _rings = False


def reset() -> None:
    """Test hook: back to the pristine off state, env re-checked on the
    next enabled() call."""
    global _env_checked, _event_count, _path
    close()
    with _lock:
        _env_checked = False
        _event_count = 0
        _path = None
        _buffer.clear()
