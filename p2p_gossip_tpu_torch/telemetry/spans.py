"""Host span tracing — nestable monotonic-clock phase timers.

    with telemetry.span("compile", kernel="flood_runner"):
        runner = build(...)

Each closed span emits one ``span`` event: start time relative to the
sink's epoch, duration, nesting depth, and free-form attrs. The clock is
``time.perf_counter`` (monotonic — durations are immune to wall-clock
steps). Nesting is tracked per thread, so spans opened on worker threads
don't corrupt the main thread's depth.

When telemetry is off, ``span()`` yields immediately without reading the
clock — safe to leave in place on hot host paths (it still costs a
function call per use, which is why the engines only wrap per-CHUNK
work, never per-tick work; per-tick visibility is the metric rings' job).

The JAX package's ``emit_jit_cache_counters`` has no counterpart here:
PyTorch runs eagerly and keeps no jit cache to sample.
"""

from __future__ import annotations

import contextlib
import threading
import time

from p2p_gossip_tpu_torch.telemetry import sink

_tls = threading.local()


def _depth() -> int:
    return getattr(_tls, "depth", 0)


@contextlib.contextmanager
def span(name: str, **attrs):
    """Time a phase and emit it as a span event on exit. Nestable;
    exceptions propagate (the span still closes, attr ``error`` set)."""
    if not sink.enabled():
        yield
        return
    depth = _depth()
    _tls.depth = depth + 1
    start = time.perf_counter()
    try:
        yield
    except BaseException as e:
        attrs = {**attrs, "error": type(e).__name__}
        raise
    finally:
        dur = time.perf_counter() - start
        _tls.depth = depth
        event = {
            "type": "span",
            "name": name,
            "ts": max(start - sink.epoch(), 0.0),
            "dur": dur,
            "depth": depth,
        }
        if attrs:
            event["attrs"] = attrs
        sink.emit(event)


def emit_counter(name: str, value) -> None:
    sink.emit({"type": "counter", "name": name, "value": value})
