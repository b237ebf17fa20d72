"""Host span tracing — nestable phase timers, mirrored onto the profiler.

    with telemetry.span("compile", kernel="flood_runner") as sp:
        runner = build(...)
        sp.set(entries=runner.size)

Each closed span emits one ``span`` event: start time relative to the
sink's epoch, duration, nesting depth, and free-form attrs (given when
the span opens, or counted at its end with ``set``). The clock is
``time.perf_counter`` (monotonic — durations are immune to wall-clock
steps). Nesting is tracked per thread, so spans opened on worker threads
don't corrupt the main thread's depth.

With telemetry on, each span also opens a profiler range named
``p2p.<name>`` (``torch._C._profiler._RecordFunctionFast``: no
dispatcher op, ~0.7 us without a profiler). Under ``torch.profiler`` the
range lands among ``kineto_results.events()`` on the device trace's own
clock, so a kernel's launch can be credited to the span open around it.

With telemetry off, ``span()`` returns one shared no-op context: no
generator, no clock read, no lock. A span then costs one function call
and a flag test, so the engines open spans in their tick loops too (the
tick, its gather, its update and its flag read); nothing in a tick body
branches on whether telemetry is on.

The JAX package's ``emit_jit_cache_counters`` has no counterpart here:
PyTorch runs eagerly and keeps no jit cache to sample. Counts travel as
span attributes.
"""

from __future__ import annotations

import threading
import time

from torch._C._profiler import _RecordFunctionFast

from p2p_gossip_tpu_torch.telemetry import sink

_tls = threading.local()


def _depth() -> int:
    return getattr(_tls, "depth", 0)


class _Off:
    """The span of a run with telemetry off: enters, sets and exits doing
    nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


_OFF = _Off()


class _Span:
    __slots__ = ("name", "attrs", "depth", "start", "_range")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def set(self, **attrs) -> None:
        """Add attrs counted inside the span (they ride on its event)."""
        self.attrs.update(attrs)

    def __enter__(self):
        self.depth = _depth()
        _tls.depth = self.depth + 1
        self._range = _RecordFunctionFast(f"p2p.{self.name}")
        self._range.__enter__()
        self.start = time.perf_counter()
        return self

    def __exit__(self, etype, exc, tb):
        dur = time.perf_counter() - self.start
        self._range.__exit__(etype, exc, tb)
        _tls.depth = self.depth
        attrs = self.attrs
        if etype is not None:
            attrs = {**attrs, "error": etype.__name__}
        event = {
            "type": "span",
            "name": self.name,
            "ts": max(self.start - sink.epoch(), 0.0),
            "dur": dur,
            "depth": self.depth,
        }
        if attrs:
            event["attrs"] = attrs
        sink.emit(event)
        return False


def span(name: str, **attrs):
    """Time a phase and emit it as a span event on exit. Nestable;
    exceptions propagate (the span still closes, attr ``error`` set).
    Telemetry off: the shared no-op context."""
    if not sink.enabled():
        return _OFF
    return _Span(name, attrs)
