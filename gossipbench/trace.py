"""The traced run's records: the device's busy intervals from
``torch.profiler``, the host spans open while the device idled, and the
benchmark's own spans.

Host spans are of two kinds: the benchmark's (``torch.profiler.
record_function`` ranges named ``gossipbench.*``, on the profiler's clock)
and the program's (the telemetry sink's ``span`` events, on
``time.perf_counter``, moved onto the profiler's clock by the start of the
``gossipbench.window`` range, read against ``perf_counter`` as it opens).
"""

from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict

import torch

WINDOW = "gossipbench.window"


class Tracer:
    """A profiler over the measured window (CPU and, on a card, CUDA
    activity). Off, every method is a no-op."""

    def __init__(self, on: bool, device: torch.device):
        self.on = on
        self.device = device
        self.prof = None
        self.pc_open = None
        self.port_spans, self.sink_epoch = [], 0.0

    def span(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        return torch.profiler.record_function(f"gossipbench.{name}")

    @contextlib.contextmanager
    def window(self):
        if not self.on:
            yield
            return
        from p2p_gossip_tpu_torch.telemetry import sink

        sink.configure(None, rings=False)  # the program's host spans, device rings off
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        try:
            self.pc_open = time.perf_counter()
            with torch.profiler.record_function(WINDOW):
                yield
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        finally:
            self.prof.__exit__(None, None, None)
            self.port_spans = [e for e in sink.events() if e.get("type") == "span"]
            self.sink_epoch = sink.epoch()
            sink.close()

    def summary(self) -> dict:
        """Busy and idle time of the window, device time by operation, and
        the idle time by the host span open during it. Reads the raw
        profiler events (``kineto_results``): building the profiler's
        event tree costs ~80 us an event, tens of seconds a window."""
        from torch.autograd import DeviceType

        dev_ops, cpu_ops, spans = [], [], []
        w0 = w1 = None
        events = self.prof.profiler.kineto_results.events()
        base = min((e.start_ns() for e in events), default=0)  # seconds from here on
        for e in events:
            name = e.name()
            start = (e.start_ns() - base) * 1e-9
            end = start + e.duration_ns() * 1e-9
            if e.device_type() == DeviceType.CUDA:
                # Kernels, copies and fills; a host range mirrored onto the
                # device's timeline is no device work.
                if not (name.startswith("gossipbench.") or e.is_user_annotation()):
                    dev_ops.append((start, end, name))
            elif name == WINDOW:
                w0, w1 = start, end
            elif name.startswith("gossipbench."):
                spans.append((start, end, name[len("gossipbench."):]))
            else:
                cpu_ops.append((start, end, name))
        if w0 is None:
            raise RuntimeError("the profiler recorded no window")
        for ev in self.port_spans:  # perf_counter -> the profiler's clock
            s = self.sink_epoch + ev["ts"] - self.pc_open + w0
            spans.append((s, s + ev["dur"], ev["name"]))
        busy = _union([(max(s, w0), min(e, w1)) for s, e, _ in dev_ops if e > w0 and s < w1])
        by_op = defaultdict(float)
        for s, e, name in dev_ops:
            by_op[name] += e - s
        idle = defaultdict(float)
        spans.sort()
        cpu_ops.sort()
        for s, e in _gaps(busy, w0, w1):
            mid = 0.5 * (s + e)
            idle[_innermost(spans, mid) + "/" + _innermost(cpu_ops, mid)] += e - s
        return {
            "window_s": w1 - w0,
            "busy_s": sum(e - s for s, e in busy),
            "device_ops": sorted(by_op.items(), key=lambda kv: -kv[1]),
            "idle_gaps": sorted(idle.items(), key=lambda kv: -kv[1]),
        }


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _gaps(busy, w0, w1):
    gaps, t = [], w0
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if w1 > t:
        gaps.append((t, w1))
    return gaps


def _innermost(intervals, point: float, look_back: int = 64) -> str:
    """Name of the latest-starting interval that holds ``point`` (the
    innermost of nested ones), or "-"."""
    i = bisect.bisect_right(intervals, (point, float("inf"), ""))
    for j in range(i - 1, max(i - 1 - look_back, -1), -1):
        s, e, name = intervals[j]
        if s <= point <= e:
            return name
    return "-"
