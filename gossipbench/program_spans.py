"""The program's own spans (``p2p_gossip_tpu_torch.telemetry.span``) in a
traced run, in two readings:

- ``sink_spans()``: the span events of the telemetry sink, which the
  tracer configures around the measured window (host durations only);
- ``Attribution(events)``: the ``p2p.<name>`` profiler ranges the spans
  open beside their events, among ``torch.profiler``'s own events
  (``kineto_results.events()``), so on the device trace's clock. Each
  device operation is credited to the innermost program span open when
  the call that launched it ran: the profiler links a kernel, copy or fill
  to that call by ``linked_correlation_id`` = its ``correlation_id``.

A program without these spans leaves both readings empty.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

PREFIX = "p2p."


def sink_spans() -> list:
    """The program's span events in the telemetry sink (kept after the
    tracer closes it; empty where the sink never ran)."""
    from p2p_gossip_tpu_torch.telemetry import sink

    return [e for e in sink.events() if e.get("type") == "span"]


def seconds_by_name(events) -> dict:
    """Summed ``dur`` of span events by name."""
    out = defaultdict(float)
    for e in events:
        out[e["name"]] += e["dur"]
    return dict(out)


def count_by_name(events) -> dict:
    out = defaultdict(int)
    for e in events:
        out[e["name"]] += 1
    return dict(out)


class Attribution:
    """Program spans and device operations of one profiler run.

    ``spans``: (start, end, name) of the ``p2p.*`` ranges, in seconds on
    the profiler's clock from its first event (``base_ns``), by start; ``device``: (start, end, name,
    launch) of each device operation, ``launch`` the start of the host
    call that launched it (None where the profiler linked none)."""

    def __init__(self, events):
        from torch.autograd import DeviceType

        spans, dev, host, calls = [], [], {}, []
        events = list(events)
        self.base_ns = min((e.start_ns() for e in events), default=0)  # seconds from here
        for e in events:
            name = e.name()
            s = (e.start_ns() - self.base_ns) * 1e-9
            end = s + e.duration_ns() * 1e-9
            if e.device_type() == DeviceType.CUDA:
                # A host range mirrored onto the device's timeline is no work.
                if not (name.startswith((PREFIX, "gossipbench.")) or e.is_user_annotation()):
                    dev.append((s, end, name, e.linked_correlation_id()))
                continue
            if name.startswith(PREFIX):
                spans.append((s, end, name[len(PREFIX):]))
            elif not name.startswith("gossipbench."):
                calls.append((s, end, name))
            if e.correlation_id():
                host[e.correlation_id()] = s
        spans.sort(key=lambda x: (x[0], -x[1]))
        self.spans = spans
        self.device = sorted((s, e, n, host.get(c)) for s, e, n, c in dev)
        self.calls = sorted(calls)  # the host's other ranges: ops, runtime calls

    def span_totals(self) -> dict:
        """name -> [count, total seconds, self seconds] (self: less the time
        of the program spans directly inside it)."""
        out = defaultdict(lambda: [0, 0.0, 0.0])
        stack = []  # [end, name, child seconds]
        for s, e, name in self.spans + [(float("inf"), float("inf"), None)]:
            while stack and stack[-1][0] <= s:
                self._close(stack, out)
            if name is None:
                break
            stack.append([e, name, 0.0, e - s])
        return {k: list(v) for k, v in out.items()}

    @staticmethod
    def _close(stack, out):
        end, name, child, dur = stack.pop()
        tot = out[name]
        tot[0] += 1
        tot[1] += dur
        tot[2] += dur - child
        if stack:
            stack[-1][2] += dur

    def innermost(self, points=None) -> list:
        """For each device operation (``device``'s order), or each of
        ``points`` (times, None for none), the index in ``spans`` of the
        innermost program span open at its launch (at it), or None."""
        if points is None:
            points = [launch for _, _, _, launch in self.device]
        launches = sorted((l, i) for i, l in enumerate(points) if l is not None)
        out = [None] * len(points)
        stack, j = [], 0
        for t, i in launches:
            while j < len(self.spans) and self.spans[j][0] <= t:
                while stack and self.spans[stack[-1]][1] < self.spans[j][0]:
                    stack.pop()
                stack.append(j)
                j += 1
            while stack and self.spans[stack[-1]][1] < t:
                stack.pop()
            out[i] = stack[-1] if stack else None
        return out

    def device_by_span(self) -> dict:
        """Device seconds by the innermost program span open at launch;
        ``"unattributed"``: those launched under none (or unlinked)."""
        out = defaultdict(float)
        for (s, e, _, _), k in zip(self.device, self.innermost()):
            out["unattributed" if k is None else self.spans[k][2]] += e - s
        return dict(out)

    def ops_by_span(self, span: str) -> dict:
        """Device seconds by operation name, of those launched under ``span``."""
        out = defaultdict(float)
        for (s, e, name, _), k in zip(self.device, self.innermost()):
            if k is not None and self.spans[k][2] == span:
                out[name] += e - s
        return dict(out)

    def host_calls_by_span(self, span: str) -> dict:
        """Host seconds by op or runtime call name, of those that start
        under ``span`` (nested ops count in each of their ranges)."""
        out = defaultdict(float)
        under = self.innermost([s for s, _, _ in self.calls])
        for (s, e, name), k in zip(self.calls, under):
            if k is not None and self.spans[k][2] == span:
                out[name] += e - s
        return dict(out)

    def sync_after_tick_work(self) -> tuple:
        """(ticks whose ``sync`` span ends at or after the end of the last
        device operation launched inside the tick, ticks with such an
        operation). On one clock every one does: the flag read waits for
        the stream."""
        ok, late = self._sync_margins()
        return ok, ok + len(late)

    def sync_margin_by_tenth(self) -> list:
        """Over each tenth of the profiled ticks, in time order, the least
        of (a tick's ``sync`` end − the end of its last device operation),
        in seconds: the two clocks' disagreement shows as it turns
        negative."""
        ok, late = self._sync_margins(keep_ok=True)
        marg = sorted(ok + late)
        if not marg:
            return []
        t0, t1 = marg[0][0], marg[-1][0]
        out = [None] * 10
        for t, m, _ in marg:
            i = min(int(10 * (t - t0) / (t1 - t0 or 1)), 9)
            out[i] = m if out[i] is None else min(out[i], m)
        return out

    def _sync_margins(self, keep_ok: bool = False):
        """(ticks whose flag read ends after their device work, or with
        ``keep_ok`` their (tick start, margin, op) list; the late ones'
        (tick start, margin, op)), margin = ``sync`` end − the end of the
        tick's last device operation, negative when late."""
        ticks = [k for k, sp in enumerate(self.spans) if sp[2] == "tick"]
        starts = [self.spans[k][0] for k in ticks]
        last = {}
        for (_, e, name, launch), k in zip(self.device, self.innermost()):
            if k is None:
                continue
            i = bisect.bisect_right(starts, launch) - 1
            if i >= 0 and launch <= self.spans[ticks[i]][1]:
                last[i] = max(last.get(i, (0.0, "")), (e, name))
        syncs = sorted(sp for sp in self.spans if sp[2] == "sync")
        sync_starts = [sp[0] for sp in syncs]
        ok, late = [], []
        for i, (end, name) in last.items():
            ts, te, _ = self.spans[ticks[i]]
            j = bisect.bisect_left(sync_starts, ts)
            sync_end = syncs[j][1] if j < len(syncs) and syncs[j][1] <= te else float("-inf")
            (ok if sync_end >= end else late).append((ts, sync_end - end, name))
        return (ok if keep_ok else len(ok)), late
