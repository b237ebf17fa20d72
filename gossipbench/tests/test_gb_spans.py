"""The program's spans as the benchmark reads them: the two readers of the
telemetry sink's span events (on a card only; nothing from a program
without the spans), the profiler attribution of `program_spans` on made-up
events, `span_report` on the CPU at the tiny sizes, and on the card the
attribution of burst32k's device time (``-m card``)."""

import pytest
import torch

from gossipbench import program_spans, spec, span_report
from gossipbench.tests import tiny

SEED = 2**31 + 77


@pytest.fixture
def sink():
    from p2p_gossip_tpu_torch.telemetry import sink

    sink.reset()
    yield sink
    sink.reset()


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.write_root(str(tmp_path_factory.mktemp("tiny")))


def _reader(name):
    return spec.metric_reader(name)


def _run_flood(sink):
    """A small flood with spans on, as a traced window runs it."""
    import numpy as np

    import p2p_gossip_tpu_torch as pt
    from p2p_gossip_tpu_torch.engine import sync

    g = pt.erdos_renyi(64, 0.12, seed=0)
    rng = np.random.default_rng(0)
    sched = pt.Schedule(64, rng.integers(0, 64, 80).astype(np.int32),
                        rng.integers(0, 24, 80).astype(np.int32))
    sink.configure(None, rings=False)
    stats = sync.run_sync_sim(g, sched, 48, chunk_size=32, device="cpu")
    sink.close()
    return stats.extra["ticks_executed"]


def test_readers_read_the_sinks_spans(sink):
    ticks = _run_flood(sink)
    events = program_spans.sink_spans()
    secs = program_spans.seconds_by_name(events)
    assert program_spans.count_by_name(events)["tick"] == ticks
    rec = {"on_device": True, "sims": 2}
    assert _reader("tick_host_ms")(rec) == pytest.approx(
        (secs["tick"] - secs["sync"]) * 1e3 / ticks)
    assert _reader("entry_host_ms_per_sim.coverage")(rec) == pytest.approx(
        (secs["inputs"] + secs["d2h"] + secs["stats"]) * 1e3 / 2)
    for name in ("tick_host_ms", "entry_host_ms_per_sim"):
        assert _reader(name)(dict(rec, on_device=False)) is None


def test_readers_read_nothing_without_the_spans(sink):
    """A program with only its chunk spans (``dispatch``, ``d2h``), or a
    sink that never ran, gives no reading and raises nothing."""
    rec = {"on_device": True, "sims": 1}
    for name in ("tick_host_ms", "entry_host_ms_per_sim"):
        assert _reader(name)(rec) is None
    sink.configure(None, rings=False)
    for name in ("dispatch", "d2h"):
        sink.emit({"type": "span", "name": name, "ts": 0.0, "dur": 0.01, "depth": 0})
    sink.close()
    for name in ("tick_host_ms", "entry_host_ms_per_sim"):
        assert _reader(name)(rec) is None


class _Ev:
    """A profiler event as `kineto_results.events()` gives it."""

    def __init__(self, name, start, dur, cuda=False, corr=0, linked=0):
        self._v = (name, start, dur, cuda, corr, linked)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        from torch.autograd import DeviceType

        return DeviceType.CUDA if self._v[3] else DeviceType.CPU

    def is_user_annotation(self):
        return False

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]


def _made_up():
    """One tick (0-150, in ns): gather 10-40 launching op 1 (kernel 50-90),
    update 40-70 launching op 2 (kernel 90-130), sync 70-150; an op
    launched outside every span (kernel 200-210) and one unlinked."""
    return [
        _Ev("p2p.tick", 0, 150), _Ev("p2p.gather", 10, 30), _Ev("p2p.update", 40, 30),
        _Ev("p2p.sync", 70, 80),
        _Ev("aten::fill_", 12, 5, corr=1), _Ev("aten::bitwise_or", 45, 5, corr=2),
        _Ev("aten::add", 180, 5, corr=3),
        _Ev("gather_or_kernel", 50, 40, cuda=True, linked=1),
        _Ev("elementwise", 90, 40, cuda=True, linked=2),
        _Ev("elementwise", 200, 10, cuda=True, linked=3),
        _Ev("copy", 220, 10, cuda=True, linked=0),
    ]


def test_attribution_credits_the_innermost_span_at_launch():
    att = program_spans.Attribution(_made_up())
    by = att.device_by_span()
    assert by["gather"] == pytest.approx(40e-9) and by["update"] == pytest.approx(40e-9)
    assert by["unattributed"] == pytest.approx(20e-9) and "tick" not in by
    totals = att.span_totals()
    assert totals["tick"][0] == 1 and totals["tick"][1] == pytest.approx(150e-9)
    assert totals["tick"][2] == pytest.approx(10e-9)  # 150 less 30 + 30 + 80
    assert att.ops_by_span("gather") == {"gather_or_kernel": pytest.approx(40e-9)}
    assert att.sync_after_tick_work() == (1, 1)
    assert att.sync_margin_by_tenth()[0] == pytest.approx(20e-9)  # 150 - 130
    late = [e for e in _made_up() if e.name() != "p2p.sync"] + [_Ev("p2p.sync", 70, 50)]
    late = program_spans.Attribution(late)
    assert late.sync_after_tick_work() == (0, 1)
    assert late.sync_margin_by_tenth()[0] == pytest.approx(-10e-9)  # 120 - 130


@pytest.mark.parametrize("cell", ["flood.er100k.burst32k", "flood.ba1m.coverage4k",
                                  "flood.er100k.renewal"])
def test_span_report_counts_every_tick(root, cell, sink):
    torch.set_num_threads(1)
    out = span_report.measure(spec.cell(cell, root=root), SEED, 0.3, torch.device("cpu"))
    assert out["sims"] >= 1 and out["ticks"] > 0
    assert out["tick_spans"] == out["ticks"]
    for name in ("gather", "update", "sync"):
        assert out["spans"][name][0] == out["ticks"]
    assert out["stage_csr_s"] > 0 and out["stage_buckets_s"] > 0
    assert out["tick_host_ms"] > 0 and out["entry_host_ms_per_sim"] > 0
    assert out["device_by_span"] == {}


@pytest.mark.card
def test_burst32k_device_time_lands_in_its_spans(card):
    """On the card: every ``gather_or`` launch is credited to ``gather``;
    at most 1% of busy time is launched under no program span; on 99% of
    ticks the flag read ends after the tick's last device operation (the
    spans' clock and the device's agree). A 3 s profile: over 25 s the
    profiler's device timestamps were seen to drift up to 0.5 ms from its
    host ones (PERF.md)."""
    out = span_report.measure(spec.cell("flood.er100k.burst32k"), SEED, 3.0, card)
    assert out["tick_spans"] == out["ticks"] > 0
    assert out["gather_or_launches"] > 0
    assert out["gather_or_under_gather"] == out["gather_or_launches"]
    assert out["unattributed_share_of_busy"] <= 0.01, out["device_by_span"]
    ok, checked = out["sync_after_tick_work"]
    assert checked >= 0.99 * out["ticks"] and ok >= 0.99 * checked, (ok, checked)
