"""The port's telemetry layer against the JAX package's: with the rings on,
the ``ring`` and ``digest`` events of the flood, coverage and the three
random-partner protocols equal the JAX engine's value for value (every op
is integer: the tolerance is bitwise); results with telemetry on equal
results with it off, and the rings reconcile with the final counters;
with telemetry off the engines compute no row and no digest. Also the
host half: spans, enablement, the JSONL schema (validated by the JAX
package's validator and rendered by its run report), and the Chrome-trace
export.

The port runs on the CPU (its kernels' plain torch versions), the JAX
package on the CPU as its own tests run it."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import p2p_gossip_tpu as pg
import p2p_gossip_tpu_torch as pt
from p2p_gossip_tpu import telemetry as jax_tel
from p2p_gossip_tpu.engine import sync as jax_sync
from p2p_gossip_tpu.models import protocols as jax_protocols
from p2p_gossip_tpu.telemetry import chrometrace as jax_chrometrace
from p2p_gossip_tpu.telemetry import rings as jax_rings
from p2p_gossip_tpu.telemetry import schema as jax_schema
from p2p_gossip_tpu_torch import telemetry
from p2p_gossip_tpu_torch.engine import sync
from p2p_gossip_tpu_torch.models import protocols
from p2p_gossip_tpu_torch.ops import kernels
from p2p_gossip_tpu_torch.telemetry import chrometrace, digest, rings, schema
from p2p_gossip_tpu_torch.telemetry import spans as spans_mod

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, P = 64, 0.12
HORIZON = 48


@pytest.fixture(autouse=True)
def _clean_telemetry(monkeypatch):
    monkeypatch.delenv("P2P_TELEMETRY", raising=False)
    monkeypatch.delenv("P2P_HEARTBEAT", raising=False)
    for tel in (telemetry, jax_tel):
        tel.reset()
        tel.configure_heartbeat(None)
    yield
    for tel in (telemetry, jax_tel):
        tel.reset()
        tel.configure_heartbeat(None)


def _graphs():
    return pg.erdos_renyi(N, P, seed=0), pt.erdos_renyi(N, P, seed=0)


def _schedules(shares=80, window=24, seed=0):
    rng = np.random.default_rng(seed)
    origins = rng.integers(0, N, shares).astype(np.int32)
    ticks = rng.integers(0, window, shares).astype(np.int32)
    return pg.Schedule(N, origins, ticks), pt.Schedule(N, origins, ticks)


def _models(kind, horizon=HORIZON):
    """The same option models in both packages, from the same seeds."""
    if kind == "churn":
        kw = dict(outage_prob=0.3, mean_down_ticks=4, max_outages=2, seed=5)
        return pg.random_churn(N, horizon, **kw), pt.random_churn(N, horizon, **kw)
    p, seed = kind
    return pg.LinkLossModel(p, seed=seed), pt.LinkLossModel(p, seed=seed)


def _stream(tel, kinds=("ring", "digest")):
    return [e for e in tel.events() if e["type"] in kinds]


def _both_on(run_jax, run_port):
    """Each package's run with its rings on: (jax result, port result, jax
    ring+digest events, port ring+digest events)."""
    jax_tel.configure(None, rings=True)
    telemetry.configure(None, rings=True)
    want, got = run_jax(), run_port()
    return want, got, _stream(jax_tel), _stream(telemetry)


def _assert_same_events(want, got):
    assert want, "the JAX package emitted no ring or digest event"
    assert [(e["type"], e["kernel"], e.get("chunk")) for e in got] == [
        (e["type"], e["kernel"], e.get("chunk")) for e in want]
    for w, g in zip(want, got):
        if w["type"] == "ring":
            for col in schema.METRIC_COLUMNS:
                assert g["metrics"][col] == w["metrics"][col], (w["kernel"], col)
        assert g == w


# --- the flood and coverage, event for event ----------------------------------

def _flood_case(name):
    (gj, gp), (sj, sp) = _graphs(), _schedules()
    kw_j, kw_p = dict(chunk_size=32), dict(chunk_size=32)
    if name == "options":
        (cj, cp), (lj, lp) = _models("churn"), _models((0.2, 3))
        kw_j.update(churn=cj, loss=lj, connect_tick=10)
        kw_p.update(churn=cp, loss=lp, connect_tick=10)
    elif name == "lognormal":
        delays = pg.lognormal_delays(gj, 2.0, 0.5, 5, seed=0)
        kw_j.update(ell_delays=delays)
        kw_p.update(ell_delays=delays)
    return (lambda: jax_sync.run_sync_sim(gj, sj, HORIZON, **kw_j),
            lambda: sync.run_sync_sim(gp, sp, HORIZON, device="cpu", **kw_p))


@pytest.mark.parametrize("name", ["chunks", "options", "lognormal"])
def test_flood_events_equal_the_jax_engines(name):
    """run_sync_sim over three 32-share chunks: plain, under churn + loss
    0.2 + the connect window, and with log-normal per-edge delays."""
    run_jax, run_port = _flood_case(name)
    want, got, want_ev, got_ev = _both_on(run_jax, run_port)
    assert got.equal_counts(want)
    _assert_same_events(want_ev, got_ev)
    digests = [e for e in got_ev if e["type"] == "digest"]
    assert len(digests) == 3 and {e["chunk"] for e in digests} == {0, 1, 2}
    if name == "options":
        assert sum(sum(e["metrics"]["loss_dropped"]) for e in got_ev
                   if e["type"] == "ring") > 0


def test_coverage_events_equal_the_jax_engines():
    (gj, gp), (lj, lp) = _graphs(), _models((0.2, 7))
    want, got, want_ev, got_ev = _both_on(
        lambda: jax_sync.run_flood_coverage(gj, [0, 1, 2, 3], 32, loss=lj),
        lambda: sync.run_flood_coverage(gp, [0, 1, 2, 3], 32, loss=lp, device="cpu"),
    )
    np.testing.assert_array_equal(got[1], want[1])
    _assert_same_events(want_ev, got_ev)
    assert [e["ticks"] for e in got_ev if e["type"] == "digest"] == [32]


# --- the protocols -----------------------------------------------------------

def _protocol_runs(mode, record_coverage=True):
    """(jax run, port run) of ``mode`` on the small graph with loss 0.15,
    churn and coverage rows, 20 rounds, 32-share chunks."""
    (gj, gp), (sj, sp) = _graphs(), _schedules(shares=70, window=6)
    (cj, cp), (lj, lp) = _models("churn", 20), _models((0.15, 3))
    common = dict(seed=1, record_coverage=record_coverage, chunk_size=32)
    if mode == "pushk":
        return (lambda: jax_protocols.run_pushk_sim(gj, sj, 20, fanout=2, churn=cj, loss=lj,
                                                    **common),
                lambda: protocols.run_pushk_sim(gp, sp, 20, fanout=2, churn=cp, loss=lp,
                                                device="cpu", **common))
    return (lambda: jax_protocols.run_pushpull_sim(gj, sj, 20, mode=mode, churn=cj, loss=lj,
                                                   **common),
            lambda: protocols.run_pushpull_sim(gp, sp, 20, mode=mode, churn=cp, loss=lp,
                                               device="cpu", **common))


@pytest.mark.parametrize("mode", ["pushpull", "pull", "pushk"])
def test_protocol_events_equal_the_jax_engines(mode):
    want, got, want_ev, got_ev = _both_on(*_protocol_runs(mode))
    assert got[0].equal_counts(want[0])
    np.testing.assert_array_equal(got[1], want[1])
    _assert_same_events(want_ev, got_ev)
    kernel = f"models.protocols.{mode}"
    assert {e["kernel"] for e in got_ev} == {kernel}
    assert sum(sum(e["metrics"]["loss_dropped"]) for e in got_ev
               if e["type"] == "ring") > 0


# --- neutrality and reconciliation -------------------------------------------------

def _metric_sum(col):
    return sum(sum(e["metrics"][col]) for e in telemetry.events() if e["type"] == "ring")


def _port_runs():
    """Each engine of the port on the small graph: name -> run returning
    (stats, coverage or None)."""
    _, gp = _graphs()
    _, sp = _schedules()
    _, lp = _models((0.2, 7))
    runs = {
        "flood": lambda: (sync.run_sync_sim(gp, sp, HORIZON, chunk_size=32, device="cpu"),
                          None),
        "coverage": lambda: sync.run_flood_coverage(gp, [0, 1, 2, 3], 32, loss=lp,
                                                    device="cpu"),
    }
    for mode in ("pushpull", "pull", "pushk"):
        runs[mode] = _protocol_runs(mode)[1]
    return runs


@pytest.mark.parametrize("name", ["flood", "coverage", "pushpull", "pull", "pushk"])
def test_results_with_telemetry_equal_results_without(name):
    """Results with the rings on equal results with them off; the rings'
    newly_infected sums to the run's received, and frontier_bits to
    received + generated (every bit that entered a seen-set)."""
    run = _port_runs()[name]
    base_stats, base_cov = run()
    telemetry.configure(None, rings=True)
    stats, cov = run()
    assert stats.equal_counts(base_stats)
    assert stats.extra.get("ticks_executed") == base_stats.extra.get("ticks_executed")
    if base_cov is not None:
        np.testing.assert_array_equal(cov, base_cov)
    received = int(stats.received.sum())
    assert received > 0
    assert _metric_sum("newly_infected") == received
    if name != "coverage":
        assert _metric_sum("frontier_bits") == received + int(stats.generated.sum())


def test_telemetry_off_computes_no_row_and_no_digest(monkeypatch):
    """With telemetry off every engine runs with the row builders and the
    digest raising; with it on, the same runs reach them."""
    def boom(*args, **kwargs):
        raise AssertionError("telemetry work with telemetry off")

    monkeypatch.setattr(digest, "write", boom)
    monkeypatch.setattr(kernels, "tick_digest", boom)
    monkeypatch.setattr(rings, "flood_row", boom)
    monkeypatch.setattr(rings, "row", boom)
    runs = _port_runs()
    for run in runs.values():
        run()
    telemetry.configure(None, rings=True)
    for run in runs.values():
        with pytest.raises(AssertionError, match="telemetry work"):
            run()
    # Spans only (rings=False) leave the tick untouched too.
    telemetry.configure(None, rings=False)
    for run in runs.values():
        run()
    assert not _stream(telemetry)
    assert {e["type"] for e in telemetry.events()} == {"meta", "span", "progress"}


def test_last_digest_is_the_digest_of_the_final_state():
    """The flood chunk's last digest equals the plain digest of the state
    the chunk ends in (the numpy twin's too)."""
    _, gp = _graphs()
    _, sp = _schedules(shares=20)
    dg = sync.DeviceGraph.build(gp, device="cpu")
    origins, gen_ticks = sp.padded(32, HORIZON)
    ring_pair = rings.chunk_rings(HORIZON, dg.device)
    seen, received, sent, _, ticks = sync._run_chunk_while(
        dg, torch.as_tensor(origins.astype(np.int64)), torch.as_tensor(gen_ticks),
        int(gen_ticks.min()), int(gen_ticks[gen_ticks < HORIZON].max()),
        chunk_size=32, horizon=HORIZON, rings=ring_pair,
    )
    last = int(ring_pair[1][int(gen_ticks.min()) + ticks - 1]) & 0xFFFFFFFF
    assert last == int(kernels.tick_digest_plain(seen, received, sent))
    assert last == digest.tick_digest_np(
        seen.numpy().view(np.uint32), received.numpy(), sent.numpy())


# --- spans, enablement, the stream ------------------------------------------------

def test_span_nesting_and_monotonic_clock():
    telemetry.configure(None, rings=False)
    with telemetry.span("outer", phase="x"):
        with telemetry.span("inner"):
            pass
        with telemetry.span("inner2"):
            pass
    spans = [e for e in telemetry.events() if e["type"] == "span"]
    by_name = {s["name"]: s for s in spans}
    assert [s["name"] for s in spans] == ["inner", "inner2", "outer"]
    assert by_name["outer"]["depth"] == 0
    assert by_name["inner"]["depth"] == by_name["inner2"]["depth"] == 1
    for s in spans:
        assert s["ts"] >= 0 and s["dur"] >= 0
    outer = by_name["outer"]
    assert outer["dur"] >= by_name["inner"]["dur"] + by_name["inner2"]["dur"]
    assert by_name["inner2"]["ts"] >= by_name["inner"]["ts"] >= outer["ts"]
    assert outer["attrs"] == {"phase": "x"}


def test_span_records_error_attr():
    telemetry.configure(None, rings=False)
    with pytest.raises(ValueError):
        with telemetry.span("boom"):
            raise ValueError("x")
    (s,) = [e for e in telemetry.events() if e["type"] == "span"]
    assert s["attrs"]["error"] == "ValueError"


def test_off_by_default():
    with telemetry.span("never"):
        pass
    assert not telemetry.enabled() and not telemetry.rings_enabled()
    assert telemetry.events() == []


def test_span_set_adds_counted_attrs():
    telemetry.configure(None, rings=False)
    with telemetry.span("d2h", chunk=2) as sp:
        sp.set(bytes=64)
    (s,) = [e for e in telemetry.events() if e["type"] == "span"]
    assert s["attrs"] == {"chunk": 2, "bytes": 64}


def test_spans_off_share_one_context_and_read_no_clock(monkeypatch):
    """With telemetry off every span is the one shared no-op context, and a
    whole flood and coverage run read no clock through the spans module."""
    off = telemetry.span("tick")
    assert all(telemetry.span(n, k=1) is off for n in ("gather", "update", "sync", "x"))
    with off as sp:
        sp.set(ticks=3)

    class NoClock:
        @staticmethod
        def perf_counter():
            raise AssertionError("a span read the clock with telemetry off")

    monkeypatch.setattr(spans_mod, "time", NoClock)
    runs = _port_runs()
    for name in ("flood", "coverage"):
        runs[name]()
    assert telemetry.events() == []


# --- the flood engine's spans: tick phases and the entry's host work ---------------

def _loop_ticks_from_coverage(cov, ring_size, last_gen=0):
    """The coverage loop's stop rule over its rows: tick t ran a frontier iff
    its row grew (tick 0 generates); the loop runs while a frontier of the
    last ``ring_size`` ticks is in flight or a generation is pending."""
    busy = np.ones(cov.shape[0], dtype=bool)
    busy[1:] = (cov[1:] != cov[:-1]).any(axis=1)
    t = 0
    while t < cov.shape[0] and (busy[max(t - ring_size, 0):t].any() or t <= last_gen):
        t += 1
    return t


def _entry_spans(kind):
    """One run of the flood (``while``, three chunks) or coverage entry
    with spans on: (its span events, the ticks its loop ran by the
    entry's own account, the dispatch spans' ``ticks`` sum or None)."""
    _, gp = _graphs()
    telemetry.configure(None, rings=False)
    if kind == "while":
        _, sp = _schedules()
        stats = sync.run_sync_sim(gp, sp, HORIZON, chunk_size=32, device="cpu")
        ticks = stats.extra["ticks_executed"]
    else:
        _, cov = sync.run_flood_coverage(gp, [0, 1, 2, 3], 32, device="cpu")
        ticks = _loop_ticks_from_coverage(cov, sync.DeviceGraph.build(gp, device="cpu")
                                          .ring_size)
    events = [e for e in telemetry.events() if e["type"] == "span"]
    dispatched = [e["attrs"].get("ticks") for e in events if e["name"] == "dispatch"]
    return events, ticks, (sum(dispatched) if kind == "while" else None)


def _inside(inner, outer):
    return (outer["ts"] <= inner["ts"]
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1e-9)


@pytest.mark.parametrize("kind", ["while", "coverage"])
def test_tick_spans_nest_and_count_the_loops_ticks(kind):
    """Each ``tick`` span holds exactly one ``gather``, ``update`` and
    ``sync`` one level down; the ``tick`` spans number the ticks the loop
    ran (``ticks_executed``, or the coverage rows' stop rule), as do the
    dispatch spans' ``ticks``; the entry's host work has its spans."""
    events, ticks, dispatched = _entry_spans(kind)
    by = {}
    for e in events:
        by.setdefault(e["name"], []).append(e)
    assert ticks > 0 and len(by["tick"]) == ticks
    if dispatched is not None:
        assert dispatched == ticks
    for name in ("gather", "update", "sync"):
        assert len(by[name]) == ticks
    for tick in by["tick"]:
        for name in ("gather", "update", "sync"):
            (child,) = [e for e in by[name] if _inside(e, tick)]
            assert child["depth"] == tick["depth"] + 1
    assert all(t["depth"] == by["dispatch"][0]["depth"] + 1 for t in by["tick"])
    assert {"inputs", "d2h", "stats", "stage.buckets"} <= set(by)
    assert all(e["attrs"]["bytes"] > 0 for e in by["d2h"])


@pytest.mark.parametrize("on", [True, False])
def test_spans_mirror_onto_the_profiler(on):
    """Under torch.profiler each span is a ``p2p.<name>`` range nested in
    its parent's, one a span event; with the sink off there is none."""
    _, gp = _graphs()
    _, sp = _schedules(shares=40)
    if on:
        telemetry.configure(None, rings=False)
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        pt.Graph.from_edges(gp.n, gp.edges())
        sync.run_sync_sim(gp, sp, HORIZON, chunk_size=32, device="cpu")
    ranges = sorted(((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()[4:])
                     for e in prof.profiler.kineto_results.events()
                     if e.name().startswith("p2p.")), key=lambda r: (r[0], -r[1]))
    if not on:
        assert ranges == []
        return
    want = {}
    for e in telemetry.events():
        if e["type"] == "span":
            want[e["name"]] = want.get(e["name"], 0) + 1
    got = {}
    for _, _, name in ranges:
        got[name] = got.get(name, 0) + 1
    assert got == want and want["tick"] > 0 and want["stage.csr"] == 1
    parent = {"tick": "dispatch", "gather": "tick", "update": "tick", "sync": "tick"}
    stack = []
    for s, e, name in ranges:
        while stack and stack[-1][1] < e:
            stack.pop()
        if name in parent:
            assert stack and stack[-1][2] == parent[name], (name, stack[-1:])
        stack.append((s, e, name))


def test_env_var_enables(tmp_path, monkeypatch):
    stream = tmp_path / "env.jsonl"
    monkeypatch.setenv("P2P_TELEMETRY", str(stream))
    telemetry.reset()  # re-arm the environment check
    assert telemetry.enabled() and telemetry.rings_enabled()
    assert json.loads(stream.read_text().splitlines()[0])["type"] == "meta"


def test_the_schema_is_the_jax_packages():
    assert schema.SCHEMA_VERSION == jax_schema.SCHEMA_VERSION == 2
    assert schema.METRIC_COLUMNS == jax_schema.METRIC_COLUMNS
    assert len(schema.METRIC_COLUMNS) == schema.NUM_METRICS == 9
    assert schema.EVENT_TYPES == jax_schema.EVENT_TYPES
    ok_ring = {
        "type": "ring", "kernel": "k", "t0": 0, "ticks": 2,
        "columns": list(schema.METRIC_COLUMNS),
        "metrics": {c: [1, 2] for c in schema.METRIC_COLUMNS},
    }
    assert schema.validate_event(ok_ring) == []
    assert schema.validate_event(dict(ok_ring, ticks=3))
    assert schema.validate_event({"type": "nope"})


def test_stream_validates_and_renders_in_the_jax_tools(tmp_path):
    """A port stream (flood, coverage and push-pull) passes the JAX
    package's validate_stream, and scripts/run_report.py renders it."""
    stream = tmp_path / "port.jsonl"
    telemetry.configure(str(stream), rings=True)
    runs = _port_runs()
    for name in ("flood", "coverage", "pushpull"):
        runs[name]()
    telemetry.close()
    lines = stream.read_text().splitlines()
    assert jax_schema.validate_stream(lines) == []
    assert schema.validate_stream(lines) == []
    kinds = {json.loads(line)["type"] for line in lines}
    assert {"meta", "span", "ring", "digest", "progress"} <= kinds
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "run_report.py"), str(stream)],
        capture_output=True, text=True, timeout=120, env=env, cwd=REPO,
    )
    assert proc.returncode == 0, proc.stderr[-800:]
    for kernel in ("engine.sync.run_sync_sim", "engine.sync.run_flood_coverage",
                   "models.protocols.pushpull"):
        assert kernel in proc.stdout


def test_chrome_trace_round_trip():
    telemetry.configure(None, rings=True)
    _port_runs()["flood"]()
    events = telemetry.events()
    trace = chrometrace.to_chrome_trace(events)
    spans_in = sorted((e for e in events if e["type"] == "span"), key=lambda s: s["ts"])
    spans_out = sorted(chrometrace.spans_from_chrome(trace), key=lambda s: s["ts"])
    assert len(spans_out) == len(spans_in) > 0
    for a, b in zip(spans_in, spans_out):
        assert (a["name"], a["depth"]) == (b["name"], b["depth"])
        assert abs(a["dur"] - b["dur"]) < 1e-6
    pid2 = [r for r in trace["traceEvents"] if r.get("ph") == "C" and r.get("pid") == 2]
    n_ring = sum(len(s) for e in events if e["type"] == "ring" for s in e["metrics"].values())
    n_digest = sum(len(e["values"]) for e in events if e["type"] == "digest")
    assert len([r for r in pid2 if not r["name"].startswith("digest:")]) == n_ring > 0
    assert len([r for r in pid2 if r["name"].startswith("digest:")]) == n_digest > 0
    assert chrometrace.to_chrome_trace(events) == jax_chrometrace.to_chrome_trace(events)


def test_emit_ring_trims_trailing_zeros():
    telemetry.configure(None, rings=True)
    ring = np.zeros((8, schema.NUM_METRICS), dtype=np.int64)
    ring[1] = 3
    rings.emit_ring("k", ring, t0=0)
    (ev,) = _stream(telemetry, ("ring",))
    assert ev["ticks"] == 2 and schema.validate_event(ev) == []


@pytest.mark.parametrize("t0,ticks", [(0, None), (2, None), (0, 6), (2, 3), (3, 0), (6, 2)])
def test_emit_ring_slices_as_the_jax_package(t0, ticks):
    """Given or not, ``ticks`` is trimmed of trailing zero rows and never
    below 1 row, as the JAX package's ``emit_ring`` slices."""
    ring = np.zeros((8, schema.NUM_METRICS), dtype=np.int64)
    ring[1], ring[3, 2], ring[4, 0] = 5, 7, 0xFFFFFFFF
    for tel, emit in ((jax_tel, jax_rings.emit_ring), (telemetry, rings.emit_ring)):
        tel.configure(None, rings=True)
        emit("k", ring, t0=t0, ticks=ticks, chunk=1)
    assert _stream(telemetry, ("ring",)) == _stream(jax_tel, ("ring",))


def test_row_writes_its_columns_in_place():
    """``row`` writes the five counted columns (and ``loss_dropped`` when it
    is a tensor) into its row of the ring and leaves the rest zero."""
    ring, _ = rings.chunk_rings(4, "cpu")
    cols = [torch.tensor(v, dtype=torch.int64) for v in (9, 3, 2, 0xFFFFFFFF, 17)]
    rings.row(ring, 1, *cols)
    rings.row(ring, 2, *cols, loss_dropped=torch.tensor(4, dtype=torch.int64))
    assert ring[1].tolist() == [9, 3, 2, 0xFFFFFFFF, 17, 0, 0, 0, 0]
    assert ring[2].tolist() == [9, 3, 2, 0xFFFFFFFF, 17, 4, 0, 0, 0]
    assert not ring[0].any() and not ring[3].any()
