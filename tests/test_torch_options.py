"""The port's flood-engine options against the JAX package's sync engine.

Churn, link loss, the connect window, periodic snapshots, checkpoint/resume
and the serialization delay model: each case is one of the JAX package's
own cases (tests/test_churn.py, test_linkloss.py, test_sync_engine.py),
run by the JAX sync engine on the CPU and by the port with
``device="cpu"`` (its kernels' plain torch versions) on graphs, schedules
and models the port builds from the same seeds. Counters,
``ticks_executed``, snapshots and coverage rows must be bitwise equal, on
the full-width staging the engine picks at these sizes and on a bucketed
one.
"""

import numpy as np
import pytest

import p2p_gossip_tpu as pg
import p2p_gossip_tpu_torch as pt
from p2p_gossip_tpu.engine.event import run_event_sim
from p2p_gossip_tpu.engine.sync import run_flood_coverage as jax_flood_coverage
from p2p_gossip_tpu.engine.sync import run_sync_sim as jax_sync_sim
from p2p_gossip_tpu.models import churn as jchurn
from p2p_gossip_tpu.models import latency as jlatency
from p2p_gossip_tpu.models.linkloss import LinkLossModel as JaxLoss
from p2p_gossip_tpu_torch.engine.sync import (
    DeviceGraph,
    run_flood_coverage,
    run_sync_sim,
)
from p2p_gossip_tpu_torch.models import churn, latency
from p2p_gossip_tpu_torch.models.linkloss import LinkLossModel

FIELDS = ("generated", "received", "forwarded", "sent", "processed", "degree")


def _same(port, want):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(port, f), getattr(want, f), err_msg=f)


def _check(port, want):
    _same(port, want)
    assert port.extra["ticks_executed"] == want.extra["ticks_executed"]
    assert port.extra.get("snapshots") == want.extra.get("snapshots")


def _run_both(case, *, bucketed, **opts):
    """(port stats, JAX stats) for one case: a dict of the port's and the
    JAX package's graph, schedule and delays, plus options in both forms."""
    dg = None
    if bucketed:
        dg = DeviceGraph.build(case["g"], case.get("d"), bucketed=True, device="cpu")
        assert dg.buckets is not None
    port_opts = {k: v[0] for k, v in opts.items()}
    jax_opts = {k: v[1] for k, v in opts.items()}
    port = run_sync_sim(
        case["g"], case["sched"], case["horizon"], ell_delays=case.get("d"),
        device_graph=dg, device="cpu", **case.get("kw", {}), **port_opts,
    )
    want = jax_sync_sim(
        case["jg"], case["jsched"], case["horizon"], ell_delays=case.get("jd"),
        **case.get("kw", {}), **jax_opts,
    )
    return port, want


def _er_case(n, p, seed, sim_time, tick_dt, horizon, **kw):
    return dict(
        g=pt.erdos_renyi(n, p, seed=seed), jg=pg.erdos_renyi(n, p, seed=seed),
        sched=pt.uniform_renewal_schedule(n, sim_time=sim_time, tick_dt=tick_dt, seed=seed),
        jsched=pg.uniform_renewal_schedule(n, sim_time=sim_time, tick_dt=tick_dt, seed=seed),
        horizon=horizon, kw=kw,
    )


def _with_lognormal(case, **dkw):
    case["d"] = latency.lognormal_delays(case["g"], **dkw)
    case["jd"] = jlatency.lognormal_delays(case["jg"], **dkw)
    np.testing.assert_array_equal(case["d"], case["jd"])
    return case


def _churn_pair(n, horizon, seed, **kw):
    port = churn.random_churn(n, horizon, seed=seed, **kw)
    want = jchurn.random_churn(n, horizon, seed=seed, **kw)
    return port, want


def _loss_pair(prob, seed):
    return LinkLossModel(prob, seed=seed), JaxLoss(prob, seed=seed)


# --- churn (tests/test_churn.py:74-111) -------------------------------------

@pytest.mark.parametrize("bucketed", [False, True])
@pytest.mark.parametrize("per_edge", [False, True])
def test_churn_parity(per_edge, bucketed):
    seed = 2 if per_edge else 1
    case = _er_case(80, 0.06, seed, 6.0, 0.01, 600, chunk_size=96 if per_edge else 64)
    if per_edge:
        _with_lognormal(case, mean_ticks=2.0, sigma=0.5, max_ticks=4, seed=2)
    cm = _churn_pair(80, 600, seed + 1, outage_prob=0.4, mean_down_ticks=120.0,
                     max_outages=2)
    port, want = _run_both(case, bucketed=bucketed, churn=cm)
    _check(port, want)
    port.check_conservation()
    # Churn changed something here.
    base = run_sync_sim(case["g"], case["sched"], 600, ell_delays=case.get("d"),
                        device="cpu", **case["kw"])
    assert not base.equal_counts(port)


def test_share_lost_then_delivered_by_slower_path():
    """0-1 direct (delay 1) and 0-2-1 (delays 2 + 2): node 1 is down when
    the direct copy lands and still gets the share through node 2."""
    edges = np.array([[0, 1], [0, 2], [1, 2]])
    g, jg = pt.Graph.from_edges(3, edges), pg.Graph.from_edges(3, edges)
    ell_idx, ell_mask = g.ell()
    delays = np.ones_like(ell_idx)
    for i in range(3):
        for j in range(ell_idx.shape[1]):
            if ell_mask[i, j] and {i, int(ell_idx[i, j])} != {0, 1}:
                delays[i, j] = 2
    one = np.array([0])
    cm = churn.from_intervals(3, [(1, 1, 2)])
    port = run_sync_sim(g, pt.Schedule(3, one, one), 50, ell_delays=delays,
                        churn=cm, device="cpu")
    jsched = pg.Schedule(3, one, one)
    jcm = jchurn.from_intervals(3, [(1, 1, 2)])
    _check(port, jax_sync_sim(jg, jsched, 50, ell_delays=delays, churn=jcm))
    assert port.equal_counts(run_event_sim(jg, jsched, 50, ell_delays=delays, churn=jcm))
    assert port.received[1] == 1 and port.received[2] == 1


def test_permanently_down_node_is_inert():
    g = pt.ring_graph(6)
    sched = pt.uniform_renewal_schedule(6, sim_time=4.0, tick_dt=0.01, seed=0)
    cm = churn.from_intervals(6, [(2, 0, 10**6)])
    port = run_sync_sim(g, sched, 400, churn=cm, device="cpu")
    want = jax_sync_sim(
        pg.ring_graph(6), pg.uniform_renewal_schedule(6, sim_time=4.0, tick_dt=0.01, seed=0),
        400, churn=jchurn.from_intervals(6, [(2, 0, 10**6)]),
    )
    _check(port, want)
    assert port.generated[2] == port.received[2] == port.sent[2] == 0
    port.check_conservation()


# --- link loss (tests/test_linkloss.py:60-130) ------------------------------

@pytest.mark.parametrize("bucketed", [False, True])
@pytest.mark.parametrize("prob", [0.15, 0.6])
def test_loss_parity(prob, bucketed):
    case = _er_case(70, 0.08, 2, 8.0, 0.01, 800, chunk_size=64)
    port, want = _run_both(case, bucketed=bucketed, loss=_loss_pair(prob, 11))
    _check(port, want)
    port.check_conservation()
    lossless = run_sync_sim(case["g"], case["sched"], 800, chunk_size=64, device="cpu")
    assert port.received.sum() < lossless.received.sum()


@pytest.mark.parametrize("bucketed", [False, True])
def test_loss_parity_per_edge_delays(bucketed):
    case = _with_lognormal(_er_case(60, 0.1, 6, 6.0, 0.01, 600, chunk_size=64),
                           mean_ticks=2.0, sigma=0.5, max_ticks=6, seed=6)
    port, want = _run_both(case, bucketed=bucketed, loss=_loss_pair(0.3, 3))
    _check(port, want)


@pytest.mark.parametrize("bucketed", [False, True])
def test_total_loss_blocks_all_deliveries(bucketed):
    case = _er_case(40, 0.2, 1, 6.0, 0.01, 600, chunk_size=64)
    port, want = _run_both(case, bucketed=bucketed, loss=_loss_pair(1.0, 0))
    _check(port, want)
    assert port.received.sum() == 0
    assert port.sent.sum() == (port.generated * port.degree).sum()


@pytest.mark.parametrize("bucketed", [False, True])
def test_flood_coverage_under_loss_and_churn(bucketed):
    """Coverage rows under loss (and loss with churn) equal the JAX
    engine's, and the final row equals the event engine's arrivals."""
    g, jg = pt.erdos_renyi(50, 0.1, seed=9), pg.erdos_renyi(50, 0.1, seed=9)
    loss, jloss = _loss_pair(0.5, 2)
    origins = [0, 7, 21]
    dg = DeviceGraph.build(g, bucketed=bucketed, device="cpu")
    stats, cov = run_flood_coverage(g, origins, 80, device_graph=dg, loss=loss,
                                    device="cpu")
    jstats, jcov = jax_flood_coverage(jg, origins, 80, loss=jloss)
    np.testing.assert_array_equal(cov, jcov)
    _same(stats, jstats)
    ev = run_event_sim(
        jg, pg.Schedule(50, np.asarray(origins, np.int32), np.zeros(3, np.int32)),
        80, coverage_slots=3, loss=jloss,
    )
    np.testing.assert_array_equal(cov[-1], (ev.extra["arrival_ticks"] >= 0).sum(axis=1))
    cm, jcm = _churn_pair(50, 80, 5, outage_prob=0.5, mean_down_ticks=4.0, max_outages=2)
    stats, cov = run_flood_coverage(g, origins, 80, device_graph=dg, loss=loss,
                                    churn=cm, device="cpu")
    jstats, jcov = jax_flood_coverage(jg, origins, 80, loss=jloss, churn=jcm)
    np.testing.assert_array_equal(cov, jcov)
    _same(stats, jstats)
    assert (np.diff(cov, axis=0) >= 0).all()


# --- connect window ---------------------------------------------------------

@pytest.mark.parametrize("bucketed", [False, True])
@pytest.mark.parametrize("connect_tick", [35, 400])
def test_connect_tick_parity(connect_tick, bucketed):
    """Generations before the connect tick stay with their origin: equal
    counters and ticks (the in-flight flag must not count them), against
    the JAX engine and the event engine. At 400 every generation falls in
    the window and nothing is ever sent."""
    case = _er_case(60, 0.08, 3, 5.0, 0.1, 120, chunk_size=64)
    port, want = _run_both(case, bucketed=bucketed,
                           connect_tick=(connect_tick, connect_tick))
    _check(port, want)
    ev = run_event_sim(case["jg"], case["jsched"], 120, connect_tick=connect_tick)
    assert port.equal_counts(ev)
    if connect_tick == 400:
        assert port.sent.sum() == 0 and port.extra["ticks_executed"] < 120


# --- snapshots (tests/test_sync_engine.py:121-185) --------------------------

@pytest.mark.parametrize("bucketed", [False, True])
def test_snapshot_parity(bucketed):
    case = _er_case(90, 0.06, 5, 10.0, 0.01, 1000)
    b = [250, 400, 600, 900, 1000]
    port, want = _run_both(case, bucketed=bucketed, snapshot_ticks=(b, b))
    _check(port, want)
    processed = [s["processed"] for s in port.extra["snapshots"]]
    assert processed == sorted(processed) and processed[-1] == port.totals()["processed"]


def test_snapshot_boundary_past_horizon_dropped():
    case = _er_case(40, 0.1, 1, 1.0, 0.005, 200)
    b = [100, 250]
    port, want = _run_both(case, bucketed=False, snapshot_ticks=(b, b))
    _check(port, want)
    assert len(port.extra["snapshots"]) == 1


def test_snapshots_all_past_horizon_empty_list():
    case = _er_case(30, 0.15, 2, 0.5, 0.005, 100)
    port, want = _run_both(case, bucketed=False, snapshot_ticks=([500], [500]))
    _check(port, want)
    assert port.extra["snapshots"] == []


@pytest.mark.parametrize("bucketed", [False, True])
def test_snapshot_multi_chunk_and_resume(tmp_path, bucketed):
    """Snapshots add up across share chunks, and survive a checkpoint
    interrupt and resume in the port."""
    case = _er_case(80, 0.08, 7, 10.0, 0.01, 1000, chunk_size=128)
    assert case["sched"].num_shares > 128
    b = [300, 600, 800]
    port, want = _run_both(case, bucketed=bucketed, snapshot_ticks=(b, b))
    _check(port, want)
    ckpt = str(tmp_path / "snap.npz")
    dg = DeviceGraph.build(case["g"], bucketed=bucketed, device="cpu")
    kw = dict(chunk_size=128, snapshot_ticks=b, checkpoint_path=ckpt,
              device_graph=dg, device="cpu")
    part = run_sync_sim(case["g"], case["sched"], 1000, stop_after_chunks=1, **kw)
    assert part.totals()["processed"] < want.totals()["processed"]
    resumed = run_sync_sim(case["g"], case["sched"], 1000, **kw)
    _same(resumed, want)
    assert resumed.extra["snapshots"] == want.extra["snapshots"]


# --- every option at once, and the serialization delay model ----------------

@pytest.mark.parametrize("bucketed", [False, True])
def test_all_options_per_edge(bucketed):
    case = _with_lognormal(_er_case(70, 0.08, 4, 3.0, 0.01, 400, chunk_size=64),
                           mean_ticks=2.0, sigma=0.5, max_ticks=5, seed=4)
    b = [150, 250, 300, 390]
    port, want = _run_both(
        case, bucketed=bucketed,
        churn=_churn_pair(70, 400, 8, outage_prob=0.3, mean_down_ticks=20.0,
                          max_outages=2),
        loss=_loss_pair(0.2, 5), connect_tick=(230, 230), snapshot_ticks=(b, b),
    )
    _check(port, want)


@pytest.mark.parametrize("bucketed", [False, True])
def test_serialization_delay_model(bucketed):
    """8,000-byte shares at 5 Mbps on 5 ms ticks: 4 ticks a hop, uniform,
    so the uniform-delay path runs with ring D = 5."""
    case = _er_case(60, 0.1, 4, 5.0, 0.01, 500, chunk_size=32)
    kw = dict(message_bytes=8_000, bandwidth_mbps=5.0, tick_dt=0.005)
    case["d"] = latency.serialization_delays(case["g"], **kw)
    case["jd"] = jlatency.serialization_delays(case["jg"], **kw)
    np.testing.assert_array_equal(case["d"], case["jd"])
    assert int(case["d"].max()) == 4
    port, want = _run_both(case, bucketed=bucketed)
    _check(port, want)


# --- the checkpoint crosses between the packages ----------------------------

def _ckpt_case():
    """Three 64-share chunks with churn, loss, the connect window and
    snapshots on, so every part of the fingerprint is in play."""
    case = _with_lognormal(_er_case(60, 0.1, 12, 15.0, 0.05, 300, chunk_size=64),
                           mean_ticks=2.0, sigma=0.5, max_ticks=4, seed=12)
    assert case["sched"].num_shares > 128
    b = [100, 200, 290]
    opts = dict(
        churn=_churn_pair(60, 300, 3, outage_prob=0.3, mean_down_ticks=15.0,
                          max_outages=2),
        loss=_loss_pair(0.1, 9), connect_tick=(150, 150), snapshot_ticks=(b, b),
    )
    return case, opts


def _port_run(case, opts, **kw):
    return run_sync_sim(
        case["g"], case["sched"], case["horizon"], ell_delays=case["d"],
        device="cpu", **case["kw"], **{k: v[0] for k, v in opts.items()}, **kw,
    )


def _jax_run(case, opts, **kw):
    return jax_sync_sim(
        case["jg"], case["jsched"], case["horizon"], ell_delays=case["jd"],
        **case["kw"], **{k: v[1] for k, v in opts.items()}, **kw,
    )


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_crosses_packages(tmp_path, writer):
    """One package stops after a chunk, the other resumes from its file to
    the JAX package's uninterrupted counters and snapshots. The port's
    resume runs on a bucketed staging: the fingerprint reads the delays in
    canonical order, so the layout does not matter."""
    case, opts = _ckpt_case()
    want = _jax_run(case, opts)
    ckpt = str(tmp_path / "run.npz")
    dg = DeviceGraph.build(case["g"], case["d"], bucketed=True, device="cpu")
    if writer == "jax":
        _jax_run(case, opts, checkpoint_path=ckpt, stop_after_chunks=1)
        got = _port_run(case, opts, checkpoint_path=ckpt, device_graph=dg)
    else:
        _port_run(case, opts, checkpoint_path=ckpt, stop_after_chunks=1, device_graph=dg)
        got = _jax_run(case, opts, checkpoint_path=ckpt)
    _same(got, want)
    assert got.extra["snapshots"] == want.extra["snapshots"]
    # The resumed call ran only the chunks after the first.
    assert got.extra["ticks_executed"] < want.extra["ticks_executed"]


def test_checkpoint_of_another_run_starts_fresh(tmp_path, capsys):
    """A checkpoint from a different seed is ignored on both sides: each
    package's run equals its uninterrupted run, and each resuming side
    prints the ``Checkpoint`` component's warning to stderr."""
    case, opts = _ckpt_case()
    other_opts = dict(opts, loss=_loss_pair(0.1, 10))
    for stop, resume, label in (
        (_jax_run, _port_run, "jax wrote"), (_port_run, _jax_run, "port wrote"),
    ):
        ckpt = str(tmp_path / f"{label.split()[0]}.npz")
        stop(case, other_opts, checkpoint_path=ckpt, stop_after_chunks=1)
        got = resume(case, opts, checkpoint_path=ckpt)
        want = _jax_run(case, opts)
        _check(got, want)
    warned = [ln for ln in capsys.readouterr().err.splitlines()
              if "fingerprint mismatch" in ln]
    assert len(warned) == 2 and all(ln.startswith("[Checkpoint] WARN: ") for ln in warned)
