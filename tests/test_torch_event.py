"""The port's event engine (``p2p_gossip_tpu_torch.engine.event``) against
the JAX package's: the same seeded graphs, schedules and option models
give equal counters, snapshots, coverage arrival ticks, message records,
event counts and per-tick hook calls. Both run on the host; the inputs are
built by each package's own builders from the same seeds (the builders are
held equal in tests/test_torch_models.py). Also the NS-3 parity the JAX
tests check: the event engine equals the port's tick engine on the CPU."""

import numpy as np
import pytest

import p2p_gossip_tpu as pg
import p2p_gossip_tpu_torch as pt
from p2p_gossip_tpu.engine import event as jax_event
from p2p_gossip_tpu.models import churn as jax_churn
from p2p_gossip_tpu.models import latency as jax_latency
from p2p_gossip_tpu.models.linkloss import LinkLossModel as JaxLoss
from p2p_gossip_tpu_torch.engine import event
from p2p_gossip_tpu_torch.engine.sync import run_sync_sim
from p2p_gossip_tpu_torch.models import churn, latency

FIELDS = ("generated", "received", "forwarded", "sent", "processed", "degree")


def _graphs(kind, n, seed):
    if kind == "er":
        return pt.erdos_renyi(n, 0.08, seed=seed), pg.erdos_renyi(n, 0.08, seed=seed)
    if kind == "ba":
        m = min(2, n - 1)
        return pt.barabasi_albert(n, m=m, seed=seed), pg.barabasi_albert(n, m=m, seed=seed)
    return pt.ring_graph(n), pg.ring_graph(n)


def _schedules(model, n, seed):
    if model == "uniform":
        return (pt.uniform_renewal_schedule(n, sim_time=3.0, tick_dt=0.01, seed=seed),
                pg.uniform_renewal_schedule(n, sim_time=3.0, tick_dt=0.01, seed=seed))
    return (pt.poisson_schedule(n, sim_time=3.0, tick_dt=0.01, rate=0.6, seed=seed),
            pg.poisson_schedule(n, sim_time=3.0, tick_dt=0.01, rate=0.6, seed=seed))


def _same(got, want):
    for field in FIELDS:
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
    assert set(got.extra) == set(want.extra)
    for key, value in want.extra.items():
        if isinstance(value, np.ndarray):
            np.testing.assert_array_equal(got.extra[key], value)
        else:
            assert got.extra[key] == value, key


CASES = [
    # (graph, n, schedule, delays, churn, loss, connect_tick, fifo bytes)
    ("er", 2, "uniform", "constant", False, 0.0, 0, None),
    ("er", 60, "uniform", "constant", False, 0.0, 0, None),
    ("er", 60, "poisson", "lognormal", True, 0.2, 0, None),
    ("ba", 120, "uniform", "lognormal", False, 0.1, 40, None),
    ("ba", 200, "poisson", "constant", True, 0.0, 0, None),
    ("ring", 30, "uniform", "constant", True, 0.3, 25, None),
    ("er", 50, "uniform", "constant", False, 0.0, 0, 8000),
    ("ba", 80, "poisson", "lognormal", True, 0.15, 20, 30000),
]


@pytest.mark.parametrize("case", CASES, ids=[f"{c[0]}{c[1]}-{i}" for i, c in enumerate(CASES)])
def test_event_engine_equals_the_jax_event_engine(case):
    kind, n, sched_model, delay_model, with_churn, loss_p, connect, fifo_bytes = case
    seed = n + 7
    g, jg = _graphs(kind, n, seed)
    sched, jsched = _schedules(sched_model, n, seed)
    horizon = 300
    kw, jkw = {}, {}
    if delay_model == "lognormal":
        kw["ell_delays"] = latency.lognormal_delays(g, 2.0, 0.6, 5, seed=seed)
        jkw["ell_delays"] = jax_latency.lognormal_delays(jg, 2.0, 0.6, 5, seed=seed)
    if with_churn:
        kw["churn"] = churn.random_churn(n, horizon, outage_prob=0.3, mean_down_ticks=20,
                                         max_outages=2, seed=seed)
        jkw["churn"] = jax_churn.random_churn(n, horizon, outage_prob=0.3,
                                              mean_down_ticks=20, max_outages=2, seed=seed)
    if loss_p:
        kw["loss"] = pt.LinkLossModel(loss_p, seed=seed)
        jkw["loss"] = JaxLoss(loss_p, seed=seed)
    if fifo_bytes is not None:
        kw["fifo_links"] = latency.fifo_link_model(fifo_bytes, 5.0, 0.01)
        jkw["fifo_links"] = jax_latency.fifo_link_model(fifo_bytes, 5.0, 0.01)
        assert kw["fifo_links"].ser_micro == jkw["fifo_links"].ser_micro
    common = dict(connect_tick=connect, snapshot_ticks=[50, 120, 299, 400],
                  coverage_slots=5, record_messages=True)
    port_ticks, jax_ticks = [], []
    got = event.run_event_sim(
        g, sched, horizon, **kw, **common,
        on_tick=lambda t, seen, r, s: port_ticks.append((t, int(r.sum()), int(s.sum()))),
    )
    want = jax_event.run_event_sim(
        jg, jsched, horizon, **jkw, **common,
        on_tick=lambda t, seen, r, s: jax_ticks.append((t, int(r.sum()), int(s.sum()))),
    )
    _same(got, want)
    assert got.extra["messages"] == want.extra["messages"]
    assert n == 2 or got.extra["messages"]
    assert port_ticks == jax_ticks and len(port_ticks) == horizon
    if not connect:  # warm-up broadcasts are counted but never sent
        got.check_conservation()


@pytest.mark.parametrize("protocol,fanout", [("pushpull", 2), ("pull", 2), ("pushk", 3)])
@pytest.mark.parametrize("options", [False, True])
def test_partnered_event_engine_equals_the_jax_one(protocol, fanout, options):
    g, jg = _graphs("er", 50, 3)
    sched, jsched = _schedules("uniform", 50, 3)
    kw, jkw = {}, {}
    if options:
        kw = dict(churn=churn.random_churn(50, 80, outage_prob=0.3, mean_down_ticks=10,
                                           seed=1),
                  loss=pt.LinkLossModel(0.2, seed=5))
        jkw = dict(churn=jax_churn.random_churn(50, 80, outage_prob=0.3, mean_down_ticks=10,
                                                seed=1),
                   loss=JaxLoss(0.2, seed=5))
    got = event.run_event_partnered_sim(g, sched, 80, protocol=protocol, fanout=fanout,
                                        seed=11, **kw)
    want = jax_event.run_event_partnered_sim(jg, jsched, 80, protocol=protocol,
                                             fanout=fanout, seed=11, **jkw)
    _same(got, want)


def test_partnered_event_engine_refusals():
    g = pt.ring_graph(6)
    sched = pt.single_share_schedule(6, origin=0)
    with pytest.raises(ValueError, match="fanout"):
        event.run_event_partnered_sim(g, sched, 5, protocol="pushk", fanout=0)
    with pytest.raises(ValueError, match="unknown protocol"):
        event.run_event_partnered_sim(g, sched, 5, protocol="gossip")


@pytest.mark.parametrize("kind,delays", [("er", False), ("ba", True), ("ring", False)])
def test_event_engine_equals_the_ports_tick_engine(kind, delays):
    """The NS-3 parity: the exact event engine and the synchronous tick
    engine (on the CPU) give the same counters and snapshots, also under
    churn, loss and the connect window."""
    g, _ = _graphs(kind, 90, 5)
    sched, _ = _schedules("uniform", 90, 5)
    horizon = 300
    d = latency.lognormal_delays(g, 2.0, 0.5, 4, seed=5) if delays else None
    opts = dict(churn=churn.random_churn(90, horizon, outage_prob=0.2, mean_down_ticks=15,
                                         seed=2),
                loss=pt.LinkLossModel(0.1, seed=3), connect_tick=30,
                snapshot_ticks=[60, 150])
    ev = event.run_event_sim(g, sched, horizon, ell_delays=d, **opts)
    sy = run_sync_sim(g, sched, horizon, ell_delays=d, chunk_size=64, device="cpu", **opts)
    assert ev.equal_counts(sy)
    assert ev.extra["snapshots"] == sy.extra["snapshots"]


def test_uncontended_fifo_equals_the_serialization_closed_form():
    """With no two messages on one link in a tick the FIFO model's arrival
    ticks are the closed form's (`serialization_delays`)."""
    g = pt.ring_graph(12)
    sched = pt.single_share_schedule(12, origin=0)
    tick_dt = 0.005
    fifo = latency.fifo_link_model(8000, 5.0, tick_dt)
    closed = latency.serialization_delays(g, latency_ticks=1, message_bytes=8000,
                                          bandwidth_mbps=5.0, tick_dt=tick_dt)
    a = event.run_event_sim(g, sched, 100, fifo_links=fifo, coverage_slots=1)
    b = event.run_event_sim(g, sched, 100, ell_delays=closed, coverage_slots=1)
    assert a.equal_counts(b)
    np.testing.assert_array_equal(a.extra["arrival_ticks"], b.extra["arrival_ticks"])
