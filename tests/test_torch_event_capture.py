"""The port's event-engine digest capture (``telemetry.compare.
capture_event_digests`` and ``TickCapture``) against the JAX package's:
the per-tick digest stream and the ``window`` snapshots (per-node received
totals and seen-set sizes) equal value for value on ER and BA graphs,
with and without churn (lossless); the capture lines up with the port's
sync flood digest stream with no divergence, and an injected fault is
named at its tick. Also the ``PrintPeriodicStats`` text
(``utils.stats.format_periodic_stats``) equal to the JAX package's."""

import numpy as np
import pytest

import p2p_gossip_tpu as pg
from p2p_gossip_tpu.engine.event import run_event_sim as jax_event_sim
from p2p_gossip_tpu.telemetry import compare as jax_compare
from p2p_gossip_tpu.utils.stats import format_periodic_stats as jax_periodic

import p2p_gossip_tpu_torch as pt
from p2p_gossip_tpu_torch import telemetry
from p2p_gossip_tpu_torch.engine.event import run_event_sim
from p2p_gossip_tpu_torch.engine.sync import run_sync_sim
from p2p_gossip_tpu_torch.telemetry import compare
from p2p_gossip_tpu_torch.utils.stats import format_periodic_stats

HORIZON = 20
WINDOW = (2, 6)
GRAPHS = {"er": lambda pkg: pkg.erdos_renyi(48, 0.15, seed=0),
          "ba": lambda pkg: pkg.barabasi_albert(60, m=3, seed=1)}


@pytest.fixture(autouse=True)
def _clean_telemetry():
    telemetry.reset()
    yield
    telemetry.reset()


def _inputs(pkg, topology, churn):
    graph = GRAPHS[topology](pkg)
    rng = np.random.default_rng(3)
    sched = pkg.Schedule(graph.n, rng.integers(0, graph.n, 5).astype(np.int32),
                         np.array([0, 0, 1, 3, 4], dtype=np.int32))
    kw = {}
    if churn:
        kw["churn"] = pkg.random_churn(graph.n, HORIZON, outage_prob=0.3, mean_down_ticks=3.0,
                                       max_outages=2, seed=5)
    return graph, sched, kw


@pytest.mark.parametrize("churn", [False, True], ids=["lossless", "churn"])
@pytest.mark.parametrize("topology", list(GRAPHS))
def test_capture_equals_the_jax_packages(topology, churn):
    graph, sched, kw = _inputs(pt, topology, churn)
    got = compare.capture_event_digests(graph, sched, HORIZON, window=WINDOW, **kw)
    jgraph, jsched, jkw = _inputs(pg, topology, churn)
    want = jax_compare.capture_event_digests(jgraph, jsched, HORIZON, window=WINDOW, **jkw)
    assert got.digests == want.digests and sorted(got.digests) == list(range(HORIZON))
    assert any(got.digests.values())
    assert sorted(got.received) == sorted(got.seen_counts) == list(range(WINDOW[0],
                                                                         WINDOW[1] + 1))
    for t in got.received:
        assert np.array_equal(got.received[t], want.received[t])
        assert np.array_equal(got.seen_counts[t], want.seen_counts[t])
        assert got.received[t].shape == (graph.n,) and got.received[t].dtype == np.int64
    # Lossless: the frontier totals only grow.
    assert got.received[WINDOW[1]].sum() >= got.received[WINDOW[0]].sum()


@pytest.mark.parametrize("churn", [False, True], ids=["lossless", "churn"])
@pytest.mark.parametrize("topology", list(GRAPHS))
def test_capture_lines_up_with_the_sync_flood_stream(topology, churn):
    """The event engine's digests equal the port's sync flood digest
    stream over its executed ticks; a flipped bit is named at its tick."""
    graph, sched, kw = _inputs(pt, topology, churn)
    cap = compare.capture_event_digests(graph, sched, HORIZON, **kw)
    telemetry.configure(None, rings=True)
    run_sync_sim(graph, sched, HORIZON, device="cpu", **kw)
    sync = compare.select_stream(compare.digest_streams(telemetry.events(),
                                                        kernel="engine.sync"))
    div = compare.first_divergence(cap.digests, sync)
    assert not div.diverged and div.compared > 3
    tick = sorted(sync)[2]
    faulty = compare.first_divergence(cap.digests, compare.inject_fault(sync, tick))
    assert faulty.diverged and faulty.tick == tick


@pytest.mark.parametrize("sim_time", [0.5, 12.0, 60.0])
def test_periodic_stats_text_equals_the_jax_packages(sim_time):
    graph, sched, _ = _inputs(pt, "er", False)
    jgraph, jsched, _ = _inputs(pg, "er", False)
    got = format_periodic_stats(run_event_sim(graph, sched, HORIZON), sim_time)
    assert got == jax_periodic(jax_event_sim(jgraph, jsched, HORIZON), sim_time)
    assert got.startswith(f"=== Periodic Stats at {sim_time:g}s ===\n")
