"""chip_smoke.py's phase 15 (b) worker, `chip_smoke.sharded_protocols_worker`,
rehearsed on the CPU: two gloo ranks run it at a small size (every rank
enters every sharded protocol call, the first rank's profiled run
included, so the collectives pair up across the mesh), and each run's
counters and coverage rows equal the port's single-device protocols on
both ranks (`chip_smoke.protocol_references`, async against the delays
clamped to max(d, K)).

One world of 2 spawned ranks runs the worker once; the parametrised tests
read its results. The worker's module imports only the port."""

import os
import sys

import numpy as np
import pytest

import p2p_gossip_tpu_torch as pt
from p2p_gossip_tpu_torch.parallel import launch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

RANKS = 2
RUNS = [label for label, *_ in chip_smoke.SHARDED_PROTOCOL_RUNS]


def _inputs():
    """301 rows (padded to 302 over the two node shards), 256 shares
    generated over the first ticks, 64 coverage origins at t = 0, and
    log-normal per-edge delays (max 5 ticks, as phase 9's)."""
    graph = pt.erdos_renyi(301, 0.03, seed=4)
    rng = np.random.default_rng(4)
    sched = pt.Schedule(graph.n, rng.integers(0, graph.n, 256).astype(np.int32),
                        rng.integers(0, chip_smoke.GEN_WINDOW, 256).astype(np.int32))
    cov_sched = pt.Schedule(graph.n, rng.integers(0, graph.n, 64).astype(np.int32),
                            np.zeros(64, dtype=np.int32))
    delays = pt.lognormal_delays(graph, mean_ticks=2.0, sigma=0.5, max_ticks=5, seed=4)
    return graph, sched, cov_sched, delays


@pytest.fixture(scope="module")
def worker_runs():
    """Each rank's `sharded_protocols_worker` result and every run's
    single-device reference."""
    graph, sched, cov_sched, delays = _inputs()
    runs = launch.spawn(chip_smoke.sharded_protocols_worker, RANKS, graph, sched, cov_sched,
                        delays, "cpu", timeout_s=120.0)
    refs = chip_smoke.protocol_references(graph, sched, cov_sched, delays, "cpu")
    return runs, refs


def test_worker_spans_every_rank(worker_runs):
    runs = worker_runs[0]
    assert len(runs) == RANKS
    assert all(r["shape"] == {"shares": 1, "nodes": RANKS} for r in runs)
    assert all(set(RUNS) <= set(r) for r in runs)


@pytest.mark.parametrize("label", RUNS)
def test_worker_run_matches_single_device(label, worker_runs):
    """Every rank's counters and coverage rows pass phase 15's check
    against the single-device port; the CPU launches no kernel."""
    runs, refs = worker_runs
    for r in runs:
        chip_smoke.check_protocol_run(label, r[label], refs[label])
        assert not any(r[label]["launches"].values())
        assert r[label]["stats"].extra["resident_bytes"] > 0


def test_async_reference_differs_from_the_unclamped_run(worker_runs):
    """The clamp changes the async push-pull's counters (its digests' sizes
    arrive later: ``sent`` differs), so holding async to the unclamped run
    would fail."""
    _, refs = worker_runs
    assert not np.array_equal(refs["pushpull-async"][0].sent,
                              refs["pushpull-replicated"][0].sent)


def test_exchange_kernels_ran_where_phase_15_counts_them(worker_runs):
    """The runs whose launch counts phase 15 holds to the exchange kernels
    resolve as it expects: delta and hub (with its pinned hub rows) on the
    delta transport, async on two ranks to delta, the rest dense."""
    r = worker_runs[0][0]
    modes = {label: r[label]["stats"].extra["exchange"]["mode"] for label in RUNS}
    assert modes["pushpull-delta"] == modes["pull-delta"] == modes["coverage-delta"] == "delta"
    assert modes["pushpull-hub"] == "hub" and modes["pushpull-async"] == "delta"
    assert r["pushpull-hub"]["stats"].extra["exchange"]["hub_count"] == \
        chip_smoke.PINNED_HUB_ROWS
    assert modes["pushk-sharded"] == "none" and modes["pushpull-replicated"] == "replicated"
