"""chip_smoke.py's phase 14 (b) worker, `chip_smoke.sharded_worker`,
rehearsed on the CPU: two gloo ranks run it at a small size (every rank
enters every sharded call, the first rank's profiled floods included, so
the collectives pair up across the mesh), and each mode's flood and
coverage, and the BA coverage, equal the port's single-device engines on
both ranks.

One world of 2 spawned ranks runs the worker once; the parametrised tests
read its results. The worker's module imports only the port."""

import os
import sys

import numpy as np
import pytest

import p2p_gossip_tpu_torch as pt
from p2p_gossip_tpu_torch.engine.sync import run_flood_coverage, run_sync_sim
from p2p_gossip_tpu_torch.parallel import launch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

RANKS = 2
MODES = [mode for mode, _ in chip_smoke.SHARDED_MODES]


def _inputs():
    """301 rows (padded to 302 over the two node shards), a flood of 256
    shares generated over the first ticks, 64 coverage origins, and a BA
    graph with its own origins."""
    graph = pt.erdos_renyi(301, 0.03, seed=4)
    rng = np.random.default_rng(4)
    sched = pt.Schedule(graph.n, rng.integers(0, graph.n, 256).astype(np.int32),
                        rng.integers(0, chip_smoke.GEN_WINDOW, 256).astype(np.int32))
    origins = rng.integers(0, graph.n, 64)
    ba = pt.barabasi_albert(200, m=3, seed=1)
    return graph, sched, origins, (ba, rng.integers(0, ba.n, 64))


@pytest.fixture(scope="module")
def worker_runs():
    """Each rank's `sharded_worker` result, each mode's single-device
    reference at two node shards (`chip_smoke.sharded_references`), and
    the single-device BA coverage."""
    graph, sched, origins, ba = _inputs()
    runs = launch.spawn(chip_smoke.sharded_worker, RANKS, graph, sched, origins, ba, "cpu",
                        timeout_s=120.0)
    ref = run_sync_sim(graph, sched, chip_smoke.HORIZON, chunk_size=chip_smoke.CHUNK,
                       device="cpu")
    ref_cov = run_flood_coverage(graph, origins, chip_smoke.HORIZON, device="cpu")
    refs = chip_smoke.sharded_references(graph, sched, origins, RANKS, ref, ref_cov, "cpu")
    ba_ref = run_flood_coverage(ba[0], ba[1], chip_smoke.HORIZON, device="cpu")
    return runs, refs, ba_ref


def test_worker_spans_every_rank(worker_runs):
    runs = worker_runs[0]
    assert len(runs) == RANKS
    assert all(r["shape"] == runs[0]["shape"] for r in runs)


@pytest.mark.parametrize("mode", MODES)
def test_worker_mode_matches_single_device(mode, worker_runs):
    """Every rank's counters, ticks and coverage rows pass phase 14's
    check against the single-device port (async K = 2 against the clamped
    cross-shard delays); the CPU launches no kernel."""
    runs, refs, _ = worker_runs
    for r in runs:
        chip_smoke.check_sharded_mode(mode, r[mode], refs[mode])
        assert not any(r[mode]["launches"].values())


def test_async_reference_differs_from_the_unclamped_flood(worker_runs):
    """At two shards the clamp changes the async flood's coverage rows, so
    holding async to the unclamped run would fail."""
    _, refs, _ = worker_runs
    assert not np.array_equal(refs["async"][2], refs["replicated"][2])


def test_worker_ba_coverage_matches_single_device(worker_runs):
    runs, _, (ba_stats, ba_cov) = worker_runs
    for r in runs:
        assert np.array_equal(r["ba"]["coverage"], ba_cov)
        assert chip_smoke.same_counts(r["ba"]["stats"], ba_stats)
