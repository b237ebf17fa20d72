"""chip_smoke.py's phase 16 (b)-(d), rehearsed on the CPU at N = 2,000:
two gloo ranks run its worker, `chip_smoke.sharded_campaign_worker` (every
rank enters every campaign call, the first rank's profiled run included,
so the collectives pair up across the mesh), and every replica of every
run equals the port's single-device campaigns on both ranks
(`chip_smoke.check_campaign_results`); (c)'s gloo meshes, cut to 2 ranks,
equal them too. The CPU launches no kernel.

One world of 2 spawned ranks runs the worker once; the parametrised tests
read its results. The worker's module imports only the port."""

import os
import sys

import numpy as np
import pytest

import p2p_gossip_tpu_torch as pt
from p2p_gossip_tpu_torch.batch import campaign as bc
from p2p_gossip_tpu_torch.parallel import launch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

RANKS = 2
MODES = [m for m, _ in chip_smoke.SHARDED_MODES + chip_smoke.CAMPAIGN_PROTOCOL_MODES]


def _inputs():
    """2,000 nodes (mean degree 10), phase 16's eight replicas: 128
    coverage origins each, and for push-pull 256 shares over the first
    ticks with log-normal per-edge delays (max 5 ticks, as phase 9's)."""
    graph = pt.erdos_renyi(2000, 0.005, seed=4)
    cov_set = bc.flood_replicas(graph, 128, np.arange(chip_smoke.CAMPAIGN_REPLICAS) + 4,
                                chip_smoke.HORIZON)
    pp_set = chip_smoke.campaign_replicas(graph, 256)
    delays = pt.lognormal_delays(graph, mean_ticks=2.0, sigma=0.5, max_ticks=5, seed=4)
    return graph, cov_set, pp_set, delays


@pytest.fixture(scope="module")
def worker_runs():
    """Each rank's worker result and the single-device campaigns."""
    graph, cov_set, pp_set, delays = _inputs()
    runs = launch.spawn(chip_smoke.sharded_campaign_worker, RANKS, graph, cov_set, pp_set,
                        delays, "cpu", timeout_s=120.0)
    h = chip_smoke.HORIZON
    phase11 = {"coverage": bc.run_coverage_campaign(graph, cov_set, h, device="cpu"),
               "pushpull": bc.run_protocol_campaign(graph, pp_set, h, protocol="pushpull",
                                                    ell_delays=delays, chunk_size=256,
                                                    device="cpu")}
    refs = chip_smoke.campaign_references(graph, cov_set, RANKS, phase11, "cpu")
    return runs, refs, graph


def test_worker_spans_every_rank(worker_runs):
    runs = worker_runs[0]
    assert len(runs) == RANKS
    assert all(r["shape"] == {"replicas": 1, "nodes": RANKS} for r in runs)
    assert all(set(MODES) <= set(r) for r in runs)


def test_every_replica_matches_the_single_device_campaigns(worker_runs):
    """phase 16 (b)'s and (d)'s check passes on every rank: each mode's
    replicas and the mesh= coverage campaign equal the single-device
    campaigns."""
    runs, refs, _ = worker_runs
    for r in runs:
        chip_smoke.check_campaign_results(r, refs, refs["coverage"])
    # Async K = 2 across the two shards runs the clamped delays: its
    # reference differs from the unclamped campaign's.
    assert not np.array_equal(refs["async_coverage"].coverage, refs["coverage"].coverage)


@pytest.mark.parametrize("mode", MODES)
def test_mode_reports(mode, worker_runs):
    """Each run's mesh and exchange report, its memory model, and no
    kernel launch on the CPU."""
    runs = worker_runs[0]
    for r in runs:
        res = r[mode]["result"]
        assert res.extra["mesh"] == {"replica_shards": 1, "node_shards": RANKS,
                                     "local_replicas": chip_smoke.CAMPAIGN_REPLICAS}
        assert res.extra["resident_bytes"] > 0
        assert not any(r[mode]["launches"].values())
    ex = runs[0][mode]["result"].extra["exchange"]
    if mode in ("delta", "hub", "pushpull-delta"):
        assert ex["achieved_used_entries"] > 0


def test_gloo_meshes(worker_runs, monkeypatch):
    """Phase 16 (c) on 2 ranks: (replicas x nodes) 2 x 1 and 1 x 2, every
    replica of the dense and delta coverage campaigns and the push-pull
    campaign equal to the single-device campaigns."""
    monkeypatch.setattr(chip_smoke, "GLOO_DEVICE", "cpu")
    out = chip_smoke.gloo_campaign_ranks(worker_runs[2], RANKS, ((2, 1), (1, 2)), "cpu")
    assert out["1x2_delta"]["exchange"] == "delta"
    assert out["2x1_dense"]["mesh"]["local_replicas"] == chip_smoke.GLOO_CAMPAIGN_REPLICAS // 2
