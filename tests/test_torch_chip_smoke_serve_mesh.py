"""chip_smoke.py's phase 17, rehearsed on the CPU at small sizes: (a)-(b)'s
worker, `chip_smoke.serve_mesh_worker`, on two gloo ranks (every rank
enters every drain, profile and memory dispatch, so the collectives pair
up): `make_slot_mesh(8)` is 2 x 1, every request of the dense and the
delta drain equals the single-device server's on both ranks, the memory
dispatches carry the mesh admission model beside the runner's, the
over-budget request is rejected; (c)'s gloo meshes equal the single-device
server; (d) ``scale.py --mesh 1x1`` on a BA graph equals the single-device
flood. The CPU launches no kernel and reads no device memory.

One world of 2 spawned ranks runs the worker once; the tests read its
results. The worker's module imports only the port."""

import os
import sys

import numpy as np
import pytest

from p2p_gossip_tpu_torch.engine.sync import run_flood_coverage, time_to_coverage
from p2p_gossip_tpu_torch.parallel import launch
from p2p_gossip_tpu_torch.runtime import native
from p2p_gossip_tpu_torch.serve import bench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

RANKS = 2
SERVE_TRACE = chip_smoke.serve_trace


def _trace(*_):
    """Eight requests: the four protocols on each topology, N = 300."""
    return SERVE_TRACE(nodes=300, requests=8, shares=32, horizon=8)


@pytest.fixture(scope="module")
def worker_runs():
    """Each rank's worker result and the single-device server's results."""
    trace = _trace()
    server, _ = bench.run_trace(trace, chip_smoke.SERVE_SLOTS, "cpu", log=lambda m: None)
    graphs = dict(server._graphs)  # topology fingerprint -> Graph
    want = {d["request_id"]: server.result(d["request_id"]) for d in trace}
    runs = launch.spawn(chip_smoke.serve_mesh_worker, RANKS, graphs, trace, "cpu",
                        timeout_s=120.0)
    return runs, want, trace


def test_slot_mesh_spans_both_ranks(worker_runs):
    for out in worker_runs[0]:
        assert out["shape"] == {"replicas": RANKS, "nodes": 1}


@pytest.mark.parametrize("exchange", chip_smoke.SERVE_MESH_EXCHANGES)
def test_every_request_equals_the_single_device_server(exchange, worker_runs):
    runs, want, trace = worker_runs
    for out in runs:
        drain = out["drains"][exchange]
        for rid, result in want.items():
            assert bench.same_result(drain["results"][rid], result), (exchange, rid)
        assert drain["summary"]["requests"] == len(trace)
        assert set(drain["by_kind"]) == {"flood erdos_renyi", "flood barabasi_albert",
                                         "protocol erdos_renyi", "protocol barabasi_albert"}
        assert not any(drain["launches"].values())


def test_memory_dispatches_and_admission(worker_runs):
    """The largest flood and protocol dispatch by the mesh admission model,
    beside the runner's own model of the rank; the over-budget request is
    rejected on both ranks; the protocol staging is timed per topology."""
    for out in worker_runs[0]:
        assert set(out["memory"]) == {"flood", "protocol"}
        for m in out["memory"].values():
            assert abs(m["model"] - m["runner"]) <= 0.10 * m["runner"], m
        assert out["over_budget"] == ("rejected", 0)
        assert set(out["protocol_staging_s"]) == {"erdos_renyi", "barabasi_albert"}


def test_gloo_meshes(monkeypatch):
    """Phase 17 (c) on 2 ranks with the small trace: (replicas x nodes) 2 x
    1, 1 x 2 and make_slot_mesh(4), every request equal to the
    single-device server's."""
    monkeypatch.setattr(chip_smoke, "GLOO_DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "serve_trace", _trace)
    shapes = chip_smoke.gloo_serve_ranks("cpu")
    assert shapes == [{"replicas": 2, "nodes": 1}, {"replicas": 1, "nodes": 2},
                      {"replicas": 2, "nodes": 1}]


def test_scale_mesh_equals_the_single_device_flood(monkeypatch, tmp_path):
    """Phase 17 (d) at 1,500 BA nodes and 128 shares, the memory check
    recorded (no device memory on the CPU)."""
    import torch

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(chip_smoke, "SCALE_ORIGINS", 128)
    checked = []
    monkeypatch.setattr(chip_smoke, "check_resident", lambda *a: checked.append(a))
    native.build()
    graph = native.native_barabasi_albert(1500, m=chip_smoke.SCALE_BA_M, seed=chip_smoke.SEED)
    origins = np.random.default_rng(chip_smoke.SEED).integers(0, graph.n, 128).astype(np.int32)
    stats, cov = run_flood_coverage(graph, origins, chip_smoke.HORIZON, device="cpu")
    ttc = time_to_coverage(cov, graph.n, 0.99)
    scale12 = dict(ttc99_median=float(np.median(ttc)), ttc99_max=int(ttc.max()), wall_s=1.0,
                   ms_per_tick=1.0, rate=1.0, stage_s=1.0)
    rec = chip_smoke.scale_mesh(dict(graph=graph, coverage=cov), scale12,
                                torch.device("cpu"))
    assert rec["processed"] == 128 * graph.n and rec["mesh"] == {"shares": 1, "nodes": 1}
    assert checked and checked[0][2] == rec["rank_resident_bytes"][0]
    assert not os.path.exists(os.path.join("p2p_gossip_tpu_torch", "build", "phase17",
                                           "ba_mesh.npz"))
