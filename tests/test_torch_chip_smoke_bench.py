"""chip_smoke.py's phase 19, rehearsed on the CPU at a small size: the
bench's legs 1-4 (`p2p_gossip_tpu_torch.bench`: headline, baseline, flood
campaign) on the phase's graph, schedule and staging, every timed run held
to the phase-5 run's counters; the row's documented keys and phase 5's
ticks; no kernel launched (the CPU runs the plain versions), which the
phase's launch check requires here. Also the checks themselves: each
refuses a row that breaks it, and ``--phase 19``'s check of the whole
bench's row."""

import os
import sys

import numpy as np
import pytest
import torch

import p2p_gossip_tpu_torch as pt
from p2p_gossip_tpu_torch import bench
from p2p_gossip_tpu_torch.engine.sync import DeviceGraph, run_sync_sim

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

CPU = torch.device("cpu")
SMALL = dict(N_NODES=2000, EDGE_P=0.01, N_SHARES=256, CHUNK=256)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread in this process: several test workers on a shared
    host oversubscribe the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _set_small(set_attr):
    for name, value in SMALL.items():
        set_attr(chip_smoke, name, value)


@pytest.fixture
def small_sizes(monkeypatch):
    _set_small(monkeypatch.setattr)


@pytest.fixture(scope="module")
def small():
    """Phase 5's graph, staging, schedule and timed run at the small size,
    and phase 19's record on them."""
    saved = {name: getattr(chip_smoke, name) for name in SMALL}
    _set_small(setattr)
    try:
        graph = pt.erdos_renyi(chip_smoke.N_NODES, chip_smoke.EDGE_P, seed=chip_smoke.SEED)
        dg = DeviceGraph.build(graph, device=CPU)
        sched = chip_smoke.flood_schedule(graph)
        phase5 = run_sync_sim(graph, sched, chip_smoke.HORIZON, chunk_size=chip_smoke.CHUNK,
                              device_graph=dg, device=CPU)
        record = chip_smoke.bench_phase(graph, dg, sched, CPU, phase5)
    finally:
        for name, value in saved.items():
            setattr(chip_smoke, name, value)
    return graph, dg, sched, phase5, record


@pytest.fixture(scope="module")
def record(small):
    return small[4]


def test_bench_phase_row(record, small):
    row, phase5 = record["row"], small[3]
    assert set(row) == set(bench.ROW_KEYS)
    assert row["ticks"] == phase5.extra["ticks_executed"]
    assert row["processed"] == phase5.totals()["processed"] == SMALL["N_SHARES"] * SMALL["N_NODES"]
    assert len(row["runs"]) == chip_smoke.BENCH_REPEATS
    assert row["campaign"]["replicas"] == bench.CAMPAIGN["replicas"]
    assert row["vs_baseline"] > 0
    for key in ("serve", "protocol_campaign", *bench.MESH_LEGS):
        assert row[key] is None, key


def test_the_cpu_launches_no_kernel(record):
    assert all(record["launches"][name] == 0 for name in chip_smoke.BENCH_KERNELS)


def test_bench_phase_refuses_another_reference(small, small_sizes):
    graph, dg, sched = small[:3]
    other = pt.Schedule(graph.n, sched.origins[:100], sched.gen_ticks[:100])
    wrong = run_sync_sim(graph, other, chip_smoke.HORIZON, chunk_size=chip_smoke.CHUNK,
                         device_graph=dg, device=CPU)
    with pytest.raises(AssertionError, match="differs from the reference"):
        chip_smoke.bench_phase(graph, dg, sched, CPU, wrong)


def test_bench_config_is_the_bench_s_full_size():
    """At the script's own sizes, phase 19 runs the bench's headline
    workload."""
    assert chip_smoke.bench_config() == bench.FULL


@pytest.mark.parametrize("fault", ["key", "ticks", "processed", "median", "card",
                                   "launches"])
def test_check_bench_row_refuses(fault, record, small):
    row, launches, on_card = dict(record["row"]), dict(record["launches"]), False
    if fault == "key":
        row["cost"] = None
    elif fault == "ticks":
        row["ticks"] += 1
    elif fault == "processed":
        row["processed"] -= 1
    elif fault == "median":
        row["value"] = max(row["runs"]) * 2
    elif fault == "card":  # on the card the row must name it
        on_card = True
        launches = dict.fromkeys(launches, 1)
    elif fault == "launches":  # on the card every kernel of the legs launches
        on_card = True
        row.update(device="H100", power_limit="700.00 W", pct_hbm_peak=10.0)
        launches = dict.fromkeys(launches, 1)
        launches["coverage_per_slot"] = 0
    with pytest.raises((AssertionError, RuntimeError)):
        chip_smoke.check_bench_row(row, small[3], launches, on_card)


def _whole_row(record, small):
    """A row as ``python -m p2p_gossip_tpu_torch.bench`` prints it on the
    card, every leg's check passing."""
    return dict(
        record["row"], device="NVIDIA H100 80GB HBM3", power_limit="700.00 W",
        campaign_sharded={"replicas": 4, "bitwise_equal_replicas": 4},
        serve={"bitwise_ok": True},
        exchange={"families": [{"family": f, "ok": True} for f in bench.EXCHANGE_FAMILIES]},
        async_ticks={"legs": [{}] * (2 + len(bench.ASYNC_KS))},
        staticcheck_ok=True,
    )


def test_check_bench_whole_passes(record, small, small_sizes):
    chip_smoke.check_bench_whole(_whole_row(record, small), small[3].extra["ticks_executed"])


@pytest.mark.parametrize("fault", ["processed", "ticks", "runs", "campaign_sharded", "serve",
                                   "exchange", "async_ticks", "power_limit", "key",
                                   "staticcheck_ok"])
def test_check_bench_whole_refuses(fault, record, small, small_sizes):
    row = _whole_row(record, small)
    ticks = small[3].extra["ticks_executed"]
    if fault == "processed":
        row["processed"] -= 1
    elif fault == "ticks":
        ticks += 1
    elif fault == "runs":
        row["runs"] = row["runs"][:1]
    elif fault == "campaign_sharded":
        row["campaign_sharded"] = {"replicas": 4, "bitwise_equal_replicas": 3}
    elif fault == "serve":
        row["serve"] = {"bitwise_ok": False}
    elif fault == "exchange":
        row["exchange"]["families"][1]["ok"] = False
    elif fault == "async_ticks":
        row["async_ticks"] = None
    elif fault == "power_limit":
        row["power_limit"] = None
    elif fault == "key":
        del row["telemetry"]
    elif fault == "staticcheck_ok":
        row["staticcheck_ok"] = False
    with pytest.raises(AssertionError, match="p2p_gossip_tpu_torch.bench"):
        chip_smoke.check_bench_whole(row, ticks)


def test_bench_row_median(record):
    runs = record["row"]["runs"]
    assert record["row"]["value"] == float(np.median(runs))
