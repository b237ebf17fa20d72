"""The port's benchmark entry point (``python -m p2p_gossip_tpu_torch.bench``)
on the CPU, against the JAX package: the smoke run prints one JSON line
with the documented keys, and its counters are bitwise the JAX engines'
on the same graph and schedules (the headline flood's per-node counters
and ticks, each timed run held to the JAX `run_sync_sim`; the flood and
push-pull campaigns' per-replica counters, held to the JAX campaigns');
the mesh legs, on one world of 8 spawned gloo ranks at the JAX scripts'
sizes, give the JAX sharded runner's exchange reports on its (4 nodes x 2
shares) mesh over the 8 virtual CPU devices of tests/conftest.py, every
sharded-campaign replica bitwise and the checked async legs; the serve leg
runs the server bench's smoke on the CPU; without CUDA the default device
raises; ``P2P_BENCH_PROFILE_DIR`` writes a trace and stamps the row.
Tolerance 0 throughout: every op is integer."""

import contextlib
import dataclasses
import importlib.util
import io
import json
import os
import subprocess
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import p2p_gossip_tpu as pg
from p2p_gossip_tpu.batch import campaign as jc
from p2p_gossip_tpu.engine.sync import run_sync_sim as jax_sync_sim

import p2p_gossip_tpu_torch as pt
from p2p_gossip_tpu_torch import bench, telemetry
from p2p_gossip_tpu_torch.engine.sync import DeviceGraph, run_sync_sim
from p2p_gossip_tpu_torch.runtime import native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
# bench.py's row keys (bench.py:598-705) without cost, and the port's
# additions.
JAX_ROW_KEYS = {"metric", "value", "unit", "vs_baseline", "achieved_gbps", "pct_hbm_peak",
                "ticks", "modeled_bytes_total", "exchange", "exchange_hub",
                "campaign_sharded", "async_ticks", "serve", "campaign", "protocol_campaign",
                "telemetry", "staticcheck_ok"}
PORT_KEYS = {"runs", "spread", "ms_per_tick", "processed", "device", "power_limit"}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread in this process (its spawned ranks already run
    one): several test workers on a shared host oversubscribe the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _main(argv):
    """``bench.main(argv)``'s exit code and stdout lines; telemetry is
    reset afterwards (the bench configures the process's sink)."""
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            rc = bench.main(argv)
    finally:
        telemetry.reset()
    return rc, out.getvalue().splitlines()


@pytest.fixture(scope="module")
def smoke(tmp_path_factory):
    path = tmp_path_factory.mktemp("bench") / "rows.jsonl"
    rc, lines = _main(["--device", "cpu", "--smoke", "--out", str(path)])
    return rc, lines, path


@pytest.fixture(scope="module")
def row(smoke):
    return json.loads(smoke[1][-1])


def test_smoke_prints_one_json_line(smoke):
    rc, lines, path = smoke
    assert rc == 0
    assert len(lines) == 1
    assert json.loads(lines[0])
    assert path.read_text() == lines[0] + "\n"


def test_row_keys_are_bench_py_s_without_staticcheck_and_cost(row):
    """bench.py's keys without ``cost``: since the port has its static-
    analysis gate, ``staticcheck_ok`` is the gate's verdict on the shipped
    tree (true)."""
    assert set(row) == JAX_ROW_KEYS | PORT_KEYS == set(bench.ROW_KEYS)
    assert "cost" not in row
    assert row["staticcheck_ok"] is True


def _jax_graph(cfg):
    g = native.native_erdos_renyi(cfg["nodes"], cfg["prob"], seed=bench.SEED)
    return pg.Graph(g.n, g.indptr, g.indices)


def test_headline_counters_equal_the_jax_engine(row):
    """Every timed run of the bench's headline, on the bench's own graph
    and schedule (`bench.workload`), holds its per-node counters and ticks
    to the JAX engine's (`headline` raises otherwise)."""
    cfg = bench.SMOKE
    jgraph = _jax_graph(cfg)
    rng = np.random.default_rng(bench.SEED)
    jsched = pg.Schedule(jgraph.n, rng.integers(0, jgraph.n, cfg["shares"]).astype(np.int32),
                         rng.integers(0, cfg["gen_window"], cfg["shares"]).astype(np.int32))
    want = jax_sync_sim(jgraph, jsched, cfg["horizon"], chunk_size=cfg["chunk"])
    graph, sched, dg = bench.workload(cfg, CPU)
    assert np.array_equal(graph.indptr, jgraph.indptr)
    assert np.array_equal(graph.indices, jgraph.indices)
    assert np.array_equal(sched.origins, jsched.origins)
    assert np.array_equal(sched.gen_ticks, jsched.gen_ticks)
    head = bench.headline(graph, sched, dg, cfg, 2, CPU, smoke=True, reference=want)
    assert head["ticks"] == row["ticks"] == want.extra["ticks_executed"]
    assert head["processed"] == row["processed"] == want.totals()["processed"]
    assert row["processed"] == cfg["shares"] * cfg["nodes"]
    received = want.received.copy()
    received[7] += 1
    with pytest.raises(AssertionError, match="differs from the reference"):
        bench.headline(graph, sched, dg, cfg, 1, CPU, smoke=True,
                       reference=dataclasses.replace(want, received=received))


def _jax_campaign_inputs():
    cfg = bench.CAMPAIGN_SMOKE
    graph = pg.erdos_renyi(cfg["nodes"], cfg["prob"], seed=bench.SEED)
    reps = jc.flood_replicas(graph, cfg["shares"], list(range(cfg["replicas"])),
                             cfg["horizon"])
    return cfg, graph, reps


def _off_by_one(result, key):
    """``result`` with one replica's counter of one node raised by one."""
    values = getattr(result, key).copy()
    values[1, 5] += 1
    return dataclasses.replace(result, **{key: values})


def _hold_campaign_leg(row, leg, want):
    """The bench's campaign leg ``leg`` holds its per-replica counters (and
    the flood's coverage) to ``want``, the JAX campaign on the same
    replicas, and refuses a reference one counter off."""
    cfg = bench.CAMPAIGN_SMOKE
    got = getattr(bench, leg)(CPU, smoke=True, reference=want)
    assert got["processed"] == row[leg]["processed"]
    assert got["processed"] == int((want.generated + want.received).sum())
    assert got["replicas"] == row[leg]["replicas"] == cfg["replicas"]
    for key in ("generated", "received", "sent"):
        with pytest.raises(AssertionError, match=f"{key} differs from the reference"):
            getattr(bench, leg)(CPU, smoke=True, reference=_off_by_one(want, key))


def test_flood_campaign_equals_the_jax_campaign(row):
    cfg, graph, reps = _jax_campaign_inputs()
    want = jc.run_coverage_campaign(graph, reps, cfg["horizon"])
    assert want.coverage is not None
    _hold_campaign_leg(row, "campaign", want)


def test_protocol_campaign_equals_the_jax_campaign(row):
    cfg, graph, reps = _jax_campaign_inputs()
    want = jc.run_protocol_campaign(graph, reps, cfg["horizon"], protocol="pushpull")
    _hold_campaign_leg(row, "protocol_campaign", want)


def test_smoke_row_values(row):
    assert row["device"] == "cpu" and row["power_limit"] is None
    assert row["metric"].endswith("gossip flood, CPU, SMOKE)")
    assert len(row["runs"]) == 3 and row["value"] == float(np.median(row["runs"]))
    assert row["spread"] == pytest.approx((max(row["runs"]) - min(row["runs"])) / row["value"])
    assert row["ms_per_tick"] > 0 and row["vs_baseline"] > 0
    # No device metric from a CPU run; no leg of bench.py's smoke branch.
    for key in ("achieved_gbps", "pct_hbm_peak", "modeled_bytes_total", "serve",
                *bench.MESH_LEGS):
        assert row[key] is None, key
    for leg in ("campaign", "protocol_campaign"):
        assert "CPU, SMOKE" in row[leg]["metric"]
    assert row["campaign"]["sequential_wall_s_est"] is None
    assert row["campaign"]["speedup_vs_sequential"] is None


def test_telemetry_spans_every_phase(row):
    tel = row["telemetry"]
    for phase in ("build_graph", "stage", "warmup_compile", "execute", "baseline",
                  "campaign", "protocol_campaign"):
        assert tel["span_s_by_phase"][phase] > 0, phase
    assert tel["events"] > 0 and tel["stream"] is None


def test_default_device_raises_without_cuda():
    """No CPU fallback: ``main([])`` means the card and raises here."""
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main([])


def test_the_cpu_runs_only_at_smoke_sizes():
    with pytest.raises(SystemExit, match="--smoke sizes only"):
        bench.main(["--device", "cpu"])


def test_power_limit_is_the_device_s_own_card():
    """nvidia-smi lists every card whatever CUDA_VISIBLE_DEVICES hides:
    the power limit comes from the line with the device's UUID."""
    smi = ("GPU-aaaa-1111, NVIDIA H100 80GB HBM3, 700.00 W\n"
           "GPU-bbbb-2222, NVIDIA H100 80GB HBM3, 500.00 W\n")
    assert bench.smi_power_limit(smi, "bbbb-2222") == "500.00 W"
    assert bench.smi_power_limit(smi, "GPU-AAAA-1111") == "700.00 W"
    with pytest.raises(RuntimeError, match="no card with UUID cccc"):
        bench.smi_power_limit(smi, "cccc-3333")


def test_profile_dir_writes_a_trace_and_stamps_the_row(tmp_path, monkeypatch):
    monkeypatch.setenv("P2P_BENCH_PROFILE_DIR", str(tmp_path))
    # The gate's subprocess is the smoke fixture's to test; here it only costs time.
    monkeypatch.setattr(bench, "staticcheck_ok", lambda: True)
    rc, lines = _main(["--device", "cpu", "--smoke", "--repeats", "1"])
    assert rc == 0 and len(lines) == 1
    got = json.loads(lines[0])
    assert set(got) == set(bench.ROW_KEYS) | set(bench.PROFILE_KEYS)
    assert got["profiled"] is True
    assert os.path.getsize(got["profile_trace"]) > 0
    assert os.path.dirname(got["profile_trace"]) == str(tmp_path)
    # No device on the CPU: no busy share, no kernels.
    assert got["busy_share"] is None and got["top_kernels"] == []
    assert got["profiled_wall_s"] > 0 and len(got["runs"]) == 1


def _small_flood():
    graph = pt.erdos_renyi(300, 0.03, seed=1)
    rng = np.random.default_rng(1)
    sched = pt.Schedule(graph.n, rng.integers(0, graph.n, 40).astype(np.int32),
                        rng.integers(0, 4, 40).astype(np.int32))
    cfg = dict(nodes=300, prob=0.03, shares=40, gen_window=4, horizon=32, chunk=64)
    return graph, sched, DeviceGraph.build(graph, device=CPU), cfg


def test_headline_holds_every_run_to_the_reference():
    graph, sched, dg, cfg = _small_flood()
    ref = run_sync_sim(graph, sched, cfg["horizon"], chunk_size=cfg["chunk"], device="cpu")
    head = bench.headline(graph, sched, dg, cfg, 2, CPU, reference=ref)
    assert head["ticks"] == ref.extra["ticks_executed"] and len(head["runs"]) == 2
    other = pt.Schedule(graph.n, sched.origins[:20], sched.gen_ticks[:20])
    wrong = run_sync_sim(graph, other, cfg["horizon"], chunk_size=cfg["chunk"], device="cpu")
    with pytest.raises(AssertionError, match="differs from the reference"):
        bench.headline(graph, sched, dg, cfg, 1, CPU, reference=wrong)
    with pytest.raises(ValueError, match="repeats"):
        bench.headline(graph, sched, dg, cfg, 0, CPU)


def test_a_failing_serve_leg_raises(monkeypatch):
    def failed(cmd, **kwargs):
        return subprocess.CompletedProcess(cmd, 1, "", "boom")

    monkeypatch.setattr(bench.subprocess, "run", failed)
    with pytest.raises(RuntimeError, match="(?s)serve leg failed .exit 1.*boom"):
        bench.serve(CPU)
    assert bench.serve(CPU, smoke=True) is None


# --- the mesh legs and the serve leg at full size ------------------------------


def _jax_exchange_report():
    spec = importlib.util.spec_from_file_location(
        "jax_cost_report", os.path.join(REPO, "scripts", "cost_report.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.run_exchange_report(families=bench.EXCHANGE_FAMILIES)


@pytest.fixture(scope="module")
def legs():
    """The port's mesh legs (one spawned world of 8 gloo ranks) and serve
    leg (a subprocess, one torch thread: several test workers share the
    host's cores), while this process runs the JAX exchange report."""
    before = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        with ThreadPoolExecutor(2) as pool:
            mesh = pool.submit(bench.mesh_legs)
            served = pool.submit(bench.serve, CPU)
            want = _jax_exchange_report()
            return mesh.result(), served.result(), want
    finally:
        if before is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = before


@pytest.mark.parametrize("family", bench.EXCHANGE_FAMILIES)
def test_exchange_rows_equal_the_jax_sharded_runner(legs, family):
    got = {f["family"]: f for f in legs[0]["exchange"]["families"]}[family]
    want = {f["family"]: f for f in legs[2]["families"]}[family]
    for key in ("modeled_dense_words_per_tick", "achieved_delta_words_per_tick"):
        assert got[key] == want[key], key
    assert got["hub"] == want["hub"]
    assert got == want


def test_exchange_report_and_hub_summary(legs):
    mesh, _, want = legs
    assert mesh["exchange"]["ok"] and mesh["exchange"]["platform"] == "cpu" == want["platform"]
    hub = mesh["exchange_hub"]
    assert hub["platform"] == "cpu"
    assert [f["family"] for f in hub["families"]] == list(bench.EXCHANGE_FAMILIES)
    for fam, jfam in zip(hub["families"], want["families"]):
        assert fam["hub_count"] == jfam["hub"]["hub_count"] == bench.EXCHANGE["hub_rows"]
        assert fam["achieved_words_per_tick"] == jfam["hub"]["achieved_delta_words_per_tick"]
        assert (fam["winner"], fam["delta_over_hub"]) == (jfam["winner"], jfam["delta_over_hub"])


def test_sharded_campaign_replicas_are_bitwise(legs):
    cs = legs[0]["campaign_sharded"]
    assert cs["platform"] == "cpu"
    assert cs["bitwise_equal_replicas"] == cs["replicas"] == bench.REHEARSAL_REPLICAS
    assert (cs["replica_shards"], cs["node_shards"], cs["devices"]) == (2, 4, bench.MESH_RANKS)
    assert cs["nodes"] == bench.REHEARSAL["nodes"] and cs["delay_values"] > 1
    assert cs["campaign_warm_s"] > 0 and cs["solo_loop_warm_s"] > 0


def test_async_legs_are_checked(legs):
    at = legs[0]["async_ticks"]
    assert at["platform"] == "cpu"
    assert [(lg["ring_mode"], lg["exchange_mode"], lg["async_k"]) for lg in at["legs"]] == [
        ("replicated", "dense", 0), ("sharded", "dense", 0),
        ("sharded", "async-dense", 1), ("sharded", "async-dense", 2)]
    for lg in at["legs"]:
        assert lg["wall_per_tick_s"] == pytest.approx(lg["wall_s"] / bench.REHEARSAL["horizon"])
        assert (lg["modeled_overlap_fraction"] is None) == (lg["async_k"] == 0)


def test_serve_leg_runs_the_server_bench_smoke(legs):
    served = legs[1]
    assert served["bench"] == "serve" and served["device"] == "cpu" and served["smoke"]
    assert served["bitwise_ok"] is True and served["verified"] == served["requests"] > 0
