"""The push-pull cells at tiny sizes on the CPU: both entries against the
plain reference (`reference/pushpull.py`), the control and a broken
program read not correct, the frozen delay draw and pick hash against the
program's, the configuration's and mixes' keys, the readers."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from gossipbench import check, harness, spec
from gossipbench.gen import delays as gen_delays
from gossipbench.gen import topology as gen_topology
from gossipbench.reference import flood as ref_flood
from gossipbench.reference import pushpull
from gossipbench.tests import tiny

CPU = torch.device("cpu")
CELLS = [("pushpull.ba1m-lognormal.coverage4k", "pushpull-coverage4k", "ba1m-lognormal"),
         ("pushpull.er100k.campaign8", "campaign8", "er100k")]
ENV = dict(os.environ, OMP_NUM_THREADS="1")
ENV.pop("JAX_PLATFORMS", None)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cell(mix, cfg, **traffic):
    return spec.Cell("t", 1, tiny.config(cfg), dict(tiny.traffic(mix), **traffic), [], [])


def run_tiny(mix, cfg, seed, control=False, **traffic):
    run = harness.run_cell(_cell(mix, cfg, **traffic), seed, 0.2, False, harness.World(CPU),
                           control=control)
    return check.verdict(run.per_sim)


@pytest.mark.parametrize("seed", [3, 2**31 + 7])
@pytest.mark.parametrize("name,mix,cfg", CELLS)
def test_entry_equals_reference(name, mix, cfg, seed):
    cell = _cell(mix, cfg)
    entry = spec.entry(cell.entry)
    n = int(cell.config["graph"]["n"])
    edges = gen_topology.edges_of(cell.config["graph"], [seed, 1])
    staged = entry.stage(entry.prepare(CPU, cell.config), n, edges)
    origins, gen_ticks = harness.draw(cell, seed, 2, 0)
    result = entry.run(staged, origins, gen_ticks, cell.traffic)
    graph = (n, *ref_flood.csr_from_edges(n, edges))
    expected, occ = entry.reference(harness.World(CPU), graph, origins, gen_ticks,
                                    cell.traffic, cell.config, occupancy=True)
    assert check.compare(result, expected) == {"counters_bad": 0, "coverage_bad": 0}
    passes = -(-origins.shape[0] // int(cell.traffic.get("chunk_size", 128)))
    assert entry.ticks(result, staged, cell.traffic) == cell.traffic["horizon"] * passes
    assert int(expected["received"].sum()) > 0 and int(expected["sent"].sum()) > 0
    assert occ["sectors"] > 0 and occ["edges"] > 0 and occ["nodes"] > 0


@pytest.mark.parametrize("name,mix,cfg", CELLS)
def test_sound_run_is_correct(name, mix, cfg):
    correct, table, failed = run_tiny(mix, cfg, 2**31 + 3)
    assert correct and failed == 0, table


@pytest.mark.parametrize("horizon", [None, 60])
@pytest.mark.parametrize("seed", [11, 2**31 + 12])
@pytest.mark.parametrize("name,mix,cfg", CELLS)
def test_control_is_not_correct(name, mix, cfg, seed, horizon):
    """Also with a horizon far past saturation, where most rounds bring
    no node a new bit."""
    extra = {} if horizon is None else {"horizon": horizon}
    correct, table, failed = run_tiny(mix, cfg, seed, control=True, **extra)
    assert not correct and failed >= 1
    assert table["coverage_bad"]["value"] >= 1


def _break(fault, monkeypatch):
    """The program broken under the timed path: a round whose exchange
    brings nothing, or an answer altered where it is produced."""
    from p2p_gossip_tpu_torch.models import protocols

    loop = protocols._run_chunk
    if fault == "no-exchange":
        def base_only(src, offsets, entries, *, pull_row=None, base=None, andnot=False, out,
                      plain=False):
            return out.copy_(base)

        monkeypatch.setattr(protocols.kernels, "scatter_or", base_only)
    else:
        def altered(*a, **k):
            out = loop(*a, **k)
            out[0][0] += 1  # received of node 0
            return out

        monkeypatch.setattr(protocols, "_run_chunk", altered)


@pytest.mark.parametrize("fault", ["no-exchange", "altered"])
@pytest.mark.parametrize("name,mix,cfg", CELLS)
def test_broken_program_is_not_correct(name, mix, cfg, fault, monkeypatch):
    _break(fault, monkeypatch)
    correct, table, _ = run_tiny(mix, cfg, 2**31 + 5)
    assert not correct, table


def test_reference_in_blocks_equals_one_block():
    n = 400
    indptr, indices = ref_flood.csr_from_edges(n, gen_topology.barabasi_albert(n, 3, 2))
    d = gen_delays.lognormal_csr(n, indptr, indices, 2.0, 0.5, 8, 4)
    rng = np.random.default_rng(1)
    origins = rng.integers(0, n, 300).astype(np.int32)
    p = pushpull.Problem(n, indptr, indices, d, origins, np.zeros(300, np.int32), 20, 99)
    whole, occ = pushpull.solve(p, CPU, occupancy=True)
    budget = n * (p.ring + 12) * 128  # one unit a block
    assert pushpull.block_columns(n, p.ring, budget) == 128
    parts, occ_parts = pushpull.solve(p, CPU, occupancy=True, budget=budget)
    for k in whole:
        assert np.array_equal(whole[k], parts[k]), k
    assert occ == occ_parts


def test_frozen_copies_equal_the_program():
    """The delay draw and the pick hash the reference keeps equal the
    program's on the same graph (a later change to the program cannot move
    them, but they start equal)."""
    from p2p_gossip_tpu_torch.models.latency import lognormal_edge_delays
    from p2p_gossip_tpu_torch.models.partnersel import pick_index_np
    from p2p_gossip_tpu_torch.models.topology import Graph

    n = 500
    edges = gen_topology.barabasi_albert(n, 3, 7)
    g = Graph.from_edges(n, edges)
    indptr, indices = ref_flood.csr_from_edges(n, edges)
    assert np.array_equal(g.indptr, indptr) and np.array_equal(g.indices, indices)
    np.testing.assert_array_equal(gen_delays.lognormal_csr(n, indptr, indices, 2.0, 0.5, 8, 13),
                                  lognormal_edge_delays(g, 2.0, 0.5, 8, seed=13))
    nodes = np.arange(n)
    for t, seed in ((0, 0), (7, 2**31 - 1), (95, 123456789)):
        np.testing.assert_array_equal(pushpull.pick(seed, nodes, t, g.degree),
                                      pick_index_np(nodes, t, 0, g.degree, seed))


@pytest.mark.parametrize("name,mix,cfg", CELLS)
def test_cells_load_and_refuse_unread_keys(tmp_path, name, mix, cfg):
    c = spec.cell(name)
    assert c.entry == spec.traffic_of(mix)["entry"] and c.config["name"] == cfg
    assert {m["name"] for m in c.end_to_end} == {"node_updates_per_s.coverage", "setup_s"}
    assert {m["name"].split(".")[0] for m in c.per_layer} >= {
        "round_host_ms", "draw_host_ms", "exchange_roofline_pct", "stage_s"}
    root = tiny.write_root(str(tmp_path))
    path = os.path.join(root, "gossipbench", "configs", f"{cfg}.json")
    d = json.load(open(path))
    d["churn"] = 0.1
    json.dump(d, open(path, "w"))
    with pytest.raises(ValueError, match="read by nothing"):
        spec.cell(name, root=root)
    if "delays" in d:
        with pytest.raises(ValueError, match="delays"):
            gen_delays.edge_delays(dict(d["delays"], burst=1), 3, np.zeros(4, np.int64),
                                   np.zeros(0, np.int64))


def test_readers_off_the_card_and_on_the_spans():
    from p2p_gossip_tpu_torch.telemetry import sink

    import p2p_gossip_tpu_torch as pt
    from p2p_gossip_tpu_torch.models.protocols import run_pushpull_sim

    rec = {"on_device": False, "sims": 1, "ticks": 5, "window_s": 1.0, "traces": None,
           "peak_hbm_bytes_s": None, "bytes_gather": 10.0, "chips": 1}
    for name in ("round_host_ms", "draw_host_ms", "exchange_roofline_pct",
                 "device_idle_pct", "device_ms_per_sim", "entry_host_ms_per_sim"):
        assert spec.metric_reader(f"{name}.pushpull")(rec) is None, name
    sink.reset()
    try:
        g = pt.erdos_renyi(60, 0.1, seed=1)
        sched = pt.Schedule(60, np.arange(40, dtype=np.int32), np.zeros(40, np.int32))
        sink.configure(None, rings=False)
        run_pushpull_sim(g, sched, 20, chunk_size=32, device="cpu")
        sink.close()
        from gossipbench import program_spans

        events = program_spans.sink_spans()
        secs, count = program_spans.seconds_by_name(events), program_spans.count_by_name(events)
        on = dict(rec, on_device=True)
        assert count["round"] == 40 and count["draw"] == 4
        assert spec.metric_reader("round_host_ms.pushpull")(on) == pytest.approx(
            secs["round"] * 1e3 / 40)
        assert spec.metric_reader("draw_host_ms.pushpull")(on) == pytest.approx(
            secs["draw"] * 1e3 / 40)
    finally:
        sink.reset()
    trace = {"device_ops": [["void scatter_or_kernel<unsigned int, false>(...)", 0.002],
                            ["void scatter_or_atomic_kernel<unsigned int>(...)", 1.0],
                            ["gather_or_kernel", 5.0]]}
    on = dict(rec, on_device=True, traces=[trace], peak_hbm_bytes_s=1e12, bytes_gather=1e9)
    assert spec.metric_reader("exchange_roofline_pct.pushpull")(on) == pytest.approx(50.0)


@pytest.mark.parametrize("name", [c[0] for c in CELLS])
def test_whole_traced_run_on_the_cpu(tmp_path, name):
    root = tiny.write_root(str(tmp_path))
    out = subprocess.run([sys.executable, "-m", "gossipbench", "--device", "cpu", "--root", root,
                          "--workload", name, "--seed", str(2**31 + 99), "--seconds", "0.3",
                          "--trace", "1"], capture_output=True, text=True, cwd=spec.ROOT,
                         env=ENV, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["checks"]["checked"]["value"] >= 1
    # on the CPU the device's and the spans' readers find nothing to read
    assert set(line["metrics"]) == {"stage_s", "ms_per_tick.pushpull"}
