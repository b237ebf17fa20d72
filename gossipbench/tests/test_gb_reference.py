"""The plain reference against the program's CPU run of each entry at a
tiny size: every per-node counter, the ticks the loops ran and the
coverage rows, equal."""

import numpy as np
import pytest
import torch

from gossipbench import check, harness
from gossipbench.gen import topology as gen_topology
from gossipbench.reference import flood as ref
from gossipbench.tests import tiny

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def run_entry(entry_name, config, traffic, origins, gen_ticks, seed=5):
    from gossipbench import spec

    entry = spec.entry(entry_name)
    n = int(config["graph"]["n"])
    edges = gen_topology.edges_of(config["graph"], [seed, 1])
    staged = entry.stage(entry.prepare(CPU, config), n, edges)
    result = entry.run(staged, origins, gen_ticks, traffic)
    result["ticks"] = entry.ticks(result, staged, traffic)
    graph = (n, *ref.csr_from_edges(n, edges))
    expected, _ = entry.reference(harness.World(CPU), graph, origins, gen_ticks, traffic, config)
    return result, expected


CASES = [("burst32k", "er100k"), ("coverage4k", "ba1m"), ("renewal", "er100k")]


@pytest.mark.parametrize("mix,cfg", CASES)
@pytest.mark.parametrize("seed", [1, 2**31 + 11])
def test_entry_equals_reference(mix, cfg, seed):
    traffic, config = tiny.traffic(mix), tiny.config(cfg)
    cell = harness.spec.Cell("t", 1, config, traffic, [], [])
    origins, gen_ticks = harness.draw(cell, seed, 2, 0)
    result, expected = run_entry(traffic["entry"], config, traffic, origins, gen_ticks, seed)
    assert check.compare(result, expected) == {k: 0 for k in check.compare(result, expected)}
    assert result["ticks"] == expected["ticks"] > 0
    assert int(result["counters"]["processed"].sum()) > 0


@pytest.mark.parametrize("delay", [1, 2, 3])
@pytest.mark.parametrize("horizon", [6, 12, 40])
def test_horizon_and_delay(delay, horizon):
    """Shares cut by the horizon, longer links, several passes."""
    config = dict(tiny.config("er100k"), delay_ticks=delay)
    config["graph"] = {"family": "erdos_renyi", "n": 300, "p": 0.01}
    traffic = {"entry": "sync_sim", "horizon": horizon, "chunk_size": 64}
    rng = np.random.default_rng(horizon * 10 + delay)
    origins = rng.integers(0, 300, size=150).astype(np.int32)
    gen_ticks = np.sort(rng.integers(0, horizon + 4, size=150)).astype(np.int32)
    result, expected = run_entry("sync_sim", config, traffic, origins, gen_ticks)
    assert check.compare(result, expected) == {"counters_bad": 0, "ticks_bad": 0}


@pytest.mark.parametrize("delay", [1, 2])
def test_coverage_rows_and_ticks(delay):
    config = dict(tiny.config("ba1m"), delay_ticks=delay)
    config["graph"] = {"family": "barabasi_albert", "n": 600, "m": 2, "batch_divisor": 64}
    traffic = {"entry": "flood_coverage", "horizon": 12}  # the horizon cuts the flood
    origins = np.random.default_rng(delay).integers(0, 600, size=40).astype(np.int32)
    result, expected = run_entry("flood_coverage", config, traffic, origins,
                                 np.zeros(40, dtype=np.int32))
    assert check.compare(result, expected) == {"counters_bad": 0, "ticks_bad": 0,
                                               "coverage_bad": 0}


@pytest.mark.parametrize("mix,cfg", CASES)
def test_small_blocks_equal_one_block(mix, cfg):
    """The reference in many share blocks equals it in one."""
    traffic, config = tiny.traffic(mix), tiny.config(cfg)
    cell = harness.spec.Cell("t", 1, config, traffic, [], [])
    origins, gen_ticks = harness.draw(cell, 3, 2, 0)
    if origins.shape[0] <= 256:  # more shares than one small block holds
        origins, gen_ticks = np.tile(origins, 4), np.tile(gen_ticks, 4)
    n = int(config["graph"]["n"])
    indptr, indices = ref.csr_from_edges(n, gen_topology.edges_of(config["graph"], [3, 1]))
    p = ref.Problem(n, indptr, indices, origins, gen_ticks, int(traffic["horizon"]),
                    int(config["delay_ticks"]), traffic.get("chunk_size"))
    whole, occ = ref.flood(p, coverage=True, occupancy=True)
    parts, occ_parts = ref.flood(p, coverage=True, occupancy=True, dense_bytes=4 * n * 256)
    assert ref.block_columns(n, 4 * n * 256) == 256 < p.shares
    for k in ("generated", "received", "sent", "processed", "coverage"):
        assert np.array_equal(whole[k], parts[k]), k
    assert whole["ticks"] == parts["ticks"] and occ == occ_parts


def test_partials_add_up():
    """Blocks worked out apart and added equal the whole (the mesh shares
    the reference's blocks out over its ranks so)."""
    edges = gen_topology.erdos_renyi(500, 0.01, 3)
    indptr, indices = ref.csr_from_edges(500, edges)
    rng = np.random.default_rng(0)
    p = ref.Problem(500, indptr, indices, rng.integers(0, 500, 700).astype(np.int32),
                    np.sort(rng.integers(0, 9, 700)).astype(np.int32), 20, 1, 512)
    blocks = ref.block_plan(p, 256)
    whole = ref.flood_blocks(p, blocks, device=CPU, occupancy=True)
    parts = [ref.flood_blocks(p, blocks[i::3], device=CPU, occupancy=True) for i in range(3)]
    total = ref.Partial(
        sum(q.received for q in parts), sum(q.layers for q in parts),
        sum(q.sectors for q in parts),
        {c: np.logical_or.reduce([q.active[c] for q in parts if c in (q.active or {})])
         for c in whole.active})
    assert np.array_equal(total.received, whole.received)
    assert np.array_equal(total.layers, whole.layers)
    assert ref.occupancy_counts(p, total) == ref.occupancy_counts(p, whole)


def test_csr_from_edges_merges_and_symmetrises():
    indptr, indices = ref.csr_from_edges(4, np.array([[0, 1], [1, 0], [2, 2], [3, 1], [0, 1]]))
    assert indptr.tolist() == [0, 1, 3, 3, 4]
    assert indices.tolist() == [1, 0, 3, 1]
