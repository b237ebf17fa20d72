"""``python -m p2p_gossip_tpu_torch.scale --mesh SxN`` (share shards x node
shards) on 2 gloo ranks of the CPU, against the JAX package's
``run_sharded_flood_coverage`` on a JAX CPU mesh of the same shape (the
JAX ``scripts/scale_1m.py --mesh`` path) and the port's run without a
mesh: processed node-updates and the per-tick coverage rows (the record's
``coverage_sha256``) equal, bitwise; a cold two-rank run with ``--cache``
leaves one valid cache file that rank 0 built and rank 1 loaded; only
rank 0 prints the JSON line, whose metric names the mesh.

One world of 2 spawned ranks (`parallel.launch.spawn`) runs both shapes."""

import contextlib
import hashlib
import io
import json

import numpy as np
import pytest

import jax

from p2p_gossip_tpu.engine.sync import time_to_coverage as jax_ttc
from p2p_gossip_tpu.models import topology as jax_topology
from p2p_gossip_tpu.parallel.engine_sharded import run_sharded_flood_coverage as jax_sharded
from p2p_gossip_tpu.parallel.mesh import make_mesh as jax_mesh

from p2p_gossip_tpu_torch import scale
from p2p_gossip_tpu_torch.parallel import launch

SHAPES = ("1x2", "2x1")
NODES, SHARES, HORIZON, SEED = 300, 64, 16, 3


def _argv(cache, mesh=None):
    return (["--cpu", "--nodes", str(NODES), "--prob", "0.02", "--shares", str(SHARES),
             "--horizon", str(HORIZON), "--seed", str(SEED), "--cache", cache]
            + (["--mesh", mesh] if mesh else []))


def _run(argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = scale.main(argv)
    records = [json.loads(ln[len("scale-record: "):]) for ln in err.getvalue().splitlines()
               if ln.startswith("scale-record: ")]
    return rc, out.getvalue(), records


def _world(cache):
    """Every rank: scale.main on each mesh shape (the first run cold)."""
    results = []
    for shape in SHAPES:
        results.append(_run(_argv(cache, shape)))
        launch.progress()
    return results


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cache = str(tmp_path_factory.mktemp("scale_mesh") / "er.npz")
    ranks = launch.spawn(_world, 2, cache, timeout_s=120.0)
    return ranks, cache


def _jax_reference(cache, shares_shards, node_shards):
    graph, _ = jax_topology.load_graph_cache(cache)
    origins = np.random.default_rng(SEED).integers(0, graph.n, SHARES).astype(np.int32)
    mesh = jax_mesh(node_shards, shares_shards, devices=jax.devices("cpu")[:2])
    stats, cov = jax_sharded(graph, origins, HORIZON, mesh)
    return graph, stats, np.asarray(cov)


@pytest.mark.parametrize("shape", SHAPES)
def test_mesh_run_equals_the_jax_sharded_flood(shape, runs):
    ranks, cache = runs
    rc, out, records = ranks[0][SHAPES.index(shape)]
    assert rc == 0 and len(records) == 1
    rec = records[0]
    s, n = (int(x) for x in shape.split("x"))
    graph, stats, cov = _jax_reference(cache, s, n)
    assert rec["processed"] == int(stats.totals()["processed"])
    assert rec["coverage_sha256"] == hashlib.sha256(cov.astype(np.int64).tobytes()).hexdigest()
    ttc = jax_ttc(cov, graph.n, 0.99)
    assert rec["ttc99_median"] == float(np.median(ttc)) and rec["ttc99_max"] == int(ttc.max())
    assert rec["mesh"] == {"shares": s, "nodes": n}
    assert len(rec["rank_resident_bytes"]) == 2 and min(rec["rank_resident_bytes"]) > 0
    line = json.loads(out.strip().splitlines()[-1])
    assert f"({shape} mesh)" in line["metric"]


@pytest.fixture(scope="module")
def single(runs):
    """The run without a mesh, on the cache the world built."""
    rc, _, records = _run(_argv(runs[1]))
    assert rc == 0
    return records[0]


@pytest.mark.parametrize("shape", SHAPES)
def test_mesh_run_equals_the_run_without_a_mesh(shape, runs, single):
    mesh_rec = runs[0][0][SHAPES.index(shape)][2][0]
    for key in ("processed", "full_coverage", "ttc99_median", "ttc99_max", "coverage_sha256"):
        assert mesh_rec[key] == single[key], key


def test_only_rank_0_reports_and_the_cold_cache_is_built_once(runs):
    ranks, cache = runs
    for rc, out, records in ranks[1]:
        assert rc == 0 and out == "" and records == []
    cold = ranks[0][0][2][0]
    assert "build_s" in cold and "cache_save_s" in cold
    warm = ranks[0][1][2][0]
    assert "cache_load_s" in warm and "build_s" not in warm
    graph, fp = jax_topology.load_graph_cache(cache)
    assert fp == jax_topology.scale_graph_fingerprint("er", NODES, 0.02, 3, SEED)
    assert graph.n == NODES
