"""The million-node entry point (``python -m p2p_gossip_tpu_torch.scale``)
on the CPU at a small size, and the port's resident-memory model
(``engine.sync.flood_resident_hbm_bytes`` / ``auto_chunk_shares``).

- The scale run prints the JAX script's JSON line shape, and its flood
  equals the JAX package's ``run_flood_coverage`` on the same cached graph
  (loaded by the JAX package) and origins: processed node-updates and
  time-to-99% coverage.
- The model counts the staged DeviceGraph's tensors exactly (their summed
  ``nbytes`` on the CPU) plus the chunk state and the tick's temporaries;
  ``auto_chunk_shares`` keeps the JAX package's halving rule, floor,
  warning and None-when-it-fits contract."""

import json
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest

import p2p_gossip_tpu_torch as pt
from p2p_gossip_tpu.engine.sync import run_flood_coverage as jax_flood_coverage
from p2p_gossip_tpu.engine.sync import time_to_coverage as jax_ttc
from p2p_gossip_tpu.models import topology as jax_topology
from p2p_gossip_tpu_torch.engine import sync
from p2p_gossip_tpu_torch.engine.sync import DeviceGraph
from p2p_gossip_tpu_torch.ops.bitmask import num_words

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _scale(*args):
    # One torch thread: the CPU tick engine's (N, W) passes would otherwise
    # wait on busy cores when the suite runs in parallel workers.
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    env.pop("P2P_HBM_BUDGET_GB", None)
    proc = subprocess.run(
        [sys.executable, "-m", "p2p_gossip_tpu_torch.scale", "--cpu", *args],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    return proc


def _record(stderr: str) -> dict:
    lines = [ln for ln in stderr.splitlines() if ln.startswith("scale-record: ")]
    assert len(lines) == 1, stderr
    return json.loads(lines[0][len("scale-record: "):])


@pytest.mark.parametrize("topology", ["er", "ba"])
def test_scale_run_equals_the_jax_flood(topology, tmp_path):
    cache = str(tmp_path / f"{topology}.npz")
    args = ["--nodes", "2000", "--shares", "64", "--horizon", "48", "--seed", "3",
            "--topology", topology, "--prob", "0.004", "--cache", cache]
    cold = _scale(*args)
    assert cold.returncode == 0, cold.stderr
    line = json.loads(cold.stdout.strip().splitlines()[-1])
    assert sorted(line) == ["metric", "unit", "value", "vs_baseline"]
    assert line["unit"] == "s" and line["metric"].endswith("(one device) [cpu]")
    assert "64 shares on a 2000-node" in line["metric"]
    rec = _record(cold.stderr)
    assert "build_s" in rec and "cache_save_s" in rec and rec["cache_bytes"] > 0
    # The JAX package loads the port's cache and floods the same origins.
    graph, fp = jax_topology.load_graph_cache(cache)
    assert fp == jax_topology.scale_graph_fingerprint(topology, 2000, 0.004, 3, 3)
    origins = np.random.default_rng(3).integers(0, 2000, 64).astype(np.int32)
    stats, cov = jax_flood_coverage(graph, origins, 48)
    ttc = jax_ttc(cov, 2000, 0.99)
    assert rec["processed"] == stats.totals()["processed"]
    assert rec["ttc99_median"] == float(np.median(ttc))
    assert rec["ttc99_max"] == int(ttc.max())
    assert rec["full_coverage"] == (rec["processed"] == 64 * 2000)
    assert rec["model_bytes"] == sync.flood_resident_hbm_bytes(graph.degree, 128)
    assert rec["peak_device_bytes"] is None and rec["ticks"] is None  # not on a card
    warm = _scale(*args)
    assert warm.returncode == 0, warm.stderr
    again = _record(warm.stderr)
    assert "cache_load_s" in again and "build_s" not in again
    assert again["processed"] == rec["processed"]
    assert again["ttc99_median"] == rec["ttc99_median"]
    # Other build flags against the same cache: refused, as in the JAX script.
    other = _scale(*args[:-2], "--seed", "4", "--cache", cache)
    assert other.returncode == 2
    assert "was built with different topology flags" in other.stderr


def _staged_nbytes(dg: DeviceGraph) -> int:
    tensors = [dg.ell_idx, dg.ell_delay, dg.ell_mask, dg.degree]
    for bucket in dg.buckets or ():
        tensors += [t for t in bucket if t is not None]
    return sum(t.numel() * t.element_size() for t in tensors)


@pytest.mark.parametrize("kind,delays", [("er", False), ("er", True), ("ba", False),
                                         ("ba", True), ("small", False), ("small", True)])
@pytest.mark.parametrize("w", [2, 128])
def test_resident_model_counts_the_staging_and_state(kind, delays, w):
    if kind == "er":
        g = pt.erdos_renyi(5000, 0.006, seed=1)
    elif kind == "ba":
        g = pt.barabasi_albert(6000, m=3, seed=2)
    else:  # under 4096 nodes: full-width staging
        g = pt.erdos_renyi(400, 0.03, seed=3)
    d = pt.lognormal_delays(g, 2.0, 0.5, 5, seed=0) if delays else None
    dg = DeviceGraph.build(g, d, device="cpu")
    n, ring = g.n, dg.ring_size
    state = (1 + ring) * n * w * 4 + ring * n * 4 + 2 * n * 4
    tick = 4 * n * w * 4 + 4 * n * 4
    model = sync.flood_resident_hbm_bytes(
        g.degree, w, ring_size=ring, uniform_delay=dg.uniform_delay is not None
    )
    assert model == _staged_nbytes(dg) + state + tick


def test_auto_chunk_shares_rule():
    g = pt.erdos_renyi(5000, 0.006, seed=1)
    deg = g.degree

    def model(shares):
        return sync.flood_resident_hbm_bytes(deg, num_words(shares), 8)

    assert sync.auto_chunk_shares(deg, 64, 8, 0) is None  # budgeting off
    assert sync.auto_chunk_shares(deg, 64, 8, model(4096)) is None  # fits
    assert sync.auto_chunk_shares(deg, 8192, 8, model(8192)) is None
    assert sync.auto_chunk_shares(deg, 64, 8, model(4096) - 1) == 2048
    assert sync.auto_chunk_shares(deg, 64, 8, model(1024)) == 1024
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert sync.auto_chunk_shares(deg, 64, 8, model(512)) == 512
    with pytest.warns(RuntimeWarning, match="cannot be met"):
        assert sync.auto_chunk_shares(deg, 64, 8, model(512) - 1) == 512
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # the 4000-share floor fits: no warning
        assert sync.auto_chunk_shares(deg, 64, 8, model(4096) - 1, min_chunk=4000) == 4000


def test_device_budget(monkeypatch):
    monkeypatch.setenv("P2P_HBM_BUDGET_GB", "12.5")
    assert sync.device_budget_bytes("cpu") == 12.5e9
    monkeypatch.delenv("P2P_HBM_BUDGET_GB")
    assert sync.device_budget_bytes("cpu") == 0.0
