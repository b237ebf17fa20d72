"""The port's sharded flood engine (``p2p_gossip_tpu_torch.parallel``) on
gloo ranks of the CPU against the JAX package's sharded engine on the
8-virtual-device CPU mesh of the same shape, and against the port's
single-device engine: bitwise on counters and ``stats.extra['exchange']``
/ ``['ring']``, for every mesh shape, ring mode and exchange
(tests/test_torch_sharded_options.py: coverage, snapshots, the connect
window, checkpoints and telemetry).

One world of 4 spawned ranks (`parallel.launch.spawn`) runs every case of
this module, each on a mesh over the world's first ranks; the
parametrised tests read its results. The workers import only the port."""

import numpy as np
import pytest

import jax

import p2p_gossip_tpu as pg
from p2p_gossip_tpu.models.latency import lognormal_delays as jax_lognormal
from p2p_gossip_tpu.parallel.engine_sharded import run_sharded_sim as jax_sharded
from p2p_gossip_tpu.parallel.mesh import make_mesh as jax_mesh

import p2p_gossip_tpu_torch as pt
from p2p_gossip_tpu_torch.engine.sync import run_sync_sim
from p2p_gossip_tpu_torch.models.latency import lognormal_delays
from p2p_gossip_tpu_torch.parallel import async_ticks, launch

SIM = "p2p_gossip_tpu_torch.parallel.engine_sharded:run_sharded_sim"
SHAPES = [(1, 1), (2, 1), (4, 1), (1, 2), (2, 2)]  # (nodes, shares)
MODES = {
    "replicated": dict(ring_mode="replicated"),
    "sharded": dict(ring_mode="sharded"),
    "delta": dict(exchange="delta"),
    "hub": dict(exchange="hub", hub_rows=8),
    "async_delta_k1": dict(exchange="async-delta", async_k=1),
    "async_delta_k2": dict(exchange="async-delta", async_k=2),
}
HORIZON = 120


def _hazard(pkg, lognormal):
    """103 rows (padded to 104 over 4 node shards), lognormal delays,
    churn, loss 0.5 and a schedule of several 32-share passes."""
    g = pkg.erdos_renyi(103, 0.06, seed=2)
    return dict(
        g=g,
        d=lognormal(g, mean_ticks=2.0, sigma=0.5, max_ticks=4, seed=2),
        sched=pkg.poisson_schedule(103, sim_time=0.6, tick_dt=0.01, rate=1.0, seed=2),
        loss=pkg.LinkLossModel(0.5, seed=3),
        churn=pkg.random_churn(103, HORIZON, outage_prob=0.3, mean_down_ticks=40, seed=5),
    )


def _sim_kwargs(h, **kw):
    return dict(ell_delays=h["d"], chunk_size=32, loss=h["loss"], churn=h["churn"], **kw)


def _cases():
    """(name, nodes, shares, target, args, kwargs) of every case."""
    h = _hazard(pt, lognormal_delays)
    cases = [
        (f"{name}-{n}x{s}", n, s, SIM, (h["g"], h["sched"], HORIZON), _sim_kwargs(h, **kw))
        for (n, s) in SHAPES for name, kw in MODES.items()
    ]
    return cases


@pytest.fixture(scope="module")
def runs():
    """Every case's results, rank by rank, from one world of 4 ranks."""
    cases = _cases()
    results = launch.spawn(launch.call_on_meshes, 4, [c[1:] for c in cases],
                           timeout_s=120.0)
    return {case[0]: [r[i] for r in results if r[i] is not None]
            for i, case in enumerate(cases)}


def _jax_mesh(nodes, shares):
    return jax_mesh(nodes, shares, devices=jax.devices("cpu"))


def _same_stats(a, b):
    for f in ("generated", "received", "forwarded", "sent", "processed", "degree"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f


def _one(results):
    """Rank 0's result, after checking every rank of the mesh returned
    the same global stats."""
    for r in results[1:]:
        _same_stats(r, results[0])
    return results[0]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("mode", list(MODES))
def test_sim_matches_jax_and_single_device(mode, shape, runs):
    """Every mesh shape x ring mode x exchange on the hazard graph: the
    JAX sharded engine's counters, ring and exchange reports, and the
    port's single-device engine's counters (with async K's clamped
    cross-shard delays)."""
    n, s = shape
    port = _one(runs[f"{mode}-{n}x{s}"])
    h = _hazard(pg, jax_lognormal)
    want = jax_sharded(h["g"], h["sched"], HORIZON, _jax_mesh(n, s),
                       **_sim_kwargs(h, **MODES[mode]))
    _same_stats(port, want)
    assert port.extra["exchange"] == want.extra["exchange"]
    assert port.extra["ring"] == want.extra["ring"]
    th = _hazard(pt, lognormal_delays)
    k = MODES[mode].get("async_k", 0)
    d = async_ticks.clamp_flood_delays(th["g"], n, k, th["d"]) if k else th["d"]
    solo = run_sync_sim(th["g"], th["sched"], HORIZON, ell_delays=d, chunk_size=32 * s,
                        loss=th["loss"], churn=th["churn"], device="cpu")
    _same_stats(port, solo)
