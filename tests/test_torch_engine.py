"""The port's flood engine against the JAX package's and the event engine.

Each case is one of tests/test_sync_engine.py's parity cases. The port runs
with ``device="cpu"`` (its kernels' plain torch versions); graphs and
schedules come from the port's own numpy builders, which must give the
JAX package's graphs and schedules for the same seed. Counters,
``ticks_executed`` and coverage rows must be bitwise equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import p2p_gossip_tpu as pg
import p2p_gossip_tpu_torch as pt
from p2p_gossip_tpu.engine.event import run_event_sim
from p2p_gossip_tpu.engine.sync import DeviceGraph as JaxDeviceGraph
from p2p_gossip_tpu.engine.sync import run_flood_coverage as jax_flood_coverage
from p2p_gossip_tpu.engine.sync import run_sync_sim as jax_sync_sim
from p2p_gossip_tpu.engine.sync import time_to_coverage as jax_time_to_coverage
from p2p_gossip_tpu.models import latency as jlatency
from p2p_gossip_tpu.models import topology as jtopo
from p2p_gossip_tpu.ops import ell as jell
from p2p_gossip_tpu_torch import convert
from p2p_gossip_tpu_torch.engine.sync import (
    DeviceGraph,
    _chunk_state,
    _tick,
    run_flood_coverage,
    run_sync_sim,
    time_to_coverage,
)
from p2p_gossip_tpu_torch.models import latency, topology
from p2p_gossip_tpu_torch.ops import kernels
from p2p_gossip_tpu_torch.ops.ell import propagate_bucketed


def _same_stats(a, b):
    for field in ("generated", "received", "forwarded", "sent", "processed", "degree"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field), err_msg=field)


def _check(port, jax_stats, event_stats=None):
    _same_stats(port, jax_stats)
    assert port.extra["ticks_executed"] == jax_stats.extra["ticks_executed"]
    if event_stats is not None:
        assert port.equal_counts(event_stats)
    port.check_conservation()


def _to_port_dg(jdg):
    return convert.device_graph_from_numpy(
        jdg.n, jdg.ell_idx, jdg.ell_delay, jdg.ell_mask, jdg.degree,
        jdg.ring_size, jdg.uniform_delay, jdg.buckets, device="cpu",
    )


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_parity_er_constant_delay(seed):
    g = pt.erdos_renyi(100, 0.05, seed=seed)
    sched = pt.uniform_renewal_schedule(100, sim_time=20.0, tick_dt=0.005, seed=seed)
    jg = pg.erdos_renyi(100, 0.05, seed=seed)
    jsched = pg.uniform_renewal_schedule(100, sim_time=20.0, tick_dt=0.005, seed=seed)
    horizon = int(20.0 / 0.005)
    port = run_sync_sim(g, sched, horizon, device="cpu")
    _check(port, jax_sync_sim(jg, jsched, horizon), run_event_sim(jg, jsched, horizon))


def test_parity_heterogeneous_delays():
    g = pt.erdos_renyi(80, 0.06, seed=3)
    jg = pg.erdos_renyi(80, 0.06, seed=3)
    d = latency.lognormal_delays(g, mean_ticks=2.0, sigma=0.6, max_ticks=5, seed=1)
    jd = jlatency.lognormal_delays(jg, mean_ticks=2.0, sigma=0.6, max_ticks=5, seed=1)
    np.testing.assert_array_equal(d, jd)
    sched = pt.uniform_renewal_schedule(80, sim_time=3.0, tick_dt=0.005, seed=3)
    jsched = pg.uniform_renewal_schedule(80, sim_time=3.0, tick_dt=0.005, seed=3)
    port = run_sync_sim(g, sched, 700, ell_delays=d, device="cpu")
    _check(
        port, jax_sync_sim(jg, jsched, 700, ell_delays=jd),
        run_event_sim(jg, jsched, 700, ell_delays=jd),
    )


@pytest.mark.parametrize("horizon", [3, 7, 15])
def test_parity_truncated_horizon(horizon):
    g = topology.ring_graph(40)
    jg = jtopo.ring_graph(40)
    sched = pt.uniform_renewal_schedule(40, sim_time=2.0, tick_dt=0.1, seed=4)
    jsched = pg.uniform_renewal_schedule(40, sim_time=2.0, tick_dt=0.1, seed=4)
    port = run_sync_sim(g, sched, horizon, device="cpu")
    _check(port, jax_sync_sim(jg, jsched, horizon), run_event_sim(jg, jsched, horizon))


def test_parity_scale_free_topology():
    g = topology.barabasi_albert(200, m=2, seed=5)
    jg = jtopo.barabasi_albert(200, m=2, seed=5)
    sched = pt.poisson_schedule(200, sim_time=5.0, tick_dt=0.01, rate=0.1, seed=5)
    jsched = pg.poisson_schedule(200, sim_time=5.0, tick_dt=0.01, rate=0.1, seed=5)
    port = run_sync_sim(g, sched, 600, device="cpu")
    _check(port, jax_sync_sim(jg, jsched, 600), run_event_sim(jg, jsched, 600))


def test_parity_multiple_chunks():
    g = pt.erdos_renyi(60, 0.08, seed=6)
    jg = pg.erdos_renyi(60, 0.08, seed=6)
    sched = pt.uniform_renewal_schedule(60, sim_time=40.0, tick_dt=0.01, seed=6)
    jsched = pg.uniform_renewal_schedule(60, sim_time=40.0, tick_dt=0.01, seed=6)
    assert sched.num_shares > 128
    port = run_sync_sim(g, sched, 4000, chunk_size=128, device="cpu")
    _check(
        port, jax_sync_sim(jg, jsched, 4000, chunk_size=128),
        run_event_sim(jg, jsched, 4000),
    )


def test_empty_schedule():
    g = topology.ring_graph(8)
    empty = np.array([], dtype=np.int32)
    port = run_sync_sim(g, pt.Schedule(8, empty, empty), 10, device="cpu")
    jax_stats = jax_sync_sim(jtopo.ring_graph(8), pg.Schedule(8, empty, empty), 10)
    _check(port, jax_stats)
    assert port.totals()["processed"] == 0 and port.extra["ticks_executed"] == 0


def test_flood_coverage_matches_jax():
    g = pt.erdos_renyi(128, 0.05, seed=7)
    jg = pg.erdos_renyi(128, 0.05, seed=7)
    stats, cov = run_flood_coverage(g, [0, 17, 63], 64, device="cpu")
    jstats, jcov = jax_flood_coverage(jg, [0, 17, 63], 64)
    assert cov.dtype == jcov.dtype and cov.shape == jcov.shape == (64, 3)
    np.testing.assert_array_equal(cov, jcov)
    _same_stats(stats, jstats)
    assert (np.diff(cov, axis=0) >= 0).all() and (cov[-1] == g.n).all()
    np.testing.assert_array_equal(
        time_to_coverage(cov, g.n, 0.99), jax_time_to_coverage(jcov, g.n, 0.99)
    )
    stats.check_conservation()


def test_flood_coverage_per_edge_bucketed_matches_jax():
    g = topology.barabasi_albert(300, m=3, seed=2)
    jg = jtopo.barabasi_albert(300, m=3, seed=2)
    d = latency.lognormal_delays(g, max_ticks=4, seed=8)
    origins = np.arange(0, 300, 7)
    jdg = JaxDeviceGraph.build(jg, d, bucketed=True)
    _, jcov = jax_flood_coverage(jg, origins, 40, device_graph=jdg, chunk_size=64)
    _, cov = run_flood_coverage(
        g, origins, 40, device_graph=_to_port_dg(jdg), chunk_size=64, device="cpu"
    )
    np.testing.assert_array_equal(cov, jcov)


def test_flood_coverage_horizon_past_quiescence_filled():
    g = topology.ring_graph(16)
    _, cov = run_flood_coverage(g, [0], 20, device="cpu")
    _, jcov = jax_flood_coverage(jtopo.ring_graph(16), [0], 20)
    np.testing.assert_array_equal(cov, jcov)
    assert (cov[9:, 0] == 16).all()


# Bytes per node of a tick outside the gather: seen read and written, the
# new slot written (W words each), its occupancy word written, and the int32
# counters received and sent read and written and degree read.
def _tick_node_bytes(w):
    return 3 * w * 4 + 4 + 5 * 4


def test_hbm_model_counts_valid_edges():
    """The must-move bytes of a tick: every node of a ring is the source of
    a valid edge, so the gather reads each of the 64 rows (W words and an
    occupancy word) once, plus the staged ELL's int32 index and bool mask."""
    g = topology.ring_graph(64)
    dg = DeviceGraph.build(g, device="cpu")
    w = 4
    assert dg.ell_idx.numel() == 128 and dg.uniform_delay == 1
    want = 64 * (w + 1) * 4 + 128 * 5 + 64 * _tick_node_bytes(w)
    assert dg.must_move_bytes_per_tick(w) == want


def test_must_move_bytes_per_edge_counts_distinct_delay_rows():
    """With per-edge delays a source row is needed once per distinct delay
    on its out-edges: one edge of delay 3 among delays of 2 adds one row."""
    g = topology.ring_graph(8)
    delays = np.full(g.ell()[0].shape, 2, dtype=np.int32)
    delays[0, 0] = 3
    dg = DeviceGraph.build(g, delays, device="cpu")
    assert dg.uniform_delay is None and dg.buckets is None
    w = 4
    want = 9 * (w + 1) * 4 + 16 * 9 + 8 * _tick_node_bytes(w)
    assert dg.must_move_bytes_per_tick(w) == want
    bucketed = DeviceGraph.build(g, delays, bucketed=True, device="cpu")
    rows = sum(int(b[0].numel()) for b in bucketed.buckets)
    staged = sum(int(b[1].numel()) for b in bucketed.buckets)
    assert bucketed.must_move_bytes_per_tick(w) == (
        9 * (w + 1) * 4 + staged * 9 + rows * 4 + 8 * _tick_node_bytes(w)
    )


def test_engine_occupancy_ring_tracks_the_frontier_ring():
    """Driving the engine's own tick: after every tick each occupancy slot
    is the exact sector occupancy of its frontier slot, and the gather the
    next tick runs gives the same arrivals with and without it, equal to
    the JAX package's bucketed gather on the same ring."""
    g = topology.barabasi_albert(300, m=3, seed=2)
    d = latency.lognormal_delays(g, max_ticks=4, seed=8)
    dg = DeviceGraph.build(g, d, bucketed=True, device="cpu")
    assert dg.buckets is not None and dg.uniform_delay is None
    jbuckets = tuple(
        tuple(a.numpy() for a in b) for b in dg.buckets
    )
    shares, w = 768, 24  # 3 sectors of 8 words; 96 shares per generation tick
    origins = torch.as_tensor(np.arange(shares) % g.n, dtype=torch.int64)
    gen_ticks = torch.as_tensor(np.arange(shares) // 96, dtype=torch.int32)
    slots = torch.arange(shares, dtype=torch.int64)
    seen, hist, occ, received, sent = _chunk_state(dg, w)
    partial = 0
    for t in range(14):
        with_occ = propagate_bucketed(hist, t, dg.buckets, n_out=g.n,
                                      ring_size=dg.ring_size, occ=occ)
        without = propagate_bucketed(hist, t, dg.buckets, n_out=g.n,
                                     ring_size=dg.ring_size)
        want = jell.propagate_bucketed(
            jnp.asarray(convert.bitmask_to_numpy(hist)), jnp.int32(t), jbuckets,
            n_out=g.n, ring_size=dg.ring_size,
        )
        assert torch.equal(with_occ, without)
        np.testing.assert_array_equal(convert.bitmask_to_numpy(with_occ), np.asarray(want))
        _tick(dg, t, seen, hist, occ, received, sent, origins, slots, gen_ticks, False)
        for s in range(dg.ring_size):
            assert torch.equal(occ[s], kernels.sector_occupancy_plain(hist[s]))
        partial += int(((occ[t % dg.ring_size] != 0) & (occ[t % dg.ring_size] != 7)).sum())
    assert partial > 0  # some rows had zero sectors for the gather to skip


def test_cpu_run_launches_no_kernel():
    kernels.reset_launches()
    g = topology.ring_graph(12)
    run_flood_coverage(g, [0, 5], 10, device="cpu")
    assert sum(kernels.launches.values()) == 0


def test_entry_points_raise_without_cuda(monkeypatch):
    """device=None means CUDA; without it the entry points raise instead
    of moving to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = topology.ring_graph(8)
    sched = pt.uniform_renewal_schedule(8, sim_time=1.0, tick_dt=0.1, seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_sync_sim(g, sched, 10)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_flood_coverage(g, [0], 10)
    with pytest.raises(RuntimeError, match="CUDA"):
        DeviceGraph.build(g)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_sync_sim(g, sched, 10, device="cuda")


def test_device_graph_on_other_device_rejected():
    g = topology.ring_graph(8)
    dg = DeviceGraph.build(g, device="cpu")
    sched = pt.uniform_renewal_schedule(8, sim_time=1.0, tick_dt=0.1, seed=0)
    with pytest.raises(ValueError):
        run_sync_sim(g, sched, 10, device_graph=dg, device="meta")
