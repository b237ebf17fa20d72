"""The port's sharded flood engine's other entry point and options on gloo
ranks of the CPU against the JAX package's sharded engine on the
8-virtual-device CPU mesh: flood coverage (with the delta buffers'
overflow and dense fallback), snapshots, the connect window, checkpoints
either package resumes, and the telemetry rings (metric rows SUMmed over
the node shards, digests XORed).

One world of 4 spawned ranks (`parallel.launch.spawn`) runs every case of
this module; the tests read its results. The workers import only the
port."""

import numpy as np
import pytest

import jax

import p2p_gossip_tpu as pg
from p2p_gossip_tpu import telemetry as jax_tel
from p2p_gossip_tpu.models.latency import lognormal_delays as jax_lognormal
from p2p_gossip_tpu.parallel.engine_sharded import (
    run_sharded_flood_coverage as jax_coverage,
    run_sharded_sim as jax_sharded,
)
from p2p_gossip_tpu.parallel.mesh import make_mesh as jax_mesh

import p2p_gossip_tpu_torch as pt
from p2p_gossip_tpu_torch.engine.sync import run_flood_coverage
from p2p_gossip_tpu_torch.models.latency import lognormal_delays
from p2p_gossip_tpu_torch.parallel import launch

SIM = "p2p_gossip_tpu_torch.parallel.engine_sharded:run_sharded_sim"
COV = "p2p_gossip_tpu_torch.parallel.engine_sharded:run_sharded_flood_coverage"
HORIZON = 120
COV_HORIZON = 40
COV_ORIGINS = [0, 7, 23, 41]
SNAPS = [30, 70, 5000]


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


def _cases(tmp):
    """(name, nodes, shares, target, args, kwargs[, events]) of every case."""
    h = _hazard(pt, lognormal_delays)
    cg = pt.erdos_renyi(48, 0.3, seed=3)  # dense: the delta buffers overflow
    cases = [
        (f"cov-{name}-{n}x{s}", n, s, COV, (cg, COV_ORIGINS, COV_HORIZON),
         dict(chunk_size=64, **kw))
        for n, s in [(2, 2), (4, 1), (1, 2)]
        for name, kw in [("dense", dict(ring_mode="sharded")), ("delta", dict(exchange="delta")),
                         ("async2", dict(exchange="async", async_k=2))]
    ]
    cases += [
        ("snapshots", 2, 2, SIM, (h["g"], h["sched"], HORIZON),
         dict(chunk_size=32, snapshot_ticks=SNAPS)),
        ("connect", 2, 1, SIM, (h["g"], h["sched"], HORIZON),
         dict(chunk_size=32, connect_tick=30, exchange="delta")),
        ("resume", 2, 2, SIM, (h["g"], h["sched"], HORIZON),
         dict(_sim_kwargs(h), checkpoint_path=str(tmp / "jax.npz"))),
        ("write", 2, 2, SIM, (h["g"], h["sched"], HORIZON),
         dict(_sim_kwargs(h), checkpoint_path=str(tmp / "port.npz"), stop_after_chunks=1)),
        ("telemetry", 2, 2, SIM, (h["g"], h["sched"], HORIZON),
         dict(_sim_kwargs(h, exchange="async-delta", async_k=2)), True),
    ]
    return cases


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case's results, rank by rank, from one world of 4 ranks. The
    JAX checkpoint the port resumes is written first."""
    tmp = tmp_path_factory.mktemp("sharded")
    h = _hazard(pg, jax_lognormal)
    jax_sharded(h["g"], h["sched"], HORIZON, _jax_mesh(2, 2), **_sim_kwargs(h),
                checkpoint_path=str(tmp / "jax.npz"), stop_after_chunks=1)
    cases = _cases(tmp)
    results = launch.spawn(launch.call_on_meshes, 4, [c[1:] for c in cases],
                           timeout_s=120.0)
    by_name = {case[0]: [r[i] for r in results if r[i] is not None]
               for i, case in enumerate(cases)}
    return by_name, tmp


def _jax_mesh(nodes, shares):
    return jax_mesh(nodes, shares, devices=jax.devices("cpu"))


def _same_stats(a, b):
    for f in ("generated", "received", "forwarded", "sent", "processed", "degree"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f


def _one(results):
    """Rank 0's result, after checking every rank of the mesh returned
    the same global stats (a tuple result carries them first)."""
    def stats(r):
        return r[0] if isinstance(r, tuple) else r

    for r in results[1:]:
        _same_stats(stats(r), stats(results[0]))
    return results[0]


@pytest.mark.parametrize("shape", [(2, 2), (4, 1), (1, 2)], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("mode", ["dense", "delta", "async2"])
def test_coverage_matches_jax(mode, shape, runs):
    """Coverage rows and counters equal the JAX sharded runner's; the
    delta buffers overflow on this dense graph, so the dense fallback runs
    and the achieved-traffic report equals JAX's."""
    n, s = shape
    stats, cov = _one(runs[0][f"cov-{mode}-{n}x{s}"])
    kw = {"dense": dict(ring_mode="sharded"), "delta": dict(exchange="delta"),
          "async2": dict(exchange="async", async_k=2)}[mode]
    want_stats, want = jax_coverage(pg.erdos_renyi(48, 0.3, seed=3), COV_ORIGINS,
                                    COV_HORIZON, _jax_mesh(n, s), chunk_size=64, **kw)
    assert np.array_equal(cov, want)
    _same_stats(stats, want_stats)
    assert stats.extra["exchange"] == want_stats.extra["exchange"]
    if mode == "delta" and n > 1:
        assert stats.extra["exchange"]["overflow_write_ticks"] > 0
        assert stats.extra["exchange"]["dense_fallback_reads"] > 0
    if mode != "async2":
        solo_stats, solo = run_flood_coverage(pt.erdos_renyi(48, 0.3, seed=3), COV_ORIGINS,
                                              COV_HORIZON, device="cpu")
        assert np.array_equal(cov, solo)
        assert stats.extra["ticks_executed"] > 0


def test_snapshots_match_jax(runs):
    port = _one(runs[0]["snapshots"])
    h = _hazard(pg, jax_lognormal)
    want = jax_sharded(h["g"], h["sched"], HORIZON, _jax_mesh(2, 2), chunk_size=32,
                       snapshot_ticks=SNAPS)
    _same_stats(port, want)
    assert port.extra["snapshots"] == want.extra["snapshots"]
    assert len(port.extra["snapshots"]) == 2  # 5000 is past the horizon


def test_connect_window_matches_jax(runs):
    port = _one(runs[0]["connect"])
    h = _hazard(pg, jax_lognormal)
    want = jax_sharded(h["g"], h["sched"], HORIZON, _jax_mesh(2, 1), chunk_size=32,
                       connect_tick=30, exchange="delta")
    _same_stats(port, want)
    assert port.extra["exchange"] == want.extra["exchange"]


def test_port_resumes_a_jax_checkpoint(runs):
    """The JAX sharded engine ran one pass and wrote its checkpoint; the
    port resumes it and ends with the full run's counters."""
    port = _one(runs[0]["resume"])
    h = _hazard(pg, jax_lognormal)
    want = jax_sharded(h["g"], h["sched"], HORIZON, _jax_mesh(2, 2), **_sim_kwargs(h))
    _same_stats(port, want)


def test_jax_resumes_a_port_checkpoint(runs):
    """The port's first rank wrote its checkpoint after one pass; the JAX
    sharded engine resumes it and ends with the full run's counters."""
    _one(runs[0]["write"])
    h = _hazard(pg, jax_lognormal)
    path = str(runs[1] / "port.npz")
    resumed = jax_sharded(h["g"], h["sched"], HORIZON, _jax_mesh(2, 2), **_sim_kwargs(h),
                          checkpoint_path=path)
    want = jax_sharded(h["g"], h["sched"], HORIZON, _jax_mesh(2, 2), **_sim_kwargs(h))
    _same_stats(resumed, want)


def test_telemetry_events_match_jax(runs):
    """With the rings on (async-delta K = 2 on a 2x2 mesh), the first
    rank's ring and digest events equal the JAX sharded engine's: the
    digest XORs the node shards' parts, the metric rows SUM over them."""
    stats, events = runs[0]["telemetry"][0]
    h = _hazard(pg, jax_lognormal)
    jax_tel.reset()
    jax_tel.configure(None, rings=True)
    try:
        jax_sharded(h["g"], h["sched"], HORIZON, _jax_mesh(2, 2),
                    **_sim_kwargs(h, exchange="async-delta", async_k=2))
        want = jax_tel.events()
    finally:
        jax_tel.reset()

    def pick(evs):
        return [{k: v for k, v in e.items() if k != "wall"} for e in evs
                if e["type"] in ("ring", "digest")]

    got, exp = pick(events), pick(want)
    assert got and got == exp
    assert any(e["type"] == "digest" and any(e["values"]) for e in got)


def test_a_staged_graph_serves_every_call_in_a_world_of_one():
    """A plain process is a world of one gloo rank; one `stage_sharded_graph`
    serves runs in several modes (its cut and device copy kept), each the
    single-device engine's, and a staging of another graph is refused."""
    import torch.distributed as dist

    from p2p_gossip_tpu_torch.engine.sync import run_sync_sim
    from p2p_gossip_tpu_torch.parallel.engine_sharded import (
        run_sharded_sim,
        stage_sharded_graph,
    )
    from p2p_gossip_tpu_torch.parallel.mesh import initialize_multihost, make_mesh

    assert not dist.is_initialized()
    initialize_multihost(device="cpu")
    try:
        h = _hazard(pt, lognormal_delays)
        mesh = make_mesh(device="cpu")
        assert mesh.shape == {"shares": 1, "nodes": 1} and mesh.is_first
        sg = stage_sharded_graph(h["g"], mesh, ell_delays=h["d"])
        solo = run_sync_sim(h["g"], h["sched"], HORIZON, ell_delays=h["d"], chunk_size=32,
                            device="cpu")
        for kw in (dict(ring_mode="replicated"), dict(exchange="delta"),
                   dict(exchange="hub", hub_rows=8), dict(exchange="delta")):
            got = run_sharded_sim(h["g"], h["sched"], HORIZON, mesh, ell_delays=h["d"],
                                  chunk_size=32, sharded_graph=sg, **kw)
            _same_stats(got, solo)
            assert got.extra["ticks_executed"] == solo.extra["ticks_executed"]
            assert got.extra["resident_bytes"] > 0
        with pytest.raises(ValueError, match="another graph"):
            run_sharded_sim(pt.ring_graph(8), h["sched"], HORIZON, mesh, sharded_graph=sg)
    finally:
        dist.destroy_process_group()
