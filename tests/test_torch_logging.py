"""The port's component logging (``p2p_gossip_tpu_torch.utils.logging``)
against the JAX package's: the same specs, levels and refusals, and the
same lines from the engines that log (``Engine.Event`` per event,
``Engine.Sync`` per run and chunk, ``Checkpoint``, ``Batch.Campaign``,
``Batch.Sweep``) for the same runs."""

import io
import json
import os

import numpy as np
import pytest

import p2p_gossip_tpu as pg
import p2p_gossip_tpu_torch as pt
from p2p_gossip_tpu.batch import campaign as jax_campaign
from p2p_gossip_tpu.batch import sweep as jax_sweep
from p2p_gossip_tpu.engine import event as jax_event
from p2p_gossip_tpu.engine import sync as jax_sync
from p2p_gossip_tpu.utils import logging as jax_log
from p2p_gossip_tpu_torch.batch import campaign, sweep
from p2p_gossip_tpu_torch.engine import event, sync
from p2p_gossip_tpu_torch.utils import logging as p2plog

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reset(mod):
    mod._RULES.clear()
    for comp in mod._REGISTRY.values():
        comp.level = mod._DEFAULT_LEVEL
    mod.set_time_resolution(1.0)
    mod.set_stream(None)


@pytest.fixture
def streams():
    """Both packages' log output captured, each in its own buffer, and
    their global rules restored afterwards."""
    bufs = (io.StringIO(), io.StringIO())
    for mod, buf in zip((p2plog, jax_log), bufs):
        _reset(mod)
        mod.set_stream(buf)
    yield bufs
    for mod in (p2plog, jax_log):
        _reset(mod)


def _configure(spec, resolution=1.0):
    for mod in (p2plog, jax_log):
        mod.configure(spec)
        mod.set_time_resolution(resolution)


@pytest.mark.parametrize("spec", ["*=logic", "Engine.Event=debug", "*=info",
                                  "Engine.Event", "Engine.Event=function:*=off"])
def test_event_engine_lines_equal_jax(spec, streams):
    _configure(spec, resolution=0.005)
    g, jg = pt.erdos_renyi(24, 0.15, seed=1), pg.erdos_renyi(24, 0.15, seed=1)
    sched = pt.uniform_renewal_schedule(24, sim_time=3.0, tick_dt=0.005, seed=1)
    jsched = pg.uniform_renewal_schedule(24, sim_time=3.0, tick_dt=0.005, seed=1)
    churn = pt.random_churn(24, 600, outage_prob=0.4, mean_down_ticks=50, seed=2)
    from p2p_gossip_tpu.models.churn import random_churn as jax_random_churn

    jchurn = jax_random_churn(24, 600, outage_prob=0.4, mean_down_ticks=50, seed=2)
    event.run_event_sim(g, sched, 600, churn=churn)
    jax_event.run_event_sim(jg, jsched, 600, churn=jchurn)
    port, want = (buf.getvalue() for buf in streams)
    assert port.splitlines() == want.splitlines()
    if spec in ("*=logic", "Engine.Event=debug", "Engine.Event"):
        assert "dropped duplicate share" in port and "is down, " in port
        assert port.splitlines()[1].startswith("+")  # sim-time prefix in seconds


def test_sync_engine_and_checkpoint_lines_equal_jax(streams, tmp_path):
    _configure("*=debug")
    g, jg = pt.erdos_renyi(40, 0.1, seed=3), pg.erdos_renyi(40, 0.1, seed=3)
    sched = pt.uniform_renewal_schedule(40, sim_time=6.0, tick_dt=0.01, seed=3)
    jsched = pg.uniform_renewal_schedule(40, sim_time=6.0, tick_dt=0.01, seed=3)
    kw = dict(chunk_size=32)
    port_ck, jax_ck = str(tmp_path / "p.npz"), str(tmp_path / "j.npz")
    sync.run_sync_sim(g, sched, 600, checkpoint_path=port_ck, stop_after_chunks=1,
                      device="cpu", **kw)
    sync.run_sync_sim(g, sched, 600, checkpoint_path=port_ck, device="cpu", **kw)
    jax_sync.run_sync_sim(jg, jsched, 600, checkpoint_path=jax_ck, stop_after_chunks=1, **kw)
    jax_sync.run_sync_sim(jg, jsched, 600, checkpoint_path=jax_ck, **kw)
    port, want = (buf.getvalue().replace(port_ck, "CK").replace(jax_ck, "CK")
                  for buf in streams)
    assert port.splitlines() == want.splitlines()
    assert "[Engine.Sync] INFO: starting sync simulation: 40 nodes" in port
    assert "[Engine.Sync] DEBUG: chunk 1: " in port
    assert "[Checkpoint] INFO: resuming from CK at chunk 1" in port
    assert "[Checkpoint] DEBUG: saved checkpoint to CK" in port


def test_campaign_and_sweep_lines_equal_jax(streams):
    _configure("Batch.Campaign=info:Batch.Sweep=info")
    g, jg = pt.erdos_renyi(60, 0.08, seed=2), pg.erdos_renyi(60, 0.08, seed=2)
    reps = campaign.flood_replicas(g, 4, [0, 1, 2], 30)
    jreps = jax_campaign.flood_replicas(jg, 4, [0, 1, 2], 30)
    campaign.run_coverage_campaign(g, reps, 30, batch_size=2, device="cpu")
    jax_campaign.run_coverage_campaign(jg, jreps, 30, batch_size=2)
    campaign.run_protocol_campaign(g, reps, 30, protocol="pull", batch_size=2, device="cpu")
    jax_campaign.run_protocol_campaign(jg, jreps, 30, protocol="pull", batch_size=2)
    with open(os.path.join(REPO, "examples", "sweep_small.json"), encoding="utf-8") as f:
        spec = json.load(f)
    sweep.run_sweep(spec, device="cpu")
    jax_sweep.run_sweep(spec)
    port, want = (buf.getvalue().splitlines() for buf in streams)
    strip = [ln.rsplit(" (", 1)[0] if ln.startswith("[Batch.Sweep] INFO: cell ") else ln
             for ln in port]  # the cell lines end with their wall time
    jstrip = [ln.rsplit(" (", 1)[0] if ln.startswith("[Batch.Sweep] INFO: cell ") else ln
              for ln in want]
    assert strip == jstrip
    assert port[0].startswith("[Batch.Campaign] INFO: coverage campaign: 3 replicas")
    assert any(ln.startswith("[Batch.Sweep] INFO: sweep: ") for ln in port)


@pytest.mark.parametrize("spec", ["Engine.Event=loud", "*=LOG_INFO:X=9", "a=:b=info",
                                  "Engine.Sync=off", "=debug"])
def test_configure_accepts_and_refuses_like_jax(spec, streams):
    outcomes = []
    for mod in (p2plog, jax_log):
        try:
            mod.configure(spec)
            outcomes.append(("ok", dict(mod._RULES)))
        except ValueError as e:
            outcomes.append(("error", str(e)))
    assert outcomes[0] == outcomes[1]
    for level in ("info", "LOG_DEBUG", "7", "all", "off", "nope"):
        results = []
        for mod in (p2plog, jax_log):
            try:
                results.append(mod.parse_level(level))
            except ValueError as e:
                results.append(str(e))
        assert results[0] == results[1]


def test_bad_environment_spec_warns_like_jax(streams, monkeypatch):
    monkeypatch.setenv("P2P_LOG", "Engine.Event=loud")
    p2plog._init_from_env()
    jax_log._init_from_env()
    port, want = (buf.getvalue() for buf in streams)
    assert port == want and port.startswith("[Logging] WARN: ignoring P2P_LOG: ")


def test_levels_and_prefixes(streams):
    comp = p2plog.get_logger("Test.Port")
    comp.info("hidden")  # WARN by default
    comp.warn("shown")
    p2plog.enable("Test.Port", "debug")
    p2plog.set_time_resolution(0.005)
    comp.debug("at tick 3", sim_time=3)
    p2plog.disable("*")
    comp.error("silenced")
    assert streams[0].getvalue().splitlines() == [
        "[Test.Port] WARN: shown", "+0.015s [Test.Port] DEBUG: at tick 3",
    ]
    assert not np.any([comp.enabled(lvl) for lvl in range(1, 8)])
