"""The port's staging (DeviceGraph) against the JAX package's.

Bucketed and full-width ELL staging with uniform and per-edge delays: the
port's ``DeviceGraph.build`` must stage the JAX package's arrays, and the
port's engine run on either staging must match the JAX engine and the
event engine bit for bit. The port runs on the CPU (plain torch versions).
"""

import numpy as np
import pytest

import p2p_gossip_tpu as pg
import p2p_gossip_tpu_torch as pt
from p2p_gossip_tpu.engine.event import run_event_sim
from p2p_gossip_tpu.engine.sync import DeviceGraph as JaxDeviceGraph
from p2p_gossip_tpu.engine.sync import run_sync_sim as jax_sync_sim
from p2p_gossip_tpu.models import topology as jtopo
from p2p_gossip_tpu_torch import convert
from p2p_gossip_tpu_torch.engine.sync import DeviceGraph, run_sync_sim
from p2p_gossip_tpu_torch.models import latency, topology


def _to_port_dg(jdg):
    return convert.device_graph_from_numpy(
        jdg.n, jdg.ell_idx, jdg.ell_delay, jdg.ell_mask, jdg.degree,
        jdg.ring_size, jdg.uniform_delay, jdg.buckets, device="cpu",
    )


def _check(port, want, event=None):
    for field in ("generated", "received", "forwarded", "sent", "processed", "degree"):
        np.testing.assert_array_equal(getattr(port, field), getattr(want, field))
    assert port.extra["ticks_executed"] == want.extra["ticks_executed"]
    if event is not None:
        assert port.equal_counts(event)
    port.check_conservation()


@pytest.mark.parametrize("per_edge", [False, True])
@pytest.mark.parametrize("bucketed", [True, False])
def test_parity_staging_on_same_device_graph(bucketed, per_edge):
    """Bucketed and full-width staging, uniform and per-edge delays: the
    port run on the JAX staging (carried over by convert.py) and on its own
    build of it both match the JAX engine and the event engine."""
    g = topology.barabasi_albert(150, m=2, seed=9)
    jg = jtopo.barabasi_albert(150, m=2, seed=9)
    sched = pt.uniform_renewal_schedule(150, sim_time=6.0, tick_dt=0.005, seed=4)
    jsched = pg.uniform_renewal_schedule(150, sim_time=6.0, tick_dt=0.005, seed=4)
    horizon = int(6.0 / 0.005)
    d = (
        latency.lognormal_delays(g, mean_ticks=2.0, sigma=0.6, max_ticks=5, seed=2)
        if per_edge else None
    )
    jdg = JaxDeviceGraph.build(jg, d, bucketed=bucketed)
    want = jax_sync_sim(jg, jsched, horizon, ell_delays=d, device_graph=jdg)
    event = run_event_sim(jg, jsched, horizon, ell_delays=d)
    on_jax_staging = run_sync_sim(
        g, sched, horizon, device_graph=_to_port_dg(jdg), device="cpu"
    )
    _check(on_jax_staging, want, event)
    own = DeviceGraph.build(g, d, bucketed=bucketed, device="cpu")
    _check(run_sync_sim(g, sched, horizon, device_graph=own, device="cpu"), want)


@pytest.mark.parametrize("per_edge", [False, True])
def test_device_graph_build_matches_jax(per_edge):
    g = topology.erdos_renyi(5000, 0.002, seed=1)
    jg = jtopo.erdos_renyi(5000, 0.002, seed=1)
    d = latency.lognormal_delays(g, max_ticks=4, seed=3) if per_edge else None
    jdg = JaxDeviceGraph.build(jg, d)  # bucketed by default at this size
    tdg = DeviceGraph.build(g, d, device="cpu")
    assert tdg.buckets is not None and len(tdg.buckets) == len(jdg.buckets)
    assert (tdg.ring_size, tdg.uniform_delay) == (jdg.ring_size, jdg.uniform_delay)
    for tb, jb in zip(tdg.buckets, jdg.buckets):
        for t_arr, j_arr in zip(tb, jb):
            if j_arr is None:
                assert t_arr is None
            else:
                np.testing.assert_array_equal(t_arr.numpy(), np.asarray(j_arr))
    np.testing.assert_array_equal(tdg.degree.numpy(), np.asarray(jdg.degree))
