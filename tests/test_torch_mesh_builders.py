"""The port's mesh builders (``parallel.mesh``) against the JAX package's:
``slot_mesh_shape`` (the rule of ``make_slot_mesh``) equal to JAX's
``make_slot_mesh(slots, devices=jax.devices("cpu")[:n])`` for 1 to 8
ranks and the server's slot counts, with and without a memory budget;
``make_multihost_mesh`` on 4 gloo ranks as 2 hosts of 2
(``LOCAL_WORLD_SIZE=2``): a 2 x 2 (shares, nodes) mesh whose nodes groups
are each host's ranks, a sharded flood on it bitwise the single-device
port's, a shape whose nodes axis would cross hosts refused, and on one
host the plain ``make_mesh``.

One world of 4 spawned ranks (`parallel.launch.spawn`) runs the
multi-host cases; the shape rule needs no world."""

import os

import numpy as np
import pytest

import jax

from p2p_gossip_tpu.parallel.mesh import make_slot_mesh as jax_slot_mesh

import p2p_gossip_tpu_torch as pt
from p2p_gossip_tpu_torch.engine.sync import run_flood_coverage
from p2p_gossip_tpu_torch.parallel import launch
from p2p_gossip_tpu_torch.parallel.mesh import slot_mesh_shape

# (node_bytes, hbm_bytes): none (every rank to replicas), and two budgets
# that force 3+ and 3 node shards' worth of memory.
BUDGETS = {"none": (None, None), "3-to-1": (3 * 10**9, 10**9), "5-to-2": (5 * 10**9, 2 * 10**9)}
HORIZON = 16


@pytest.mark.parametrize("budget", list(BUDGETS))
@pytest.mark.parametrize("slots", [1, 2, 3, 4, 6, 8])
@pytest.mark.parametrize("n", range(1, 9))
def test_slot_mesh_shape_equals_the_jax_packages(n, slots, budget):
    node_bytes, hbm_bytes = BUDGETS[budget]
    mesh = jax_slot_mesh(slots, devices=jax.devices("cpu")[:n], node_bytes=node_bytes,
                         hbm_bytes=hbm_bytes)
    got = slot_mesh_shape(n, slots, node_bytes, hbm_bytes)
    assert got == tuple(mesh.devices.shape)
    assert slots % got[0] == 0 and got[0] * got[1] == n  # every rank used


def test_slot_mesh_shape_examples_and_refusal():
    assert slot_mesh_shape(6, 8) == (2, 3)
    assert slot_mesh_shape(3, 2) == (1, 3)
    assert slot_mesh_shape(4, 3) == (1, 4)
    with pytest.raises(ValueError, match="slots must be >= 1"):
        slot_mesh_shape(4, 0)


def _flood_inputs():
    graph = pt.erdos_renyi(90, 0.08, seed=6)
    origins = np.random.default_rng(2).integers(0, graph.n, 20).astype(np.int32)
    return graph, origins


def _world(graph, origins):
    """Every rank: the two-host layout, a flood on it, the refusal; then
    one host."""
    import torch.distributed as dist

    from p2p_gossip_tpu_torch.parallel.engine_sharded import run_sharded_flood_coverage
    from p2p_gossip_tpu_torch.parallel.mesh import make_mesh, make_multihost_mesh

    out = {}
    os.environ["LOCAL_WORLD_SIZE"] = "2"
    try:
        mesh = make_multihost_mesh(device="cpu")
        out["shape"] = dict(mesh.shape)
        out["coordinate"] = mesh.coordinate
        out["nodes_group"] = dist.get_process_group_ranks(mesh.nodes_group)
        out["shares_group"] = dist.get_process_group_ranks(mesh.shares_group)
        stats, cov = run_sharded_flood_coverage(graph, origins, HORIZON, mesh, chunk_size=32)
        out["flood"] = (stats.received, stats.sent, cov)
        launch.progress()
        try:
            make_multihost_mesh(n_node_shards=4, n_share_shards=1, device="cpu")
        except ValueError as e:
            out["crossing"] = str(e)
    finally:
        del os.environ["LOCAL_WORLD_SIZE"]
    one = make_multihost_mesh(2, 2, device="cpu")
    plain = make_mesh(2, 2, device="cpu")
    out["one_host"] = [(dict(m.shape), m.ranks, m.coordinate,
                        dist.get_process_group_ranks(m.nodes_group)) for m in (one, plain)]
    return out


@pytest.fixture(scope="module")
def world():
    graph, origins = _flood_inputs()
    return launch.spawn(_world, 4, graph, origins, timeout_s=120.0)


def test_multihost_mesh_lays_nodes_within_hosts(world):
    for rank, out in enumerate(world):
        assert out["shape"] == {"shares": 2, "nodes": 2}
        assert out["coordinate"] == (rank // 2, rank % 2)
        host = rank // 2
        assert out["nodes_group"] == [2 * host, 2 * host + 1]
        assert out["shares_group"] == [rank % 2, rank % 2 + 2]


def test_flood_on_the_multihost_mesh_equals_the_single_device_port(world):
    graph, origins = _flood_inputs()
    stats, cov = run_flood_coverage(graph, origins, HORIZON, device="cpu")
    for out in world:
        received, sent, got_cov = out["flood"]
        assert np.array_equal(received, stats.received)
        assert np.array_equal(sent, stats.sent)
        assert np.array_equal(got_cov, cov)


def test_multihost_mesh_refuses_a_nodes_axis_across_hosts(world):
    assert all("within hosts of 2 ranks" in out["crossing"] for out in world)


def test_one_host_falls_back_to_make_mesh(world):
    for out in world:
        one, plain = out["one_host"]
        assert one == plain
