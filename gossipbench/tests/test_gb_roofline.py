"""`gossipbench.roofline`'s counts against a hand count on a 6-node
graph, through the reference's occupancy."""

import numpy as np
import pytest

from gossipbench import roofline
from gossipbench.reference import flood as ref

# 0-1, 1-2, 2-3, 3-4, 4-5, 0-5: a ring of six; degree 2 everywhere.
RING = np.array([[0, 1], [1, 2], [2, 3], [3, 4], [4, 5], [5, 0]])


def occupancy(origins, ticks, horizon):
    indptr, indices = ref.csr_from_edges(6, RING)
    p = ref.Problem(6, indptr, indices, np.array(origins, dtype=np.int32),
                    np.array(ticks, dtype=np.int32), horizon)
    return ref.flood(p, occupancy=True)[1]


def test_empty_frontier():
    occ = occupancy([0], [9], horizon=8)  # generated past the horizon: never fires
    assert occ == {"sectors": 0, "nodes": 0, "edges": 0}
    assert roofline.tick_bytes(occ) == 0 and roofline.gather_bytes(occ) == 0


def test_sparse_frontier():
    # One share from node 0 on tick 0: frontier {0} at t0, {1, 5} at t1,
    # {2, 4} at t2, {3} at t3: 6 (node, tick) pairs, one sector each.
    occ = occupancy([0], [0], horizon=8)
    assert occ == {"sectors": 6, "nodes": 6, "edges": 12}
    assert roofline.tick_bytes(occ) == 6 * 128 + 12 * 4 + 6 * 20
    assert roofline.gather_bytes(occ) == 6 * 64 + 12 * 4


def test_full_frontier_and_sectors():
    # 512 shares (two sectors): slots 0-255 from node 0, 256-511 from
    # node 3, all on tick 0. Every node holds one sector at one tick a
    # sector-half (nodes at equal distance from 0 and from 3 share ticks).
    origins = [0] * 256 + [3] * 256
    occ = occupancy(origins, [0] * 512, horizon=8)
    # Sector 0 (origin 0): 6 (node, tick) pairs; sector 1 (origin 3): 6.
    assert occ["sectors"] == 12
    # (node, tick) pairs with any bit: from 0 at d and from 3 at 3 - d:
    # t0 {0, 3}, t1 {1, 5, 2, 4}, t2 {2, 4, 1, 5}, t3 {3, 0} -> 12.
    assert occ["nodes"] == 12 and occ["edges"] == 24


@pytest.mark.parametrize("horizon", [1, 2, 3])
def test_horizon_cuts_the_count(horizon):
    occ = occupancy([0], [0], horizon=horizon)
    assert occ["nodes"] == [1, 3, 5][horizon - 1]


def test_window_bytes_scales_by_updates():
    assert roofline.window_bytes(1000, 10, 50) == 5000
    assert roofline.window_bytes(1000, 0, 50) == 0
