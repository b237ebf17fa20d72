"""The port's bitmask and ELL ops against the JAX package's, bit for bit.

Inputs are numpy arrays made from a seed; bitmasks cross between the two
packages as uint32 <-> int32 views (p2p_gossip_tpu_torch.convert). On the
CPU every port op runs its kernel's plain torch version; the JAX side runs
its Pallas kernels in interpret mode, as tests/test_pallas.py does.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from p2p_gossip_tpu.engine.sync import DeviceGraph as JaxDeviceGraph
from p2p_gossip_tpu.models.latency import lognormal_delays
from p2p_gossip_tpu.models.topology import barabasi_albert, erdos_renyi
from p2p_gossip_tpu.ops import bitmask as jbitmask
from p2p_gossip_tpu.ops import ell as jell
from p2p_gossip_tpu.ops.pallas_kernels import (
    coverage_per_slot_pallas,
    popcount_rows_pallas,
)
from p2p_gossip_tpu_torch import convert
from p2p_gossip_tpu_torch.ops import bitmask, ell, kernels

CPU = torch.device("cpu")


def _words(rng, shape):
    """Random uint32 words with every bit, bit 31 included, in play."""
    return rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32)


def _ragged_words(seed, n, w):
    """Random words plus all-ones, bit-31-only and zero rows."""
    rng = np.random.default_rng(seed)
    words = _words(rng, (n, w))
    words[0] = 0xFFFFFFFF
    if n > 1:
        words[1] = 0x80000000
    if n > 2:
        words[2] = 0
    return words


@pytest.mark.parametrize("n,w", [(777, 3), (1000, 1), (256, 8), (3, 1), (513, 4)])
def test_popcount_rows_matches_pallas(n, w):
    words = _ragged_words(n, n, w)
    want = np.asarray(popcount_rows_pallas(jnp.asarray(words), interpret=True))
    got = bitmask.popcount_rows(convert.bitmask_to_torch(words))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0] == 32 * w


@pytest.mark.parametrize(
    "n,w,slots", [(100, 2, 40), (1024, 4, 128), (1000, 1, 32), (1237, 3, 77), (5, 1, 1)]
)
def test_coverage_per_slot_matches_pallas(n, w, slots):
    words = _ragged_words(n + w, n, w)
    want = np.asarray(
        coverage_per_slot_pallas(jnp.asarray(words), slots, row_tile=256, interpret=True)
    )
    got = bitmask.coverage_per_slot(convert.bitmask_to_torch(words), slots)
    assert got.shape == (slots,) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_coverage_per_slot_on_column_slice():
    # The coverage path reduces the first cov_w words of a wider frontier.
    words = _ragged_words(5, 300, 4)
    full = convert.bitmask_to_torch(words)
    got = bitmask.coverage_per_slot(full[:, :2], 50)
    want = np.asarray(jbitmask.coverage_per_slot(jnp.asarray(words[:, :2]), 50))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", [0, 1])
def test_slot_scatter_matches_jax(seed):
    rng = np.random.default_rng(seed)
    n, w = 20, 3
    s = w * 32
    # Rows include out-of-range ids (-1, n, n + 7): dropped, never wrapped.
    rows = rng.integers(-1, n + 8, s).astype(np.int32)
    slots = np.arange(s, dtype=np.int32)
    active = rng.random(s) < 0.7
    active[31] = active[63] = True  # bit 31 of words 0 and 1
    rows[31], rows[63] = 4, 4
    want = np.asarray(
        jbitmask.slot_scatter(n, w, jnp.asarray(rows), jnp.asarray(slots), jnp.asarray(active))
    )
    got = bitmask.slot_scatter(
        n, w, torch.as_tensor(rows), torch.as_tensor(slots), torch.as_tensor(active)
    )
    np.testing.assert_array_equal(convert.bitmask_to_numpy(got), want)
    assert want[4, 0] & 0x80000000 and want[4, 1] & 0x80000000


def test_bitmask_round_trip_keeps_bit_31():
    words = _ragged_words(3, 7, 2)
    t = convert.bitmask_to_torch(words)
    assert t.dtype == torch.int32 and int(t[1, 0]) == -(2**31)
    np.testing.assert_array_equal(convert.bitmask_to_numpy(t), words)


def _hist(seed, d, n, w):
    return _words(np.random.default_rng(seed), (d, n, w))


def _ell_case(per_edge: bool):
    g = barabasi_albert(120, m=2, seed=3)
    ell_idx, ell_mask = g.ell()
    d = lognormal_delays(g, mean_ticks=2.0, sigma=0.6, max_ticks=5, seed=1)
    if not per_edge:
        d = np.ones_like(ell_idx)
    return g, ell_idx, ell_mask, d


@pytest.mark.parametrize("tick", [0, 3, 11])
def test_propagate_per_edge_matches_jax(tick):
    g, idx, mask, dly = _ell_case(per_edge=True)
    ring = int(dly.max()) + 1
    hist = _hist(tick, ring, g.n, 3)
    want = np.asarray(
        jell.propagate(jnp.asarray(hist), jnp.int32(tick), jnp.asarray(idx),
                       jnp.asarray(dly), jnp.asarray(mask), ring_size=ring)
    )
    got = ell.propagate(
        convert.bitmask_to_torch(hist), tick, torch.as_tensor(idx),
        torch.as_tensor(dly), torch.as_tensor(mask), ring_size=ring,
    )
    np.testing.assert_array_equal(convert.bitmask_to_numpy(got), want)
    ref = ell.propagate_reference(
        convert.bitmask_to_torch(hist), tick, torch.as_tensor(idx),
        torch.as_tensor(dly), torch.as_tensor(mask), ring_size=ring,
    )
    np.testing.assert_array_equal(convert.bitmask_to_numpy(ref), want)


@pytest.mark.parametrize("uniform_delay,ring", [(1, 2), (3, 5)])
def test_propagate_uniform_matches_jax(uniform_delay, ring):
    g, idx, mask, _ = _ell_case(per_edge=False)
    tick = 4
    hist = _hist(ring, ring, g.n, 2)
    want = np.asarray(
        jell.propagate_uniform(
            jnp.asarray(hist), jnp.int32(tick), jnp.asarray(idx), jnp.asarray(mask),
            ring_size=ring, uniform_delay=uniform_delay,
        )
    )
    got = ell.propagate_uniform(
        convert.bitmask_to_torch(hist), tick, torch.as_tensor(idx),
        torch.as_tensor(mask), ring_size=ring, uniform_delay=uniform_delay,
    )
    np.testing.assert_array_equal(convert.bitmask_to_numpy(got), want)


@pytest.mark.parametrize("per_edge", [False, True])
def test_propagate_bucketed_matches_jax_on_same_staging(per_edge):
    g = erdos_renyi(300, 0.04, seed=2)
    delays = (
        lognormal_delays(g, mean_ticks=2.0, sigma=0.6, max_ticks=4, seed=5)
        if per_edge else None
    )
    jdg = JaxDeviceGraph.build(g, delays, bucketed=True)
    # min_rows small enough for several buckets at this size.
    jbuckets = jell.build_degree_buckets(
        g, None if jdg.uniform_delay is not None else delays, min_rows=32,
        ell=g.ell(),
    )
    assert len(jbuckets) > 1
    tdg = convert.device_graph_from_numpy(
        jdg.n, jdg.ell_idx, jdg.ell_delay, jdg.ell_mask, jdg.degree,
        jdg.ring_size, jdg.uniform_delay, jbuckets, device="cpu",
    )
    tick = 6
    hist = _hist(7, jdg.ring_size, g.n, 2)
    want = np.asarray(
        jell.propagate_bucketed(
            jnp.asarray(hist), jnp.int32(tick), jbuckets, n_out=g.n,
            ring_size=jdg.ring_size, uniform_delay=jdg.uniform_delay,
        )
    )
    got = ell.propagate_bucketed(
        convert.bitmask_to_torch(hist), tick, tdg.buckets, n_out=g.n,
        ring_size=tdg.ring_size, uniform_delay=tdg.uniform_delay,
    )
    np.testing.assert_array_equal(convert.bitmask_to_numpy(got), want)


def test_gather_or_frontier_matches_jax():
    g, idx, mask, _ = _ell_case(per_edge=False)
    frontier = _words(np.random.default_rng(9), (g.n, 4))
    want = np.asarray(
        jell.gather_or_frontier(
            jnp.asarray(frontier), jnp.int32(0), jnp.asarray(idx), jnp.asarray(mask)
        )
    )
    got = ell.gather_or_frontier(
        convert.bitmask_to_torch(frontier), 0, torch.as_tensor(idx), torch.as_tensor(mask)
    )
    np.testing.assert_array_equal(convert.bitmask_to_numpy(got), want)


def test_gather_or_rows_drop_out_of_range():
    hist = convert.bitmask_to_torch(_hist(1, 1, 6, 2))
    idx = torch.tensor([[1, 2], [3, 0], [5, 4]], dtype=torch.int32)
    mask = torch.tensor([[True, True], [True, False], [False, True]])
    rows = torch.tensor([4, -1, 6], dtype=torch.int32)  # only row 4 is in range
    out = torch.zeros((5, 2), dtype=torch.int32)
    kernels.gather_or(hist, 0, idx, mask, uniform_slot=0, rows=rows, out=out)
    h = hist[0]
    want = torch.zeros((5, 2), dtype=torch.int32)
    want[4] = h[1] | h[2]
    assert torch.equal(out, want)


def test_cpu_dispatch_is_plain_and_counts_no_launch():
    kernels.reset_launches()
    words = convert.bitmask_to_torch(_ragged_words(2, 50, 3))
    assert torch.equal(bitmask.popcount_rows(words), kernels.popcount_rows_plain(words))
    assert torch.equal(
        bitmask.coverage_per_slot(words, 70), kernels.coverage_per_slot_plain(words, 70)
    )
    assert kernels.launches == {"gather_or": 0, "popcount_rows": 0, "coverage_per_slot": 0}


def test_no_kernel_for_other_devices():
    # A tensor on neither the CPU nor CUDA raises; nothing falls back.
    words = torch.empty((4, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        kernels.popcount_rows(words)
    with pytest.raises(ValueError):
        kernels.coverage_per_slot(words, 10)


def test_gather_or_rejects_bad_arguments():
    hist = torch.zeros((2, 4, 1), dtype=torch.int32)
    idx = torch.zeros((4, 2), dtype=torch.int32)
    mask = torch.ones((4, 2), dtype=torch.bool)
    out = torch.zeros((4, 1), dtype=torch.int32)
    with pytest.raises(ValueError):  # neither delay nor uniform_slot
        kernels.gather_or(hist, 0, idx, mask, out=out)
    with pytest.raises(ValueError):  # slot outside the ring
        kernels.gather_or(hist, 0, idx, mask, uniform_slot=2, out=out)


def test_bucket_planner_matches_jax():
    deg = np.random.default_rng(4).integers(1, 300, 5000)
    want = jell.bucket_rows_by_count(deg, 8, 256)
    got = ell.bucket_rows_by_count(deg, 8, 256)
    assert len(got) == len(want) > 1
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
