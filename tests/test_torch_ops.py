"""The port's bitmask and ELL ops against the JAX package's, bit for bit.

Inputs are numpy arrays made from a seed; bitmasks cross between the two
packages as uint32 <-> int32 views (p2p_gossip_tpu_torch.convert). On the
CPU every port op runs its kernel's plain torch version; the JAX side runs
its Pallas kernels in interpret mode, as tests/test_pallas.py does.
"""

import ctypes
import re

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
from p2p_gossip_tpu.models.linkloss import drop_mask_np
from p2p_gossip_tpu_torch import convert
from p2p_gossip_tpu_torch.models.linkloss import drop_mask_torch
from p2p_gossip_tpu_torch.ops import bitmask, build, ell, kernels

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
    assert torch.equal(kernels.sector_occupancy(words), kernels.sector_occupancy_plain(words))
    dst = torch.arange(50, dtype=torch.int32) % 7
    offsets, entries = kernels.scatter_or_plan(dst, None, None, 7, 50)
    pull = torch.arange(7, dtype=torch.int32) * 3
    base = words[:7].clone()
    out = torch.empty((7, 3), dtype=torch.int32)
    assert torch.equal(
        kernels.scatter_or(words, offsets, entries, pull_row=pull, base=base, out=out),
        kernels.scatter_or_plain(words, offsets, entries, pull, base, False,
                                 torch.empty_like(out)))
    need = torch.arange(50)[:, None] % torch.tensor([2, 3]) == 0
    idx, val, counts = kernels.compress_deltas(words, need, 16)
    for a, b in zip((idx, val, counts), kernels.compress_deltas_plain(words, need, 16)):
        assert torch.equal(a, b)
    assert torch.equal(kernels.scatter_deltas(idx, val, 25, 3, 50),
                       kernels.scatter_deltas_plain(idx, val, 25, 3, 50,
                                                    torch.empty((50, 3), dtype=torch.int32)))
    stack = words.view(2, 25, 3)
    assert torch.equal(kernels.or_fold(stack), kernels.or_fold_plain(stack))
    events = (torch.arange(4) * 7, torch.arange(4) * 13, torch.tensor([True, False] * 2))
    gen_cnt, degree = torch.arange(50, dtype=torch.int32) % 2, torch.arange(50, dtype=torch.int32)
    states = [(words.clone(), torch.zeros(50, dtype=torch.int32),
               torch.zeros(50, dtype=torch.int32)) for _ in range(2)]
    got = kernels.tick_update(states[0][0], words.flip(0), *events, gen_cnt, *states[0][1:],
                              degree, out=torch.empty_like(words))
    want = kernels.tick_update_plain(states[1][0], words.flip(0), *events, gen_cnt,
                                     *states[1][1:], degree, True, None)
    for a, b in zip(got + states[0], want + states[1]):
        assert torch.equal(a, b)
    assert kernels.launches == {
        "gather_or": 0, "sector_occupancy": 0, "popcount_rows": 0, "coverage_per_slot": 0,
        "scatter_or": 0, "tick_digest": 0,
        "compress_deltas": 0, "scatter_deltas": 0, "or_fold": 0, "tick_update": 0,
    }


def test_no_kernel_for_other_devices():
    # A tensor on neither the CPU nor CUDA raises; nothing falls back.
    words = torch.empty((4, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        kernels.popcount_rows(words)
    with pytest.raises(ValueError):
        kernels.coverage_per_slot(words, 10)
    with pytest.raises(ValueError):
        kernels.sector_occupancy(words)
    with pytest.raises(ValueError):
        kernels.scatter_or(words, torch.zeros(4, dtype=torch.int32, device="meta"),
                           torch.zeros(2, dtype=torch.int32, device="meta"),
                           out=torch.empty((3, 2), dtype=torch.int32, device="meta"))
    counter = torch.zeros(4, dtype=torch.int32, device="meta")
    event = torch.zeros(2, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError):
        kernels.tick_update(words, words, event, event, event.bool(), counter, counter, counter,
                            counter)


def test_gather_or_rejects_bad_arguments():
    hist = torch.zeros((2, 4, 1), dtype=torch.int32)
    idx = torch.zeros((4, 2), dtype=torch.int32)
    mask = torch.ones((4, 2), dtype=torch.bool)
    out = torch.zeros((4, 1), dtype=torch.int32)
    with pytest.raises(ValueError):  # neither delay nor uniform_slot
        kernels.gather_or(hist, 0, idx, mask, out=out)
    with pytest.raises(ValueError):  # slot outside the ring
        kernels.gather_or(hist, 0, idx, mask, uniform_slot=2, out=out)
    with pytest.raises(ValueError):  # occupancy not (D, N_src)
        kernels.gather_or(hist, 0, idx, mask, uniform_slot=0, out=out,
                          occ=torch.zeros((4,), dtype=torch.int32))


def test_bucket_planner_matches_jax():
    deg = np.random.default_rng(4).integers(1, 300, 5000)
    want = jell.bucket_rows_by_count(deg, 8, 256)
    got = ell.bucket_rows_by_count(deg, 8, 256)
    assert len(got) == len(want) > 1
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


# --- sector occupancy and the occupancy-aware gather ---------------------------

def _sparse_words(rng, shape, sw, p_sector=0.3):
    """Random words in whole sectors of ``sw`` words kept with probability
    ``p_sector`` (the rest zero), as a flood's frontier looks."""
    *lead, w = shape
    nsec = -(-w // sw)
    keep = rng.random((*lead, nsec)) < p_sector
    sector_mask = np.repeat(keep, sw, axis=-1)[..., :w]
    return np.where(sector_mask, _words(rng, shape), 0).astype(np.uint32)


def _occupancy_numpy(words, sw):
    n, w = words.shape
    out = np.zeros(n, dtype=np.uint32)
    for s in range(-(-w // sw)):
        hit = (words[:, s * sw:(s + 1) * sw] != 0).any(axis=1)
        out |= hit.astype(np.uint32) << np.uint32(s)
    return out


def _ring_occupancy(hist):
    """The engine's occupancy ring for ``hist`` (D, N, W): one
    sector_occupancy per slot."""
    return torch.stack([kernels.sector_occupancy(slot) for slot in hist])


# W -> words per sector: 8 (a 32-byte sector) up to W = 256, then widened so
# a row never has more than 32 sectors.
@pytest.mark.parametrize("w,sw", [(1, 8), (3, 8), (128, 8), (256, 8), (300, 16), (512, 16)])
def test_sector_occupancy_matches_numpy(w, sw):
    rng = np.random.default_rng(w)
    n = 97
    words = _sparse_words(rng, (n, w), sw)
    words[0] = 0                      # all-zero row
    words[1] = 0
    words[1, -1] = 0x80000000         # bit 31 alone, in the last sector
    words[2] = 0
    words[2, 0] = 1                   # bit 0 alone, in sector 0
    assert kernels.sector_words(w) == sw
    got = kernels.sector_occupancy(convert.bitmask_to_torch(words))
    want = _occupancy_numpy(words, sw)
    assert got.dtype == torch.int32 and got.shape == (n,)
    np.testing.assert_array_equal(convert.bitmask_to_numpy(got), want)
    assert want[0] == 0 and want[2] == 1
    assert want[1] == 1 << ((w - 1) // sw)


def test_sector_occupancy_writes_into_out():
    words = convert.bitmask_to_torch(_sparse_words(np.random.default_rng(2), (40, 64), 8))
    ring = torch.full((3, 40), -7, dtype=torch.int32)
    got = kernels.sector_occupancy(words, out=ring[1])
    assert got.data_ptr() == ring[1].data_ptr()
    assert torch.equal(ring[1], kernels.sector_occupancy_plain(words))
    assert (ring[0] == -7).all() and (ring[2] == -7).all()


@pytest.mark.parametrize("layout,per_edge", [
    ("full", False), ("full", True), ("bucketed", False), ("bucketed", True),
    ("frontier", False),
])
def test_gather_or_with_occupancy_matches_jax(layout, per_edge):
    """The gather reading only occupied sectors (occupancy built as the
    engine builds it) equals the gather reading every sector, and both
    equal the JAX package's gather."""
    g = erdos_renyi(300, 0.04, seed=2)
    delays = (lognormal_delays(g, mean_ticks=2.0, sigma=0.6, max_ticks=4, seed=5)
              if per_edge else np.ones(g.ell()[0].shape, dtype=np.int32))
    idx, mask = g.ell()
    ring = int(delays.max()) + 1
    w = 40  # 5 sectors of 8 words
    hist_np = _sparse_words(np.random.default_rng(11), (ring, g.n, w), 8)
    hist = convert.bitmask_to_torch(hist_np)
    occ = _ring_occupancy(hist)
    tick = 7
    t_idx, t_mask = torch.as_tensor(idx), torch.as_tensor(mask)
    if layout == "frontier":
        want = jell.gather_or_frontier(jnp.asarray(hist_np[0]), jnp.int32(tick),
                                       jnp.asarray(idx), jnp.asarray(mask))
        run = lambda o: ell.gather_or_frontier(  # noqa: E731
            hist[0], tick, t_idx, t_mask, occ=None if o is None else o[0])
    elif layout == "full" and not per_edge:
        want = jell.propagate_uniform(
            jnp.asarray(hist_np), jnp.int32(tick), jnp.asarray(idx), jnp.asarray(mask),
            ring_size=ring, uniform_delay=1)
        run = lambda o: ell.propagate_uniform(  # noqa: E731
            hist, tick, t_idx, t_mask, ring_size=ring, uniform_delay=1, occ=o)
    elif layout == "full":
        want = jell.propagate(jnp.asarray(hist_np), jnp.int32(tick), jnp.asarray(idx),
                              jnp.asarray(delays), jnp.asarray(mask), ring_size=ring)
        run = lambda o: ell.propagate(  # noqa: E731
            hist, tick, t_idx, torch.as_tensor(delays), t_mask, ring_size=ring, occ=o)
    else:
        jb = jell.build_degree_buckets(g, delays if per_edge else None, min_rows=32,
                                       ell=(idx, mask))
        assert len(jb) > 1
        uniform = None if per_edge else 1
        want = jell.propagate_bucketed(jnp.asarray(hist_np), jnp.int32(tick), jb,
                                       n_out=g.n, ring_size=ring, uniform_delay=uniform)
        tb = tuple(tuple(None if a is None else torch.as_tensor(np.array(a)) for a in b)
                   for b in jb)
        run = lambda o: ell.propagate_bucketed(  # noqa: E731
            hist, tick, tb, n_out=g.n, ring_size=ring, uniform_delay=uniform, occ=o)
    with_occ, without = run(occ), run(None)
    assert torch.equal(with_occ, without)
    np.testing.assert_array_equal(convert.bitmask_to_numpy(with_occ), np.asarray(want))


def _small_gather_case(seed, n=64, w=24, cap=6, ring=3):
    rng = np.random.default_rng(seed)
    hist = convert.bitmask_to_torch(_sparse_words(rng, (ring, n, w), 8, p_sector=0.5))
    idx = torch.as_tensor(rng.integers(0, n, (n, cap)).astype(np.int32))
    mask = torch.as_tensor(rng.random((n, cap)) < 0.8)
    delay = torch.as_tensor(rng.integers(1, ring, (n, cap)).astype(np.int32))
    return hist, idx, mask, delay


def _gather(hist, idx, mask, delay, occ):
    out = torch.empty((idx.shape[0], hist.shape[-1]), dtype=torch.int32)
    return kernels.gather_or(hist, 5, idx, mask, delay, occ=occ, out=out)


def test_gather_or_plain_honours_a_cleared_occupancy_bit():
    """Clearing the bit of one nonzero sector that an edge reads changes
    the plain result: the plain gather reads through the occupancy, so
    the engine parity tests guard the occupancy the engine writes."""
    hist, idx, mask, delay = _small_gather_case(3)
    slot = torch.remainder(5 - delay.long(), hist.shape[0])
    edges = [(int(slot[0, k]), int(idx[0, k])) for k in range(idx.shape[1]) if mask[0, k]]
    s, src = edges[0]
    # Make (s, src) the only source of row 0's sector 0, and give it bits.
    for ss, ii in edges[1:]:
        if (ss, ii) != (s, src):
            hist[ss, ii, :8] = 0
    hist[s, src, :8] = torch.arange(1, 9, dtype=torch.int32)
    occ = _ring_occupancy(hist)
    base = _gather(hist, idx, mask, delay, occ)
    assert torch.equal(base[0, :8], hist[s, src, :8])
    wrong = occ.clone()
    wrong[s, src] &= ~1
    changed = _gather(hist, idx, mask, delay, wrong)
    assert not changed[0, :8].any()
    assert torch.equal(changed[0, 8:], base[0, 8:])


def test_gather_or_ignores_over_approximate_occupancy():
    """Bits over zero sectors, and stray bits past the row's last sector,
    cost reads but never change the result."""
    hist, idx, mask, delay = _small_gather_case(4)
    exact = _ring_occupancy(hist)
    stray = exact | torch.tensor(-(2**31) | (1 << 20) | 0b1010, dtype=torch.int32)
    full = torch.full_like(exact, -1)
    want = _gather(hist, idx, mask, delay, None)
    for occ in (exact, stray, full):
        assert torch.equal(_gather(hist, idx, mask, delay, occ), want)
    zero_hist = torch.zeros_like(hist)
    assert not _gather(zero_hist, idx, mask, delay, full).any()
    assert not _gather(zero_hist, idx, mask, delay, _ring_occupancy(zero_hist)).any()


# --- the coverage kernel's bit-sliced counter ---------------------------------

def _kernel_planes() -> int:
    with open(build.SOURCE, encoding="utf-8") as f:
        m = re.search(r"constexpr int kCovPlanes = (\d+);", f.read())
    assert m, "kCovPlanes not found in the CUDA source"
    return int(m.group(1))


def _bitsliced_column_counts(words, planes):
    """numpy emulation of one coverage-kernel thread per column: ``planes``
    uint32 planes (plane i = bit i of 32 per-bit counts); a nonzero word
    ripples in through every plane; before a column's planes could
    overflow (after 2**planes - 1 nonzero words) and at the end they flush
    into 32 integer counts. Returns the (W * 32,) slot counts."""
    n, w = words.shape
    plane = np.zeros((planes, w), dtype=np.uint32)
    cnt = np.zeros((w, 32), dtype=np.int64)
    pending = np.zeros(w, dtype=np.int64)
    bits = np.arange(32, dtype=np.uint32)

    def flush(cols):
        for i in range(planes):
            cnt[cols] += ((plane[i, cols][:, None] >> bits) & 1).astype(np.int64) << i
            plane[i, cols] = 0
        pending[cols] = 0

    for r in range(n):
        cols = np.flatnonzero(words[r])
        flush(cols[pending[cols] == 2**planes - 1])
        carry = words[r, cols].copy()
        for i in range(planes):
            t = plane[i, cols] & carry
            plane[i, cols] ^= carry
            carry = t
        assert not carry.any(), "a counter plane overflowed"
        pending[cols] += 1
    flush(np.arange(w))
    return cnt.reshape(-1)


@pytest.mark.parametrize("planes", [3, None])
@pytest.mark.parametrize("extra", [-1, 0, 1])
def test_bitsliced_counter_matches_coverage_plain(planes, extra):
    """Row runs of 2^k - 1, 2^k and 2^k + 1 (k = 3 and the kernel's own k):
    the add-and-flush arithmetic the CUDA kernel runs equals the plain
    per-bit column sums, all-ones columns (the longest carries) included."""
    k = _kernel_planes() if planes is None else planes
    n = 2**k + extra
    rng = np.random.default_rng(k + extra)
    words = _words(rng, (n, 5))
    words[:, 0] = 0xFFFFFFFF            # every count reaches 2^k - 1 before a flush
    words[:, 1] = 0x80000000            # bit 31 only
    words[rng.random(n) < 0.5, 2] = 0   # zero words skip
    words[:, 3] = 0
    got = _bitsliced_column_counts(words, k)
    want = kernels.coverage_per_slot_plain(convert.bitmask_to_torch(words), 5 * 32)
    np.testing.assert_array_equal(got, want.numpy())
    assert got[0] == n and got[32 + 31] == n and not got[96:128].any()


# --- the loss coin and the destination up mask ----------------------------------

@pytest.mark.parametrize("threshold", [0, 1, 2**31, 3 * 2**30, 2**32])
@pytest.mark.parametrize("seed", [0, 104729, 2**31 + 5, 2**32 - 1])
def test_drop_mask_torch_matches_numpy(threshold, seed):
    """The plain coin is bit for bit the JAX package's numpy spec on random
    int32 inputs (negative ones included: they hash as their uint32 bits),
    seeds past 2^31 and the edge thresholds (0 off, 2^32 drops all)."""
    rng = np.random.default_rng(seed % 1000 + threshold % 7)
    src, dst, tick = (rng.integers(-2**31, 2**31, 4000).astype(np.int32) for _ in range(3))
    want = drop_mask_np(src, dst, tick, threshold, seed)
    got = drop_mask_torch(torch.as_tensor(src), torch.as_tensor(dst),
                          torch.as_tensor(tick), threshold, seed)
    np.testing.assert_array_equal(got.numpy(), want)
    if threshold in (0, 2**32):
        assert want.mean() == threshold / 2**32


def _up_mask(n, seed):
    up = np.random.default_rng(seed).random(n) >= 0.2
    up[:3] = (True, False, True)
    return up


@pytest.mark.parametrize("loss", [(int(0.3 * 2**32), 2**31 + 7), (int(0.6 * 2**32), 11)])
@pytest.mark.parametrize("layout", ["per_edge", "uniform", "frontier", "bucketed", "bucketed_per_edge"])
def test_gather_with_loss_and_up_matches_jax(layout, loss):
    """Every ELL variant with the coin (dst = row index, or the bucket's
    rows) equals the JAX package's gather with ``loss``, and with ``up``
    equals it masked as the JAX tick masks a down node's arrivals."""
    per_edge = layout in ("per_edge", "bucketed_per_edge")
    g = erdos_renyi(300, 0.04, seed=2)
    idx, mask = g.ell()
    dly = lognormal_delays(g, mean_ticks=2.0, sigma=0.6, max_ticks=4, seed=5)
    ring, tick = int(dly.max()) + 1, 9
    hist = _hist(3, ring, g.n, 3)
    up = _up_mask(g.n, 1)
    j = (jnp.asarray(hist), jnp.int32(tick))
    t = (convert.bitmask_to_torch(hist), tick)
    if layout == "per_edge":
        want = jell.propagate(*j, jnp.asarray(idx), jnp.asarray(dly), jnp.asarray(mask),
                              ring_size=ring, loss=loss)

        def port(**kw):
            return ell.propagate(*t, torch.as_tensor(idx), torch.as_tensor(dly),
                                 torch.as_tensor(mask), ring_size=ring, **kw)

        ref = ell.propagate_reference(*t, torch.as_tensor(idx), torch.as_tensor(dly),
                                      torch.as_tensor(mask), ring_size=ring, loss=loss)
        np.testing.assert_array_equal(convert.bitmask_to_numpy(ref), np.asarray(want))
    elif layout == "uniform":
        want = jell.propagate_uniform(*j, jnp.asarray(idx), jnp.asarray(mask),
                                      ring_size=ring, uniform_delay=2, loss=loss)

        def port(**kw):
            return ell.propagate_uniform(*t, torch.as_tensor(idx), torch.as_tensor(mask),
                                         ring_size=ring, uniform_delay=2, **kw)
    elif layout == "frontier":
        want = jell.gather_or_frontier(j[0][1], j[1], jnp.asarray(idx), jnp.asarray(mask),
                                       loss=loss)

        def port(**kw):
            return ell.gather_or_frontier(t[0][1], tick, torch.as_tensor(idx),
                                          torch.as_tensor(mask), **kw)
    else:
        buckets = jell.build_degree_buckets(g, dly if per_edge else None, min_rows=32,
                                            ell=(idx, mask))
        assert len(buckets) > 1
        uniform = None if per_edge else 1
        want = jell.propagate_bucketed(*j, buckets, n_out=g.n, ring_size=ring,
                                       uniform_delay=uniform, loss=loss)
        tb = convert.device_graph_from_numpy(
            g.n, idx, dly, mask, g.degree, ring, uniform, buckets, device="cpu"
        ).buckets

        def port(**kw):
            return ell.propagate_bucketed(*t, tb, n_out=g.n, ring_size=ring,
                                          uniform_delay=uniform, **kw)
    want = np.asarray(want)
    np.testing.assert_array_equal(convert.bitmask_to_numpy(port(loss=loss)), want)
    got = port(loss=loss, up=torch.as_tensor(up))
    np.testing.assert_array_equal(convert.bitmask_to_numpy(got),
                                  np.where(up[:, None], want, 0))
    assert (want[~up] != 0).any()  # the mask had something to clear
    lossless = convert.bitmask_to_numpy(port())
    assert (lossless != want).any() and not (want & ~lossless).any()


def test_gather_or_loss_thresholds():
    """threshold 0 is no loss; 2^32 drops every edge (every row zero);
    a threshold past 2^31 compares unsigned."""
    hist, idx, mask, dly = _small_gather_case(4)

    def run(loss):
        out = torch.full((hist.shape[1], hist.shape[2]), -1, dtype=torch.int32)
        return kernels.gather_or(hist, 5, idx, mask, dly, loss=loss, out=out)

    none = run(None)
    assert torch.equal(run((0, 123)), none)
    assert not run((2**32, 123)).any()
    high = run((int(0.6 * 2**32), 2**32 - 3))
    assert high.any() and not torch.equal(high, none)
    n = hist.shape[1]
    keep = mask & ~drop_mask_torch(idx, torch.arange(n)[:, None], 5, int(0.6 * 2**32), 2**32 - 3)
    assert torch.equal(high, _gather(hist, idx, keep, dly, None))


def test_gather_or_up_writes_zero_rows_into_garbage():
    """A down destination's row is written as zeros even when ``out``
    starts as garbage, with identity rows and through bucket rows."""
    hist, idx, mask, dly = _small_gather_case(5)
    n, w = hist.shape[1], hist.shape[2]
    up = torch.as_tensor(_up_mask(n, 2))
    want = torch.where(up[:, None], _gather(hist, idx, mask, dly, None), 0)
    out = torch.full((n, w), -1, dtype=torch.int32)
    assert torch.equal(kernels.gather_or(hist, 5, idx, mask, dly, up=up, out=out), want)
    perm = torch.as_tensor(np.random.default_rng(3).permutation(n).astype(np.int32))
    out = torch.full((n, w), -1, dtype=torch.int32)
    kernels.gather_or(hist, 5, idx[perm.long()], mask[perm.long()], dly[perm.long()],
                      rows=perm, up=up, out=out)
    assert torch.equal(out, want)


def test_gather_or_rejects_bad_up():
    hist = torch.zeros((2, 4, 1), dtype=torch.int32)
    idx = torch.zeros((4, 2), dtype=torch.int32)
    mask = torch.ones((4, 2), dtype=torch.bool)
    out = torch.zeros((4, 1), dtype=torch.int32)
    for up in (torch.ones(4, dtype=torch.int32), torch.ones(3, dtype=torch.bool)):
        with pytest.raises(ValueError):
            kernels.gather_or(hist, 0, idx, mask, uniform_slot=0, up=up, out=out)


# --- scatter_or (the XLA scatter-OR of ops/segment.py) -----------------------

import jax  # noqa: E402

from p2p_gossip_tpu.ops import segment as jsegment  # noqa: E402
from p2p_gossip_tpu_torch.ops import segment  # noqa: E402


def _scatter_case(seed, m, w, n_rows, hot=False):
    """Payload rows with bit 31 and all-ones rows in play, colliding
    destinations (every entry to row 1 when ``hot``) and a mask."""
    rng = np.random.default_rng(seed)
    payload = _ragged_words(seed, m, w) if m else np.zeros((0, w), np.uint32)
    dst = np.full(m, 1, np.int32) if hot else rng.integers(0, n_rows, m).astype(np.int32)
    mask = rng.random(m) < 0.7
    return payload, dst, mask


_JAX_SCATTERS = [jax.jit(f, static_argnums=0)
                 for f in (jsegment.scatter_or, jsegment.scatter_or_bits)]


_SCATTER_CASES = [  # m, w, n_rows, hot, masked, option
    (37, 1, 10, False, False, ""), (100, 2, 16, False, True, ""), (65, 3, 7, False, True, ""),
    (200, 8, 50, False, True, ""), (33, 3, 5, True, False, ""), (33, 3, 5, True, True, ""),
    (1, 2, 3, False, True, ""),
    (100, 4, 6, True, False, ""),          # one destination, a run longer than 32
    (0, 2, 4, False, False, ""),           # M = 0: every row still written
    (90, 3, 9, False, True, "base"),       # ORed into out in place (base is out)
    (90, 4, 9, False, True, "andnot"),     # the frontier: pushed & ~base
    (90, 3, 9, False, True, "pull"),       # pulled rows, -1 and out of range among them
    (120, 2, 7, False, True, "rounds3"),   # a block of 3 rounds planned in one call
]


def _scatter_id(case):
    return "-".join(str(v) for v in case[:5]) + (f"-{case[5]}" if case[5] else "")


@pytest.mark.parametrize("m,w,n_rows,hot,masked,opt", _SCATTER_CASES,
                         ids=[_scatter_id(c) for c in _SCATTER_CASES])
def test_scatter_or_matches_jax(m, w, n_rows, hot, masked, opt):
    """The port's plan + kernel (its plain version here) against both JAX
    variants (sort + scan, and bit unpack + scatter-add) and a loop of
    ``|=``; with the kernel's options (a base ORed in place, the and-not
    frontier, pulled rows, a block of rounds) against the JAX scatter
    combined with them in numpy."""
    payload, dst, mask = _scatter_case(m + w, m, w, n_rows, hot)
    keep = mask if masked else np.ones(m, bool)
    tmask = torch.as_tensor(mask) if masked else None
    src = convert.bitmask_to_torch(payload)
    rounds = 3 if opt == "rounds3" else 1
    rnd = np.arange(m) % rounds  # each entry's round

    def pushed(r):
        """Round r's scatter by both JAX variants and by a loop."""
        sel = rnd == r
        ref = np.zeros((n_rows, w), np.uint32)
        for i in np.flatnonzero(sel & keep):
            ref[dst[i]] |= payload[i]
        if not sel.any():
            return ref
        jmask = jnp.asarray(mask[sel]) if masked else None
        for impl in _JAX_SCATTERS:
            want = np.asarray(impl(n_rows, jnp.asarray(dst[sel]), jnp.asarray(payload[sel]),
                                   jmask))
            np.testing.assert_array_equal(want, ref)
        return ref

    if opt == "":
        got = segment.scatter_or(n_rows, torch.as_tensor(dst), src, tmask)
        np.testing.assert_array_equal(convert.bitmask_to_numpy(got), pushed(0))
        return
    offsets, entries = kernels.scatter_or_plan(
        torch.as_tensor(dst), None, tmask, n_rows, m,
        key_offset=torch.as_tensor(rnd * n_rows), rounds=rounds,
    )
    assert offsets.shape == (rounds * n_rows + 1,) and offsets.dtype == torch.int32
    base = _ragged_words(m + 1, n_rows, w)
    fresh = torch.full((n_rows, w), -1, dtype=torch.int32)  # every row must be written
    if opt == "rounds3":
        for r in range(rounds):
            got = kernels.scatter_or(src, offsets[r * n_rows:(r + 1) * n_rows + 1], entries,
                                     out=fresh.clone())
            np.testing.assert_array_equal(convert.bitmask_to_numpy(got), pushed(r))
        return
    if opt == "base":
        out = convert.bitmask_to_torch(base.copy())
        got = kernels.scatter_or(src, offsets, entries, base=out, out=out)
        assert got is out
        want = base | pushed(0)
    elif opt == "andnot":
        got = kernels.scatter_or(src, offsets, entries, base=convert.bitmask_to_torch(base),
                                 andnot=True, out=fresh)
        want = pushed(0) & ~base
    else:
        pull = np.random.default_rng(m).integers(-3, m + 3, n_rows).astype(np.int32)
        pull[:3] = (-1, m, -(2**31))
        got = kernels.scatter_or(src, offsets, entries, pull_row=torch.as_tensor(pull),
                                 base=convert.bitmask_to_torch(base), out=fresh)
        ok = (pull >= 0) & (pull < m)
        pulled = np.where(ok[:, None], payload[np.clip(pull, 0, m - 1)], 0)
        want = base | pulled | pushed(0)
    np.testing.assert_array_equal(convert.bitmask_to_numpy(got), want)


def test_scatter_or_drops_out_of_range_destinations():
    """dst >= n_rows is dropped by both packages. A negative destination is
    dropped by the port too; the JAX scatter wraps it (its sentinel row
    absorbs only -1), so the JAX side is fed the non-negative entries."""
    payload, _, _ = _scatter_case(3, 12, 3, 6)
    dst = np.array([0, 6, 7, 5, 100, 2, 2, -1, -2, -6, 1, 5], np.int32)
    got = segment.scatter_or(6, torch.as_tensor(dst), convert.bitmask_to_torch(payload))
    fwd = _JAX_SCATTERS[0]
    nonneg, inside = dst >= 0, (dst >= 0) & (dst < 6)
    want = np.asarray(fwd(6, jnp.asarray(dst[nonneg]), jnp.asarray(payload[nonneg])))
    np.testing.assert_array_equal(
        want, np.asarray(fwd(6, jnp.asarray(dst[inside]), jnp.asarray(payload[inside]))))
    np.testing.assert_array_equal(convert.bitmask_to_numpy(got), want)
    empty = segment.scatter_or(6, torch.zeros(0, dtype=torch.int32),
                               torch.zeros((0, 3), dtype=torch.int32))
    assert empty.shape == (6, 3) and not empty.any()
    # An int64 destination past 2^32 is dropped, not wrapped into range.
    wide = torch.as_tensor(dst.astype(np.int64) + np.where(dst == 0, 2**32, 0))
    got = segment.scatter_or(6, wide, convert.bitmask_to_torch(payload))
    assert not got[0].any()


def test_scatter_or_reads_table_rows_and_ors_into_out():
    """The engine's form: payload rows read from a table through src_row
    (rows outside the table dropped), ORed into an existing ``out``."""
    rng = np.random.default_rng(8)
    table = _ragged_words(8, 40, 4)
    src_row = rng.integers(-2, 42, 90).astype(np.int32)
    dst = rng.integers(0, 9, 90).astype(np.int32)
    mask = rng.random(90) < 0.6
    base = _ragged_words(9, 9, 4)
    out = convert.bitmask_to_torch(base)
    got = segment.scatter_or(9, torch.as_tensor(dst), convert.bitmask_to_torch(table),
                             torch.as_tensor(mask), src_row=torch.as_tensor(src_row),
                             out=out)
    assert got is out
    ok = mask & (src_row >= 0) & (src_row < 40)
    want = np.asarray(_JAX_SCATTERS[0](9, jnp.asarray(dst[ok]),
                                       jnp.asarray(table[src_row[ok]]))) | base
    np.testing.assert_array_equal(convert.bitmask_to_numpy(got), want)


def test_scatter_or_kernel_wrapper_checks():
    src = torch.zeros((4, 3), dtype=torch.int32)
    out = torch.zeros((5, 3), dtype=torch.int32)
    offsets, entries = torch.zeros(6, dtype=torch.int32), torch.zeros(0, dtype=torch.int32)
    bad = (
        dict(offsets=torch.zeros(5, dtype=torch.int32)),      # not N + 1
        dict(offsets=None),                                   # entries without offsets
        dict(out=out[:, :2]),                                 # width differs from src
        dict(pull_row=torch.zeros(4, dtype=torch.int32)),     # not (N,)
        dict(base=torch.zeros((4, 3), dtype=torch.int32)),    # not shaped like out
        dict(andnot=True),                                    # andnot without a base
    )
    for case in bad:
        args = dict(offsets=offsets, entries=entries, out=out) | case
        with pytest.raises(ValueError):
            kernels.scatter_or(src, args.pop("offsets"), args.pop("entries"), **args)
    with pytest.raises(ValueError):  # the plan's dst is 1-D
        kernels.scatter_or_plan(torch.zeros((2, 2), dtype=torch.int32), None, None, 5, 4)
    with pytest.raises(ValueError):
        kernels.scatter_or_plan(torch.zeros(3, dtype=torch.int32), None,
                                torch.ones(3, dtype=torch.int32), 5, 4)
    assert "scatter_or" in kernels.launches
    # src, n_src, w, offsets, entries, pull_row, base, and_not, n_out, out, stream
    sig = build._SIGNATURES["gossip_scatter_or"]
    assert len(sig) == 11 and sig[7] == sig[8] == ctypes.c_int
    with open(build.SOURCE, encoding="utf-8") as f:
        src_text = f.read()
    assert "int gossip_scatter_or(" in src_text


# --- or_fold (the sharded protocols' reduce-scatter OR) ------------------------------

@pytest.mark.parametrize("k", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("n,w", [(1, 1), (7, 3), (5, 256), (13, 1)])
def test_or_fold_plain_equals_numpy(k, n, w):
    """The plain fold of a (k, n, W) stack equals ``np.bitwise_or.reduce``
    over axis 0 on ragged shapes with every bit in play (the top bit
    included), into a fresh tensor and into ``out``."""
    rng = np.random.default_rng(k * 1000 + n * w)
    words = rng.integers(0, 2**32, (k, n, w), dtype=np.uint64).astype(np.uint32)
    words[rng.random((k, n, w)) < 0.3] = 0
    words[0, 0, 0] |= np.uint32(1 << 31)
    stack = torch.as_tensor(words.view(np.int32))
    want = np.bitwise_or.reduce(words, axis=0)
    got = kernels.or_fold(stack)
    np.testing.assert_array_equal(convert.bitmask_to_numpy(got), want)
    out = torch.full((n, w), -1, dtype=torch.int32)
    assert kernels.or_fold(stack, out=out) is out
    np.testing.assert_array_equal(convert.bitmask_to_numpy(out), want)
    np.testing.assert_array_equal(convert.bitmask_to_numpy(kernels.or_fold_plain(stack)), want)
    assert (convert.bitmask_to_numpy(got) >> 31).any() and kernels.launches["or_fold"] == 0


def test_or_fold_wrapper_checks():
    with pytest.raises(ValueError):
        kernels.or_fold(torch.zeros((0, 3, 2), dtype=torch.int32))  # k = 0
    with pytest.raises(ValueError):
        kernels.or_fold(torch.zeros((3, 2), dtype=torch.int32))     # not a stack
    with pytest.raises(ValueError):
        kernels.or_fold(torch.zeros((2, 3, 2), dtype=torch.int32),
                        out=torch.zeros((3, 3), dtype=torch.int32))
    # stack, n_words, k, out, stream
    sig = build._SIGNATURES["gossip_or_fold"]
    assert sig == (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p)
    with open(build.SOURCE, encoding="utf-8") as f:
        src_text = f.read()
    assert "int gossip_or_fold(" in src_text and "or_fold_kernel" in src_text
