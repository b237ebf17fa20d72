"""The sharded engine's host planners and device ops in the port against
the JAX package's: the exchange planners (cut, capacity, traffic model,
hub split, the aux-cached plan), the plain ``compress_deltas`` /
``scatter_deltas`` (the CUDA kernels' comparison versions) and
``overlay_hub``, the async-tick helpers, the per-delay ELLs and shard
degree buckets, the partition and RCM orderings with the npz aux cache
read both ways, the mesh helpers, and the node-id offset the gather's loss
coin and the digest take on a shard."""

import numpy as np
import pytest

import jax.numpy as jnp

import p2p_gossip_tpu as pg
from p2p_gossip_tpu.models import topology as jax_topo
from p2p_gossip_tpu.ops import ell as jax_ell
from p2p_gossip_tpu.parallel import async_ticks as jax_async
from p2p_gossip_tpu.parallel import exchange as jax_exch
from p2p_gossip_tpu.parallel import mesh as jax_mesh_mod
from p2p_gossip_tpu.telemetry import digest as jax_digest

import torch

import p2p_gossip_tpu_torch as pt
from p2p_gossip_tpu_torch.models import topology
from p2p_gossip_tpu_torch.models.latency import lognormal_delays
from p2p_gossip_tpu_torch.ops import ell, kernels
from p2p_gossip_tpu_torch.parallel import async_ticks, exchange, mesh


def _random_delta(seed, n_loc, w, k, zeros=0.6):
    rng = np.random.default_rng(seed)
    changed = rng.integers(0, 2**32, (n_loc, w), dtype=np.uint64).astype(np.uint32)
    changed[rng.random((n_loc, w)) < zeros] = 0
    need = rng.random((n_loc, k)) < 0.5
    need[:, -1] = False  # one destination with no candidate
    return changed, need


def _t(u32):
    return torch.from_numpy(np.ascontiguousarray(u32).view(np.int32))


# --- compress / scatter / overlay ----------------------------------------------

@pytest.mark.parametrize("n_loc,w,k,cap", [(12, 3, 3, 40), (16, 2, 4, 8), (5, 1, 2, 8),
                                           (40, 4, 4, 16), (7, 3, 1, 64)])
@pytest.mark.parametrize("aggregate", [False, True])
def test_compress_deltas_equals_jax(n_loc, w, k, cap, aggregate):
    """idx, val and counts equal the JAX buffers for either packing of
    the JAX function (so the port's one layout is both), overflow and
    all-empty destinations included."""
    changed, need = _random_delta(n_loc * w + k, n_loc, w, k)
    idx, val, counts = kernels.compress_deltas(_t(changed), torch.from_numpy(need), cap)
    j_idx, j_val, j_counts = jax_exch.compress_deltas(
        jnp.asarray(changed), jnp.asarray(need), cap, aggregate=aggregate)
    assert np.array_equal(idx.numpy(), np.asarray(j_idx))
    assert np.array_equal(val.numpy().view(np.uint32), np.asarray(j_val))
    assert np.array_equal(counts.numpy(), np.asarray(j_counts))


def test_compress_overflow_keeps_the_first_words():
    n_loc, w, cap = 16, 2, 8
    changed = np.arange(1, n_loc * w + 1, dtype=np.uint32).reshape(n_loc, w)
    idx, val, counts = kernels.compress_deltas_plain(
        _t(changed), torch.ones((n_loc, 1), dtype=torch.bool), cap)
    assert int(counts[0]) == n_loc * w
    assert idx[0].tolist() == list(range(cap))
    assert val[0].tolist() == changed.reshape(-1)[:cap].tolist()


@pytest.mark.parametrize("n_srcs,n_loc,w,cap", [(2, 4, 2, 8), (4, 6, 3, 20), (3, 5, 1, 8)])
def test_scatter_deltas_equals_jax(n_srcs, n_loc, w, cap):
    """The rebuilt canvas equals the JAX scatter-set, -1 padding and
    entries past the canvas dropped."""
    rng = np.random.default_rng(n_srcs * 100 + cap)
    n_padded = n_srcs * n_loc
    idx = np.full((n_srcs, cap), -1, dtype=np.int32)
    for s in range(n_srcs):  # distinct kept ids a source, as compress gives
        row = rng.permutation(n_loc * w)[:cap].astype(np.int32)
        idx[s, : row.size] = np.where(rng.random(row.size) < 0.7, row, -1)
    idx[-1, 0] = n_loc * w + 1  # past the canvas: dropped
    val = rng.integers(0, 2**32, (n_srcs, cap), dtype=np.uint64).astype(np.uint32)
    got = kernels.scatter_deltas(torch.from_numpy(idx), _t(val), n_loc, w, n_padded)
    want = jax_exch.scatter_deltas(jnp.asarray(idx), jnp.asarray(val), n_loc, w, n_padded)
    assert np.array_equal(got.numpy().view(np.uint32), np.asarray(want))
    out = torch.full((n_padded, w), 7, dtype=torch.int32)  # reused canvas: rezeroed
    kernels.scatter_deltas(torch.from_numpy(idx), _t(val), n_loc, w, n_padded, out=out)
    assert torch.equal(out, got)


def test_compress_then_scatter_rebuilds_the_cut():
    changed, need = _random_delta(4, 12, 3, 3)
    idx, val, _ = kernels.compress_deltas(_t(changed), torch.from_numpy(need), 40)
    for d in range(3):
        canvas = kernels.scatter_deltas(idx[d:d + 1], val[d:d + 1], 12, 3, 12)
        assert np.array_equal(canvas.numpy().view(np.uint32),
                              np.where(need[:, d:d + 1], changed, 0))


def test_overlay_hub_equals_jax():
    rng = np.random.default_rng(5)
    k, n_loc, w, h = 3, 6, 2, 2
    recon = rng.integers(0, 2**32, (k * n_loc, w), dtype=np.uint64).astype(np.uint32)
    hub_global = np.stack([rng.choice(n_loc, h, replace=False) + s * n_loc
                           for s in range(k)]).astype(np.int32)
    block = rng.integers(0, 2**32, (k * h, w), dtype=np.uint64).astype(np.uint32)
    want = jax_exch.overlay_hub(jnp.asarray(recon), jnp.asarray(hub_global), jnp.asarray(block))
    got = exchange.overlay_hub(_t(recon).clone(), torch.from_numpy(hub_global).long(),
                               _t(block))
    assert np.array_equal(got.numpy().view(np.uint32), np.asarray(want))


# --- planners --------------------------------------------------------------------

def _padded_ell(g, k):
    idx, msk = g.ell()
    return mesh.pad_to_multiple(idx, k), mesh.pad_to_multiple(msk, k)


@pytest.mark.parametrize("k", [1, 2, 4])
def test_flood_plans_equal_jax(k):
    """The cut, its CSR twin, the capacity, the modeled words, the
    aggregate choice and the hub split equal the JAX planners'."""
    g = pt.barabasi_albert(103, m=3, seed=1)
    jg = pg.barabasi_albert(103, m=3, seed=1)
    idx, msk = _padded_ell(g, k)
    need, counts = exchange.plan_flood_exchange(idx, msk, k)
    j_idx, j_msk = _padded_ell(jg, k)
    j_need, j_counts = jax_exch.plan_flood_exchange(j_idx, j_msk, k)
    assert np.array_equal(need, j_need) and np.array_equal(counts, j_counts)
    assert np.array_equal(exchange.plan_flood_exchange_csr(g, idx.shape[0], k), need)
    n_loc, w = idx.shape[0] // k, 4
    for splits in (1, 3):
        cap = exchange.delta_capacity(int(counts.max()), n_loc, w, splits)
        assert cap == jax_exch.delta_capacity(int(counts.max()), n_loc, w, splits)
        for mode in ("replicated", "dense", "delta", "hub", "none"):
            kw = dict(n_shards=k, n_loc=n_loc, w=w, delay_splits=splits, capacity=cap,
                      hub_count=8)
            assert (exchange.modeled_exchange_words_per_tick(mode, **kw)
                    == jax_exch.modeled_exchange_words_per_tick(mode, **kw))
        for agg in (False, True):
            assert (exchange.modeled_pack_index_words(k, cap, agg)
                    == jax_exch.modeled_pack_index_words(k, cap, agg))
        assert exchange.choose_aggregate(k, cap) == jax_exch.choose_aggregate(k, cap)
    for hub_rows in (None, 0, 8):
        got = exchange.plan_hub_split(need, counts, k, n_loc, w, 1, hub_rows=hub_rows)
        want = jax_exch.plan_hub_split(j_need, j_counts, k, n_loc, w, 1, hub_rows=hub_rows)
        assert got["report"] == want["report"] and got["capacity"] == want["capacity"]
        for key in ("hub_local", "hub_global", "need_tail"):
            assert np.array_equal(got[key], want[key]), key


def test_cached_flood_plan_reads_either_packages_aux_cache(tmp_path):
    """A cut persisted through the npz aux cache by one package loads in
    the other (same aux key, same fingerprint gate): a reader handed
    another graph (the port) or blank ELLs (JAX) still gets the cut of the
    graph the writer planned. The port plans it from CSR, the same bits
    as the JAX ELL planner."""
    g = pt.erdos_renyi(64, 0.1, seed=3)
    jg = pg.erdos_renyi(64, 0.1, seed=3)
    idx, msk = _padded_ell(g, 4)
    want = exchange.plan_flood_exchange(idx, msk, 4)
    other = pt.erdos_renyi(64, 0.3, seed=9)
    assert not np.array_equal(exchange.cached_flood_plan(other, idx.shape[0], 4)[0], want[0])
    for name, writer, reader in (
        ("a.npz", lambda aux: jax_exch.cached_flood_plan(idx, msk, 4, aux_cache=aux),
         lambda aux: exchange.cached_flood_plan(other, idx.shape[0], 4, aux_cache=aux)),
        ("b.npz", lambda aux: exchange.cached_flood_plan(g, idx.shape[0], 4, aux_cache=aux),
         lambda aux: jax_exch.cached_flood_plan(np.zeros_like(idx), np.zeros_like(msk), 4,
                                                aux_cache=aux)),
    ):
        path = str(tmp_path / name)
        jax_topo.save_graph_cache(path, jg, fp="fp")
        writer((path, "fp", "cut4"))
        assert "cut4" in topology.load_graph_cache_aux(path)
        got = reader((path, "fp", "cut4"))
        assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    csr = exchange.cached_flood_plan(g, idx.shape[0], 4)
    assert np.array_equal(csr[0], want[0]) and np.array_equal(csr[1], want[1])


# --- async ticks -----------------------------------------------------------------

def test_async_helpers_equal_jax():
    for exch_mode in ("dense", "delta", "auto", "hub", "async", "async-dense",
                      "async-delta", "async-hub"):
        assert async_ticks.parse_exchange(exch_mode, 3) == jax_async.parse_exchange(exch_mode, 3)
    with pytest.raises(ValueError):
        async_ticks.parse_exchange("bogus", 1)
    with pytest.raises(ValueError):
        async_ticks.parse_exchange("async", 0)
    for ring, k in [(2, 0), (2, 1), (3, 4), (9, 2)]:
        assert async_ticks.effective_ring(ring, k) == jax_async.effective_ring(ring, k)
    for delays, k in [((1,), 1), ((1, 3), 2), ((1, 2, 5), 4)]:
        assert async_ticks.group_offsets(delays, k) == jax_async.group_offsets(delays, k)
        for tr in ("dense", "delta", "hub"):
            assert (async_ticks.modeled_overlap_report(tr, delays, k, 4, 25, 4, 40, 8)
                    == jax_async.modeled_overlap_report(tr, delays, k, 4, 25, 4, 40, 8))
    g = pt.erdos_renyi(61, 0.1, seed=4)
    jg = pg.erdos_renyi(61, 0.1, seed=4)
    d = lognormal_delays(g, mean_ticks=2.0, sigma=0.5, max_ticks=4, seed=7)
    for k, shards in [(1, 4), (2, 4), (3, 2), (4, 1)]:
        assert np.array_equal(async_ticks.clamp_flood_delays(g, shards, k, d),
                              jax_async.clamp_flood_delays(jg, shards, k, d))
    cov = np.cumsum(np.random.default_rng(0).integers(0, 5, (30, 6)), axis=0)
    assert np.array_equal(async_ticks.ttc_percentiles(cov), jax_async.ttc_percentiles(cov))
    hist = torch.zeros((3, 4), dtype=torch.int32)
    assert not async_ticks.in_flight(hist)
    landed = torch.zeros((2, 4), dtype=torch.int32)
    landed[1, 2] = 9
    assert async_ticks.in_flight(hist, landed)


# --- ELL splits and shard buckets --------------------------------------------------

def test_split_ell_by_delay_equals_jax():
    g = pt.erdos_renyi(40, 0.15, seed=11)
    jg = pg.erdos_renyi(40, 0.15, seed=11)
    d = lognormal_delays(g, mean_ticks=2.0, sigma=0.7, max_ticks=5, seed=11)
    idx, msk = g.ell()
    got = ell.split_ell_by_delay(idx, d, msk)
    want = jax_ell.split_ell_by_delay(*jg.ell()[:1], d, jg.ell()[1])
    assert len(got) == len(want) > 1
    for (dg, ig, mg), (dw, iw, mw) in zip(got, want):
        assert dg == dw and np.array_equal(ig, iw) and np.array_equal(mg, mw)
    empty = ell.split_ell_by_delay(idx, d, np.zeros_like(msk))
    assert len(empty) == 1 and empty[0][0] == 1 and not empty[0][2].any()


@pytest.mark.parametrize("n_shards,min_rows", [(1, 2048), (4, 4), (3, 8)])
def test_shard_buckets_equal_jax(n_shards, min_rows):
    """`shard_bucket_ell` equals the JAX planner; `shard_buckets` with a
    shard (from the ELL or straight from CSR) is that shard's row."""
    g = pt.barabasi_albert(101, m=2, seed=6)
    idx, msk = _padded_ell(g, n_shards)
    got = ell.shard_bucket_ell(idx, msk, n_shards, min_rows=min_rows)
    want = jax_ell.shard_bucket_ell(idx, msk, n_shards, min_rows=min_rows)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for x, y in zip(a, b):
            assert np.array_equal(x, y)
    cnt = np.pad(g.degree.astype(np.int64), (0, idx.shape[0] - g.n))
    for shard in range(n_shards):
        one = ell.shard_buckets(cnt, g.ell_width, g.ell_rows, n_shards, min_rows=min_rows,
                                shard=shard)
        for (r, i, m), (rs, is_, ms) in zip(one, got):
            assert (np.array_equal(r, rs[shard]) and np.array_equal(i, is_[shard])
                    and np.array_equal(m, ms[shard]))


# --- orderings and the aux cache -----------------------------------------------------

def test_partitions_and_orderings_equal_jax():
    for family in ("ring_graph", "watts_strogatz", "barabasi_albert"):
        args = {"ring_graph": (64,), "watts_strogatz": (60,), "barabasi_albert": (80,)}[family]
        g, jg = getattr(pt, family)(*args), getattr(pg, family)(*args)
        for parts, seed in ((4, 0), (3, 5)):
            labels = topology.partition_labels(g, parts, seed=seed)
            assert np.array_equal(labels, jax_topo.partition_labels(jg, parts, seed=seed))
            order = topology.partition_order(labels)
            assert np.array_equal(order, jax_topo.partition_order(labels))
            assert topology.edge_cut(g, labels) == jax_topo.edge_cut(jg, labels)
            rg, inv = topology.relabel_graph(g, order)
            jrg, jinv = jax_topo.relabel_graph(jg, order)
            assert np.array_equal(inv, jinv)
            assert np.array_equal(rg.indptr, jrg.indptr)
            assert np.array_equal(rg.indices, jrg.indices)
        assert np.array_equal(topology.rcm_order(g), jax_topo.rcm_order(jg))


def test_aux_cache_reads_both_ways(tmp_path):
    g = pt.erdos_renyi(40, 0.1, seed=0)
    jg = pg.erdos_renyi(40, 0.1, seed=0)
    labels = topology.partition_labels(g, 4)
    port_path, jax_path = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    topology.save_graph_cache(port_path, g, fp="fp-A", aux={"p4": labels})
    jax_topo.save_graph_cache(jax_path, jg, fp="fp-A", aux={"p4": labels})
    assert np.array_equal(jax_topo.load_graph_cache_aux(port_path)["p4"], labels)
    assert np.array_equal(topology.load_graph_cache_aux(jax_path)["p4"], labels)
    calls, logs = [], []

    def compute():
        calls.append(1)
        return topology.partition_labels(g, 8)

    # A matching fingerprint computes once and persists; JAX then reads it.
    out = topology.load_or_compute_graph_aux(jax_path, "p8", "fp-A", compute, logs.append)
    again = jax_topo.load_or_compute_graph_aux(jax_path, "p8", "fp-A", compute, logs.append)
    assert np.array_equal(out, again) and len(calls) == 1
    assert set(topology.load_graph_cache_aux(jax_path)) == {"p4", "p8"}
    # A fingerprint mismatch computes and never persists; no cache, never writes.
    topology.load_or_compute_graph_aux(port_path, "px", "fp-B", compute, logs.append)
    topology.load_or_compute_graph_aux("", "py", "fp-A", compute, logs.append)
    assert len(calls) == 3 and "px" not in topology.load_graph_cache_aux(port_path)
    assert topology.load_graph_cache_aux(str(tmp_path / "missing.npz")) == {}


# --- mesh helpers ------------------------------------------------------------------------

def test_mesh_helpers():
    x = np.arange(10)
    assert mesh.pad_to_multiple(x, 4).shape == (12,) and mesh.pad_to_multiple(x, 5) is x
    for n, node_bytes, hbm in [(8, None, 10), (8, 100, 30), (6, 100, 1), (4, 10, 100)]:
        assert (mesh.auto_axis_split(n, node_bytes, hbm)
                == jax_mesh_mod.auto_axis_split(n, node_bytes, hbm))
    with pytest.raises(RuntimeError, match="initialize_multihost"):
        mesh.make_mesh(1, 1, device="cpu")


# --- node-id offsets: a shard's coins and digest are the whole graph's -------------------

def test_gather_id_offset_gives_the_whole_graphs_coins():
    """A shard boundary inside a degree bucket under loss 0.5: each
    shard's rows gathered with ``id_offset`` = its first row equal the
    full gather's rows, so every shard draws the single-device coins."""
    g = pt.erdos_renyi(90, 0.1, seed=8)
    idx, msk = g.ell()
    rng = np.random.default_rng(1)
    hist = torch.from_numpy(rng.integers(-2**31, 2**31, (2, 90, 3)).astype(np.int32))
    loss = (2**31, 1234)  # threshold 2^31: p = 0.5
    full = torch.empty((90, 3), dtype=torch.int32)
    kernels.gather_or(hist, 5, torch.from_numpy(idx), torch.from_numpy(msk), uniform_slot=1,
                      loss=loss, out=full)
    n_loc = 30
    for shard in range(3):
        rows = slice(shard * n_loc, (shard + 1) * n_loc)
        part = torch.empty((n_loc, 3), dtype=torch.int32)
        kernels.gather_or(hist, 5, torch.from_numpy(idx[rows].copy()),
                          torch.from_numpy(msk[rows].copy()), uniform_slot=1, loss=loss,
                          out=part, id_offset=shard * n_loc)
        assert torch.equal(part, full[rows])
    no_offset = torch.empty((n_loc, 3), dtype=torch.int32)
    kernels.gather_or(hist, 5, torch.from_numpy(idx[30:60].copy()),
                      torch.from_numpy(msk[30:60].copy()), uniform_slot=1, loss=loss,
                      out=no_offset)
    assert not torch.equal(no_offset, full[30:60])  # the offset is what makes it right


def test_digest_id_offset_xors_to_the_whole_digest():
    rng = np.random.default_rng(2)
    seen = rng.integers(0, 2**32, (40, 3), dtype=np.uint64).astype(np.uint32)
    seen[rng.random((40, 3)) < 0.5] = 0
    received = rng.integers(0, 50, 40).astype(np.int32)
    sent = rng.integers(0, 500, 40).astype(np.int32)
    want = int(jax_digest.tick_digest(jnp.asarray(seen), jnp.asarray(received),
                                      jnp.asarray(sent)))
    h = 0
    for lo in (0, 16, 32):
        hi = min(lo + 16, 40)
        part = kernels.tick_digest(_t(seen[lo:hi]), torch.from_numpy(received[lo:hi]),
                                   torch.from_numpy(sent[lo:hi]), id_offset=lo)
        h ^= int(part[0]) & 0xFFFFFFFF
    assert h == want
