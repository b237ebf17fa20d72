"""The port's npz graph caches, the parallel-link quirk and the host
staging of degree buckets, against the JAX package's.

- A cache either package writes loads in the other, with the same
  fingerprint, and ``load_or_build_graph_cache`` refuses the same files
  with the same messages.
- ``parallel_link_extra``, ``erdos_renyi(return_parallel_extra=True)`` and
  ``NodeStats.with_parallel_links`` equal the JAX functions.
- ``Graph.ell_rows`` fills a bucket a block of rows at a time (so a
  million-node bucket needs no 10^9-entry int64 temporaries); the staged
  bucket arrays equal the JAX package's, and the global ELL's rows, for
  any block size."""

import numpy as np
import pytest

import p2p_gossip_tpu as pg
import p2p_gossip_tpu_torch as pt
from p2p_gossip_tpu.models import topology as jax_topology
from p2p_gossip_tpu.ops import ell as jax_ell
from p2p_gossip_tpu.utils.stats import NodeStats as JaxStats
from p2p_gossip_tpu_torch.engine.sync import DeviceGraph
from p2p_gossip_tpu_torch.models import topology
from p2p_gossip_tpu_torch.ops import ell
from p2p_gossip_tpu_torch.utils.stats import NodeStats, format_final_statistics
from p2p_gossip_tpu.utils.stats import format_final_statistics as jax_format


def _same_graph(a, b):
    assert a.n == b.n
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_caches_cross_load(writer, tmp_path):
    g = topology.erdos_renyi(300, 0.02, seed=4)
    jg = pg.erdos_renyi(300, 0.02, seed=4)
    fp = topology.scale_graph_fingerprint("er", 300, 0.02, 3, 4)
    assert fp == jax_topology.scale_graph_fingerprint("er", 300, 0.02, 3, 4)
    assert fp == topology.scale_graph_fingerprint("er", 300, 0.02, 7, 4)  # baM pinned
    assert fp != topology.scale_graph_fingerprint("ba", 300, 0.02, 3, 4)
    path = str(tmp_path / "g.npz")
    aux = {"labels": np.arange(300, dtype=np.int32)}
    if writer == "port":
        topology.save_graph_cache(path, g, fp=fp, aux=aux)
        got, got_fp = jax_topology.load_graph_cache(path)
    else:
        jax_topology.save_graph_cache(path, jg, fp=fp, aux=aux)
        got, got_fp = topology.load_graph_cache(path)
    assert got_fp == fp
    _same_graph(got, g)
    with np.load(path) as d:
        assert sorted(d.files) == ["aux_labels", "fp", "indices", "indptr", "n"]
        np.testing.assert_array_equal(d[topology.AUX_PREFIX + "labels"], aux["labels"])
    # Either package's loader serves the other's cache in the build protocol.
    port_loaded = topology.load_or_build_graph_cache(
        path, topology="er", nodes=300, prob=0.02, ba_m=3, seed=4,
        build=lambda: pytest.fail("built despite a matching cache"), log=lambda m: None,
    )
    _same_graph(port_loaded, g)


def _build_protocol(mod, path, lines, **over):
    kw = dict(topology="er", nodes=200, prob=0.03, ba_m=3, seed=1)
    kw.update(over)
    return mod.load_or_build_graph_cache(
        path, build=lambda: mod.erdos_renyi(200, 0.03, seed=1), log=lines.append, **kw
    )


def test_load_or_build_builds_saves_and_refuses_like_jax(tmp_path):
    path = str(tmp_path / "c.npz")
    lines = []
    built = _build_protocol(topology, path, lines)
    assert lines == []
    _same_graph(_build_protocol(jax_topology, path, lines), built)
    assert lines[-1].startswith(f"graph loaded from {path}: ")
    for mod in (topology, jax_topology):  # different flags: the same refusal
        got = []
        with pytest.raises(SystemExit) as exc:
            _build_protocol(mod, path, got, seed=2)
        assert exc.value.code == 2
        assert got == [f"error: {path} was built with different topology flags; "
                       "delete it or match the original arguments"]
    # A cache with no fingerprint loads with the warning.
    topology.save_graph_cache(path, built)
    for mod in (topology, jax_topology):
        got = []
        _build_protocol(mod, path, got)
        assert got[0] == (f"WARNING: {path} predates cache fingerprints — "
                          "assuming it matches the requested topology flags")
    # An unreadable file: the same message from both.
    with open(path, "wb") as f:
        f.write(b"not a zip")
    messages = []
    for mod in (topology, jax_topology):
        got = []
        with pytest.raises(SystemExit):
            _build_protocol(mod, path, got)
        messages.append(got)
    assert messages[0] == messages[1] and "not a readable graph cache" in messages[0][0]
    # No cache path: always build, never save.
    assert _build_protocol(topology, "", []).n == 200


@pytest.mark.parametrize("n,p,seed", [(14, 0.12, 2), (40, 0.03, 0), (120, 0.01, 5),
                                      (5000, 0.0004, 1)])
def test_parallel_link_extra_equals_jax(n, p, seed):
    g, extra = topology.erdos_renyi(n, p, seed=seed, return_parallel_extra=True)
    jg, jextra = jax_topology.erdos_renyi(n, p, seed=seed, return_parallel_extra=True)
    _same_graph(g, jg)
    assert extra.dtype == np.int32
    np.testing.assert_array_equal(extra, jextra)
    if (n, seed) == (14, 2):
        assert set(np.flatnonzero(extra)) == {7, 8}  # the JAX CLI test's pair
    rng = np.random.default_rng(seed)
    edges = rng.integers(0, n, size=(3 * n, 2))
    has_upper = rng.random(n) < 0.5
    np.testing.assert_array_equal(
        topology.parallel_link_extra(n, edges, has_upper),
        jax_topology.parallel_link_extra(n, edges, has_upper),
    )


def test_with_parallel_links_equals_jax():
    rng = np.random.default_rng(3)
    n = 12
    arrays = {k: rng.integers(0, 50, n).astype(np.int64)
              for k in ("generated", "received", "degree")}
    fields = dict(arrays, forwarded=arrays["received"],
                  sent=(arrays["generated"] + arrays["received"]) * arrays["degree"],
                  processed=arrays["generated"] + arrays["received"])
    extra = rng.integers(0, 2, n).astype(np.int32)
    got = NodeStats(**fields).with_parallel_links(extra)
    want = JaxStats(**fields).with_parallel_links(extra)
    for key in ("generated", "received", "forwarded", "sent", "processed", "degree"):
        np.testing.assert_array_equal(getattr(got, key), getattr(want, key))
    np.testing.assert_array_equal(got.extra["peer_extra"], want.extra["peer_extra"])
    got.check_conservation()
    assert format_final_statistics(got) == jax_format(want)
    summed = got + got
    np.testing.assert_array_equal(summed.extra["peer_extra"], extra)
    summed.check_conservation()
    with pytest.raises(ValueError, match="peer_extra"):
        got + NodeStats(**fields)
    with pytest.raises(ValueError, match="one entry per node"):
        NodeStats(**fields).with_parallel_links(extra[:-1])


@pytest.mark.parametrize("kind", ["er", "ba"])
def test_staged_buckets_equal_the_jax_packages(kind):
    """The bucket arrays the port stages from CSR (filled in blocks of rows,
    here blocks of 1, 7 and 4096 entries) equal the JAX package's buckets
    and the rows of the global ELL."""
    if kind == "er":
        g, jg = pt.erdos_renyi(6000, 0.004, seed=2), pg.erdos_renyi(6000, 0.004, seed=2)
    else:
        g, jg = pt.barabasi_albert(7000, 3, seed=1), pg.barabasi_albert(7000, 3, seed=1)
    want = jax_ell.build_degree_buckets(jg, None)
    got = ell.build_degree_buckets(g, None)
    assert len(got) == len(want) > 1
    full_idx, full_mask = g.ell()
    for (rows, idx, mask, delay), (jrows, jidx, jmask, jdelay) in zip(got, want):
        assert delay is None and jdelay is None
        assert idx.dtype == np.int32 and mask.dtype == bool and rows.dtype == np.int32
        np.testing.assert_array_equal(rows, jrows)
        np.testing.assert_array_equal(idx, np.asarray(jidx))
        np.testing.assert_array_equal(mask, np.asarray(jmask))
        width = min(idx.shape[1], full_idx.shape[1])
        np.testing.assert_array_equal(idx[:, :width], full_idx[rows, :width])
        np.testing.assert_array_equal(mask[:, :width], full_mask[rows, :width])
        assert not mask[:, width:].any()
        for block in (1, 7, 4096):
            b_idx, b_mask = g.ell_rows(rows, idx.shape[1], block_entries=block)
            np.testing.assert_array_equal(b_idx, idx)
            np.testing.assert_array_equal(b_mask, mask)
    # The staged device tensors are these arrays.
    dg = DeviceGraph.build(g, device="cpu")
    for (rows, idx, mask, _), (t_rows, t_idx, t_mask, t_delay) in zip(got, dg.buckets):
        assert t_delay is None
        np.testing.assert_array_equal(t_rows.numpy(), rows)
        np.testing.assert_array_equal(t_idx.numpy(), idx)
        np.testing.assert_array_equal(t_mask.numpy(), mask)
