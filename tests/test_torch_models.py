"""The port's own copies of the host-side numpy layer against the JAX
package's: same seed, same graphs, schedules, delays and report."""

import numpy as np
import pytest

import p2p_gossip_tpu as pg
from p2p_gossip_tpu.models import generation as jgen
from p2p_gossip_tpu.models import latency as jlatency
from p2p_gossip_tpu.models import topology as jtopo
from p2p_gossip_tpu.utils import stats as jstats
from p2p_gossip_tpu_torch.models import generation, latency, topology
from p2p_gossip_tpu_torch.utils import stats


def _same_graph(a, b):
    assert a.n == b.n
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)
    for x, y in zip(a.ell(), b.ell()):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(a.edges(), b.edges())


@pytest.mark.parametrize(
    "n,p,seed", [(10, 0.3, 0), (100, 0.05, 3), (300, 0.01, 1), (5000, 0.001, 2)]
)
def test_erdos_renyi_matches_jax(n, p, seed):
    g = topology.erdos_renyi(n, p, seed=seed)
    _same_graph(g, jtopo.erdos_renyi(n, p, seed=seed))
    g.validate()


@pytest.mark.parametrize("n,m,seed", [(150, 2, 9), (2000, 3, 1)])
def test_barabasi_albert_matches_jax(n, m, seed):
    g = topology.barabasi_albert(n, m, seed=seed)
    _same_graph(g, jtopo.barabasi_albert(n, m, seed=seed))
    g.validate()


def test_ring_and_from_edges_match_jax():
    _same_graph(topology.ring_graph(17), jtopo.ring_graph(17))
    edges = np.array([[0, 1], [1, 0], [2, 2], [3, 1], [1, 3], [4, 0]])
    _same_graph(topology.Graph.from_edges(5, edges), jtopo.Graph.from_edges(5, edges))


def test_ell_rows_matches_global_ell():
    g = topology.barabasi_albert(300, 2, seed=4)
    rows = np.array([5, 0, 299, 17])
    pad = g.max_degree + 3
    idx, mask = g.ell_rows(rows, pad)
    full_idx, full_mask = g.ell(pad_to=pad)
    np.testing.assert_array_equal(idx, full_idx[rows])
    np.testing.assert_array_equal(mask, full_mask[rows])
    jidx, jmask = jtopo.barabasi_albert(300, 2, seed=4).ell_rows(rows, pad)
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_array_equal(mask, jmask)


def test_validate_rejects_isolated_node():
    g = topology.Graph(3, np.array([0, 1, 2, 2]), np.array([1, 0]))
    with pytest.raises(ValueError):
        g.validate()


def _same_schedule(a, b):
    assert a.n_nodes == b.n_nodes
    np.testing.assert_array_equal(a.origins, b.origins)
    np.testing.assert_array_equal(a.gen_ticks, b.gen_ticks)


@pytest.mark.parametrize("seed", [0, 5])
def test_schedules_match_jax(seed):
    _same_schedule(
        generation.uniform_renewal_schedule(50, 20.0, 0.005, seed=seed),
        jgen.uniform_renewal_schedule(50, 20.0, 0.005, seed=seed),
    )
    _same_schedule(
        generation.poisson_schedule(80, 5.0, 0.01, rate=0.3, seed=seed),
        jgen.poisson_schedule(80, 5.0, 0.01, rate=0.3, seed=seed),
    )
    _same_schedule(
        generation.single_share_schedule(9, 4, 2), jgen.single_share_schedule(9, 4, 2)
    )


def test_schedule_chunk_padded_and_generated_match_jax():
    s = generation.uniform_renewal_schedule(30, 30.0, 0.01, seed=2)
    js = jgen.uniform_renewal_schedule(30, 30.0, 0.01, seed=2)
    for a, b in zip(s.chunk(64), js.chunk(64), strict=True):
        _same_schedule(a, b)
        for x, y in zip(a.padded(64, 3000), b.padded(64, 3000)):
            np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(s.generated_per_node(1500), js.generated_per_node(1500))


def test_delays_match_jax():
    g = topology.erdos_renyi(120, 0.05, seed=1)
    jg = jtopo.erdos_renyi(120, 0.05, seed=1)
    np.testing.assert_array_equal(
        latency.lognormal_delays(g, 2.0, 0.6, 5, seed=3),
        jlatency.lognormal_delays(jg, 2.0, 0.6, 5, seed=3),
    )
    np.testing.assert_array_equal(
        latency.constant_delays(g, 3), jlatency.constant_delays(jg, 3)
    )
    with pytest.raises(ValueError):
        latency.constant_delays(g, 0)


def _stats_pair(seed):
    rng = np.random.default_rng(seed)
    deg = rng.integers(1, 5, 6)
    gen = rng.integers(0, 4, 6)
    rec = rng.integers(0, 9, 6)
    fields = dict(
        generated=gen, received=rec, forwarded=rec.copy(),
        sent=(gen + rec) * deg, processed=gen + rec, degree=deg,
    )
    return stats.NodeStats(**fields), jstats.NodeStats(**fields)


def test_node_stats_and_report_match_jax():
    a, ja = _stats_pair(0)
    b, jb = _stats_pair(1)
    b.degree = a.degree
    jb.degree = ja.degree
    b.sent = (b.generated + b.forwarded) * b.degree
    jb.sent = b.sent
    a.extra["ticks_executed"] = ja.extra["ticks_executed"] = 3
    b.extra["ticks_executed"] = jb.extra["ticks_executed"] = 4
    total, jtotal = a + b, ja + jb
    assert total.totals() == jtotal.totals()
    assert total.extra == jtotal.extra == {"ticks_executed": 7}
    assert total.equal_counts(jtotal)
    total.check_conservation()
    for per_node in (True, False):
        assert stats.format_final_statistics(total, per_node) == (
            jstats.format_final_statistics(jtotal, per_node)
        )


def test_check_conservation_raises():
    a, _ = _stats_pair(2)
    a.sent = a.sent + 1
    with pytest.raises(AssertionError):
        a.check_conservation()


def test_root_exports_match_jax_builders():
    import p2p_gossip_tpu_torch as pt

    _same_graph(pt.erdos_renyi(40, 0.1, seed=8), pg.erdos_renyi(40, 0.1, seed=8))
    assert pt.NodeStats is stats.NodeStats
