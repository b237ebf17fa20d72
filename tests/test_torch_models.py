"""The port's own copies of the host-side numpy layer against the JAX
package's: same seed, same graphs, schedules, delays and report."""

import numpy as np
import pytest

import p2p_gossip_tpu as pg
from p2p_gossip_tpu.models import churn as jchurn
from p2p_gossip_tpu.models import generation as jgen
from p2p_gossip_tpu.models import latency as jlatency
from p2p_gossip_tpu.models import seeds as jseeds
from p2p_gossip_tpu.models import topology as jtopo
from p2p_gossip_tpu.models.linkloss import LinkLossModel as JaxLoss
from p2p_gossip_tpu.models.linkloss import drop_mask_np as jdrop_mask_np
from p2p_gossip_tpu.utils import analysis as janalysis
from p2p_gossip_tpu.utils import checkpoint as jcheckpoint
from p2p_gossip_tpu.utils import stats as jstats
from p2p_gossip_tpu_torch.models import churn, generation, latency, seeds, topology
from p2p_gossip_tpu_torch.models.linkloss import LinkLossModel, drop_mask_np
from p2p_gossip_tpu_torch.utils import analysis, checkpoint, stats


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


# --- the options' host layer: churn, loss, seeds, delays, checkpoints, analysis

@pytest.mark.parametrize("kw", [
    dict(outage_prob=0.4, mean_down_ticks=120.0, max_outages=2, seed=2),
    dict(outage_prob=1.0, mean_down_ticks=0.5, max_outages=3, seed=7919),
    dict(outage_prob=0.0, seed=1),
])
def test_random_churn_and_effective_generated_match_jax(kw):
    want = jchurn.random_churn(80, 600, **kw)
    got = churn.random_churn(80, 600, **kw)
    np.testing.assert_array_equal(got.down_start, want.down_start)
    np.testing.assert_array_equal(got.down_end, want.down_end)
    assert got.down_start.dtype == want.down_start.dtype == np.int32
    sched = jgen.uniform_renewal_schedule(80, 6.0, 0.01, seed=3)
    for horizon in (300, 600):
        for model in ((got, want), (None, None)):
            np.testing.assert_array_equal(
                churn.effective_generated(sched, horizon, model[0]),
                jchurn.effective_generated(sched, horizon, model[1]),
            )
    np.testing.assert_array_equal(got.total_downtime(600), want.total_downtime(600))


def test_up_mask_torch_matches_numpy():
    cm = churn.from_intervals(5, [(0, 5, 10), (0, 20, 25), (2, 0, 1000), (4, 3, 4)])
    jcm = jchurn.from_intervals(5, [(0, 5, 10), (0, 20, 25), (2, 0, 1000), (4, 3, 4)])
    ds, de = churn.to_device(cm, "cpu")
    assert churn.to_device(None, "cpu") is None
    for t in (0, 3, 4, 5, 9, 10, 22, 999, 1000):
        want = jcm.up_mask(t)
        np.testing.assert_array_equal(cm.up_mask(t), want)
        np.testing.assert_array_equal(churn.up_mask(ds, de, t).numpy(), want)
    assert churn.always_up(4).up_mask(0).all()


def test_loss_model_and_seed_streams_match_jax():
    for prob in (0.0, 0.05, 0.6, 1.0):
        assert LinkLossModel(prob, seed=3).static_cfg == JaxLoss(prob, seed=3).static_cfg
    with pytest.raises(ValueError):
        LinkLossModel(1.5)
    assert seeds.loss_stream_seed(0) == jseeds.loss_stream_seed(0)
    assert seeds.churn_stream_seed(5) == jseeds.churn_stream_seed(5)
    src = np.arange(2000, dtype=np.int32)
    np.testing.assert_array_equal(
        drop_mask_np(src, src[::-1], 3, 2**31, 9), jdrop_mask_np(src, src[::-1], 3, 2**31, 9)
    )


@pytest.mark.parametrize("message_bytes,bandwidth,tick_dt", [
    (30, 5.0, 0.005), (8_000, 5.0, 0.005), (0, 5.0, 0.005), (1500, 1.0, 0.001),
])
def test_serialization_delays_match_jax(message_bytes, bandwidth, tick_dt):
    g = topology.erdos_renyi(60, 0.1, seed=4)
    kw = dict(message_bytes=message_bytes, bandwidth_mbps=bandwidth, tick_dt=tick_dt)
    np.testing.assert_array_equal(
        latency.serialization_delays(g, **kw),
        jlatency.serialization_delays(jtopo.erdos_renyi(60, 0.1, seed=4), **kw),
    )
    with pytest.raises(ValueError):
        latency.serialization_delays(g, bandwidth_mbps=0.0)
    with pytest.raises(ValueError):
        latency.serialization_delays(g, message_bytes=-1)


def test_fingerprint_and_checkpoint_files_match_jax(tmp_path):
    g = topology.erdos_renyi(30, 0.2, seed=1)
    parts = ("sync_sim", g.n, g.edges(), np.arange(5, dtype=np.int32), None, 7,
             np.asarray([1], dtype=np.int64), ["connect", 3])
    assert checkpoint.fingerprint(*parts) == jcheckpoint.fingerprint(*parts)
    assert checkpoint.fingerprint(*parts[:-1]) != checkpoint.fingerprint(*parts)
    path = str(tmp_path / "c.npz")
    arrays = {"received": np.arange(4, dtype=np.int64), "sent": np.ones(4, np.int64)}
    checkpoint.save_checkpoint(path, arrays, {"fingerprint": "x", "next_chunk": 2})
    saved, meta = jcheckpoint.load_checkpoint(path)
    assert meta["next_chunk"] == 2 and meta["fingerprint"] == "x"
    np.testing.assert_array_equal(saved["received"], arrays["received"])
    jcheckpoint.save_checkpoint(path, arrays, {"fingerprint": "y", "next_chunk": 1})
    acc = {k: np.zeros(4, np.int64) for k in arrays}
    ck = checkpoint.ChunkCheckpointer(path, "y", acc)
    assert ck.start_chunk == 1
    np.testing.assert_array_equal(acc["sent"], arrays["sent"])
    assert checkpoint.ChunkCheckpointer(path, "z", {}).start_chunk == 0


def test_checkpointed_chunks_skip_stop_and_save(tmp_path):
    path = str(tmp_path / "c.npz")
    acc = {"n": np.zeros(1, np.int64)}
    ck = checkpoint.ChunkCheckpointer(path, "fp", acc, checkpoint_every=2)
    ran = []
    for ci, chunk in checkpoint.checkpointed_chunks(list("abcde"), ck, stop_after_chunks=3):
        ran.append(chunk)
        acc["n"] += 1
    assert ran == ["a", "b", "c"]
    assert checkpoint.load_checkpoint(path)[1]["next_chunk"] == 2  # saved every 2
    resumed = checkpoint.ChunkCheckpointer(path, "fp", {"n": np.zeros(1, np.int64)})
    assert [c for _, c in checkpoint.checkpointed_chunks(list("abcde"), resumed)] == list("cde")
    assert checkpoint.load_checkpoint(path)[1]["next_chunk"] == 5


def test_propagation_report_and_redundancy_match_jax():
    rng = np.random.default_rng(0)
    cov = np.sort(rng.integers(0, 50, (30, 6)), axis=0)
    cov[:, 0] = 3  # one share never reaches any target
    for gen in (None, np.arange(6)):
        want = janalysis.propagation_latency(cov, 50, gen)
        got = analysis.propagation_latency(cov, 50, gen)
        for f in want.fractions:
            np.testing.assert_array_equal(got.latency[f], want.latency[f])
        for tick_ms in (None, 5.0):
            assert (analysis.format_propagation_report(got, tick_ms)
                    == janalysis.format_propagation_report(want, tick_ms))
    empty = analysis.propagation_latency(np.zeros((0, 2), np.int32), 10)
    assert (empty.latency[0.5] == -1).all()
    a, b = _stats_pair(3)
    assert analysis.message_redundancy(a) == janalysis.message_redundancy(b)


# --- partner picks and the protocols' topologies -----------------------------

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from p2p_gossip_tpu.models import partnersel as jpartnersel  # noqa: E402
from p2p_gossip_tpu_torch.models import partnersel  # noqa: E402


@pytest.mark.parametrize("seed", [0, 12345, 2**31 - 1, 2**31, 2**31 + 99, 2**32 - 1])
def test_pick_index_matches_numpy_and_jax(seed):
    """Node ids near 2^31 and 2^32, ticks past 2^31, degree 0 (pick 0) and
    degree 1, for push-pull's one pick and fanout slots."""
    rng = np.random.default_rng(seed % 1000)
    node = np.concatenate([rng.integers(0, 5000, 300),
                           2**31 + np.arange(-3, 3), 2**32 - 1 - np.arange(3)])
    degree = rng.integers(0, 200, node.shape[0])
    degree[:5] = 0
    degree[5:9] = 1
    for tick, pick in ((0, 0), (17, 2), (2**31 + 5, 7)):
        want = partnersel.pick_index_np(node, tick, pick, degree, seed)
        np.testing.assert_array_equal(
            want, jpartnersel.pick_index_np(node, tick, pick, degree, seed))
        got = partnersel.pick_index_torch(torch.as_tensor(node), tick, pick,
                                          torch.as_tensor(degree), seed)
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want)
        assert (got[:5] == 0).all() and (got[5:9] == 0).all()
        small = node < 2**31  # pick_index_jnp takes int32 node ids
        jgot = jpartnersel.pick_index_jnp(jnp.asarray(node[small], jnp.int32),
                                          np.uint32(tick),
                                          pick, jnp.asarray(degree[small], jnp.int32),
                                          seed)
        np.testing.assert_array_equal(np.asarray(jgot), want[small])


def test_pick_index_broadcasts_node_tick_and_pick():
    """The (ticks, nodes, picks) grid seeded_partners evaluates, and the
    tick-free key the round loop keeps."""
    node = np.arange(50)[None, :, None]
    tick = np.arange(6)[:, None, None]
    pick = np.arange(3)[None, None, :]
    degree = (np.arange(50) % 7)[None, :, None]
    want = partnersel.pick_index_np(node, tick, pick, degree, 2**31 + 1)
    got = partnersel.pick_index_torch(torch.as_tensor(node), torch.as_tensor(tick),
                                      torch.as_tensor(pick), torch.as_tensor(degree),
                                      2**31 + 1)
    np.testing.assert_array_equal(got.numpy(), want)
    key = partnersel.pick_key(torch.as_tensor(node[0]), torch.as_tensor(pick[0]), 2**31 + 1)
    for t in range(6):
        np.testing.assert_array_equal(
            partnersel.pick_from_key(key, t, torch.as_tensor(degree[0])).numpy(), want[t])


@pytest.mark.parametrize("n,k,beta,seed", [(50, 4, 0.1, 0), (120, 6, 0.5, 3),
                                           (30, 2, 1.0, 7), (200, 8, 0.0, 1)])
def test_watts_strogatz_matches_jax(n, k, beta, seed):
    _same_graph(topology.watts_strogatz(n, k, beta, seed=seed),
                jtopo.watts_strogatz(n, k, beta, seed=seed))


@pytest.mark.parametrize("rows,cols,torus", [(6, 7, False), (6, 7, True), (1, 5, False),
                                             (2, 2, True), (3, 10, True)])
def test_grid_graph_matches_jax(rows, cols, torus):
    g = topology.grid_graph(rows, cols, torus=torus)
    _same_graph(g, jtopo.grid_graph(rows, cols, torus=torus))
    g.validate()


@pytest.mark.parametrize("n", [2, 12, 65])
def test_complete_graph_matches_jax(n):
    g = topology.complete_graph(n)
    _same_graph(g, jtopo.complete_graph(n))
    assert (g.degree == n - 1).all()
