"""The random-partner protocols staged as their CSR (`PartnerGraph`).

- A block of rounds drawn from the CSR staging equals the same rounds
  drawn the way the full-width ELL staging drew them (``ell_idx[node,
  k]``, ``ell_delay[node, k]``): partners, sender rows, pull rows, push
  plans, on ER, BA and star graphs, for push-pull, pull and fanout push.
- Whole runs on the BA and star graphs with CSR-order log-normal delays
  equal the JAX package's (bitwise counters and coverage rows).
- `models.latency.lognormal_edge_delays` scattered into ELL equals
  `lognormal_delays` and the JAX package's.
- A star of hub degree 50,000 stages and runs with no (N, dmax) array.
- With telemetry on, the spans the benchmark reads.
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import p2p_gossip_tpu as pg
import p2p_gossip_tpu_torch as pt
from p2p_gossip_tpu.models import latency as jlatency
from p2p_gossip_tpu.models import protocols as jproto
from p2p_gossip_tpu.models.topology import Graph as JaxGraph
from p2p_gossip_tpu_torch import telemetry
from p2p_gossip_tpu_torch.batch import campaign as tc
from p2p_gossip_tpu_torch.models import latency, protocols
from p2p_gossip_tpu_torch.models.partnersel import pick_from_key, pick_key
from p2p_gossip_tpu_torch.models.topology import Graph

CPU = torch.device("cpu")
FIELDS = ("generated", "received", "forwarded", "sent", "processed")
MODES = [("pushpull", 1), ("pull", 1), ("pushk", 2)]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _star_edges(leaves: int) -> np.ndarray:
    return np.stack([np.zeros(leaves, dtype=np.int64), np.arange(1, leaves + 1)], axis=1)


def _graph(kind: str):
    """The port's and the JAX package's graph of one kind."""
    if kind == "er":
        return pt.erdos_renyi(120, 0.05, seed=3), pg.erdos_renyi(120, 0.05, seed=3)
    if kind == "ba":
        return pt.barabasi_albert(150, 3, seed=4), pg.barabasi_albert(150, 3, seed=4)
    edges = _star_edges(60)  # a hub and 60 leaves, plus two leaves joined
    edges = np.concatenate([edges, [[5, 6]]])
    return Graph.from_edges(61, edges), JaxGraph.from_edges(61, edges)


def _ell_draw(graph: Graph, key, t0, t1, ring, ell_delays):
    """A block's partners and ring slots as the full-width ELL staging
    drew them."""
    ell_idx, _ = graph.ell()
    ell_idx = torch.as_tensor(ell_idx)
    ticks = torch.arange(t0, t1, dtype=torch.int64)[:, None, None]
    node = torch.arange(graph.n, dtype=torch.int64)[None, :, None]
    degree = torch.as_tensor(graph.degree.astype(np.int32))[None, :, None]
    k = pick_from_key(key, ticks, degree)
    delay = torch.as_tensor(ell_delays)[node, k]
    return ell_idx[node, k], torch.remainder(ticks - delay, ring)


@pytest.mark.parametrize("mode,fanout", MODES)
@pytest.mark.parametrize("kind", ["er", "ba", "star"])
def test_csr_picks_equal_the_ell_picks(kind, mode, fanout):
    g, _ = _graph(kind)
    delays = latency.lognormal_delays(g, 2.0, 0.6, 5, seed=9)
    pgraph = protocols.PartnerGraph.build(g, latency.lognormal_edge_delays(g, 2.0, 0.6, 5,
                                                                           seed=9), device=CPU)
    assert pgraph.ring_size == int(delays.max()) + 1 and pgraph.uniform_delay is None
    nodes = torch.arange(g.n, dtype=torch.int64)
    key = pick_key(nodes[:, None], torch.arange(fanout)[None, :], 2**31 + 17)
    live = torch.as_tensor(g.degree > 0)[None, :, None]
    n, ring = g.n, pgraph.ring_size
    for t0 in (0, 16, 33):
        draw = protocols._draw_rounds(pgraph, key, None, None, None, t0, t0 + 16, mode)
        partners, slot = _ell_draw(g, key, t0, t0 + 16, ring, delays)
        assert torch.equal(torch.where(live, draw["partners"], 0), torch.where(live, partners, 0))
        rows = torch.arange(n)[None, :, None]
        src = (slot * n + rows).expand(partners.shape)
        assert torch.equal(torch.where(live, draw["src"], 0), torch.where(live, src.int(), 0))
        assert torch.equal(draw["attempted"], live.expand(partners.shape))
        if mode != "pushk":
            want = torch.where(live, slot * n + partners, -1).reshape(16, n)
            assert torch.equal(draw["pull_row"], want.int())
        if mode != "pull":
            ell_plan = protocols._push_plan(partners, src.int(), live.expand(partners.shape),
                                            n, ring)
            for got, exp in zip(draw["plan"], ell_plan):
                assert torch.equal(got, exp)


@pytest.mark.parametrize("mode,fanout", MODES)
@pytest.mark.parametrize("kind", ["ba", "star"])
def test_csr_runs_equal_jax(kind, mode, fanout):
    """Whole runs, CSR-order log-normal delays staged once, against the JAX
    package's runs on its (N, dmax) delays: counters and coverage rows."""
    g, jg = _graph(kind)
    rng = np.random.default_rng(5)
    origins = rng.integers(0, g.n, 40).astype(np.int32)
    sched = pt.Schedule(g.n, origins, np.zeros(40, dtype=np.int32))
    jsched = pg.Schedule(g.n, origins, np.zeros(40, dtype=np.int32))
    jd = jlatency.lognormal_delays(jg, 2.0, 0.5, 6, seed=8)
    pgraph = protocols.PartnerGraph.build(g, latency.lognormal_edge_delays(g, 2.0, 0.5, 6, seed=8),
                                          device=CPU)
    kw = dict(seed=2**31 + 5, record_coverage=True, chunk_size=32)
    if mode == "pushk":
        port = protocols.run_pushk_sim(g, sched, 20, fanout=fanout, device_graph=pgraph,
                                       device="cpu", **kw)
        want = jproto.run_pushk_sim(jg, jsched, 20, fanout=fanout, ell_delays=jd, **kw)
    else:
        port = protocols.run_pushpull_sim(g, sched, 20, mode=mode, device_graph=pgraph,
                                          device="cpu", **kw)
        want = jproto.run_pushpull_sim(jg, jsched, 20, mode=mode, ell_delays=jd, **kw)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(port[0], f), getattr(want[0], f), err_msg=f)
    np.testing.assert_array_equal(port[1], np.asarray(want[1]))
    assert port[0].extra["rounds_executed"] == 20 * 2  # 40 shares in passes of 32


@pytest.mark.parametrize("kind", ["er", "ba", "star"])
def test_csr_delays_scatter_to_the_ell_delays(kind):
    g, jg = _graph(kind)
    edge = latency.lognormal_edge_delays(g, 2.5, 0.7, 8, seed=11)
    assert edge.shape == g.indices.shape and edge.dtype == np.int32
    ell = latency.lognormal_delays(g, 2.5, 0.7, 8, seed=11)
    np.testing.assert_array_equal(latency.ell_from_edge_delays(g, edge), ell)
    np.testing.assert_array_equal(ell, jlatency.lognormal_delays(jg, 2.5, 0.7, 8, seed=11))
    rows, pos = g.csr_rows_pos()
    np.testing.assert_array_equal(ell[rows, pos], edge)
    # symmetric per link: entry (u, v) and entry (v, u) carry one delay
    back = {(int(r), int(c)): int(d) for r, c, d in zip(rows, g.indices, edge)}
    assert all(back[(c, r)] == d for (r, c), d in back.items())


def test_ell_delays_stage_as_their_csr_entries():
    """The flood's (N, dmax) form, given to the protocols, stages as the
    CSR form does, its ring size by the JAX rule (largest entry + 1)."""
    g, _ = _graph("ba")
    edge = latency.lognormal_edge_delays(g, 2.0, 0.5, 6, seed=2)
    a = protocols.PartnerGraph.build(g, edge, device=CPU)
    b = protocols.PartnerGraph.build(g, latency.ell_from_edge_delays(g, edge), device=CPU)
    assert torch.equal(a.edge_delay, b.edge_delay) and a.ring_size == b.ring_size
    assert a.delay_range == (int(edge.min()), int(edge.max()))
    np.testing.assert_array_equal(a.canonical_delays(), edge)
    uniform = protocols.PartnerGraph.build(g, np.full(edge.shape, 3, np.int32), device=CPU)
    assert uniform.uniform_delay == 3 and uniform.edge_delay is None and uniform.ring_size == 4
    with pytest.raises(ValueError, match="per CSR entry"):
        protocols.PartnerGraph.build(g, edge[:-1], device=CPU)


class _LargestTensor(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.largest = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if isinstance(t, torch.Tensor):
                self.largest = max(self.largest, t.numel())
        return out


@pytest.mark.parametrize("leaves", [50_000, 3_000])
def test_a_hub_stages_and_runs_without_an_ell(monkeypatch, leaves):
    """Staging allocates nothing wider than the CSR; a run (on the smaller
    star: the plain scatter ORs a hub's pushes one rank at a time) nothing
    near the (N, dmax) ELL."""
    g = Graph.from_edges(leaves + 1, _star_edges(leaves))

    def no_ell(*a, **k):
        raise AssertionError("an (N, dmax) ELL was built on the protocol path")

    monkeypatch.setattr(Graph, "ell", no_ell)
    monkeypatch.setattr(Graph, "ell_rows", no_ell)
    delays = latency.lognormal_edge_delays(g, 2.0, 0.5, 8, seed=1)
    n, e = g.n, 2 * leaves
    watch = _LargestTensor()
    with watch:
        pgraph = protocols.PartnerGraph.build(g, delays, device=CPU)
    assert watch.largest == e + 1  # the indices and delays, with their sentinel
    assert pgraph.nbytes == 8 * (n + 1) + 2 * 4 * (e + 1) + 4 * n
    assert pgraph.nbytes == protocols.partner_graph_bytes(g.degree, per_edge_delay=True)
    assert pgraph.nbytes < 32 * n  # the hub's ELL: N x dmax x 9 B (22.5 GB at 50,000)
    if leaves > 10_000:
        return
    sched = pt.Schedule(g.n, np.array([0, 7, 9, leaves - 3], dtype=np.int32),
                        np.zeros(4, dtype=np.int32))
    with watch:
        stats, cov = protocols.run_pushpull_sim(g, sched, 5, seed=3, device_graph=pgraph,
                                                record_coverage=True, chunk_size=32,
                                                device="cpu")
    # the ring (D, N, 1 word) or a 16-round draw (16, N, 1) at most
    widest = max(protocols.PICK_BLOCK, pgraph.ring_size) * n + 1
    assert watch.largest <= widest < n * leaves // 100
    assert int(stats.received.sum()) > 0 and stats.extra["rounds_executed"] == 5


def test_spans_of_the_round_loop():
    g, _ = _graph("er")
    rng = np.random.default_rng(1)
    sched = pt.Schedule(g.n, rng.integers(0, g.n, 70).astype(np.int32),
                        np.sort(rng.integers(0, 4, 70)).astype(np.int32))
    horizon, passes = 20, 3  # 70 shares in passes of 32
    telemetry.configure(None, rings=False)
    try:
        stats, _ = protocols.run_pushpull_sim(g, sched, horizon, seed=4, chunk_size=32,
                                              device="cpu")
        reps = tc.flood_replicas(g, 70, [1, 2], horizon)
        result = tc.run_protocol_campaign(g, reps, horizon, chunk_size=32, device="cpu")
        events = [e for e in telemetry.events() if e.get("type") == "span"]
    finally:
        telemetry.reset()
    count = {}
    for e in events:
        count[e["name"]] = count.get(e["name"], 0) + 1
    rounds = horizon * passes
    assert stats.extra["rounds_executed"] == rounds
    assert result.extra["rounds_executed"] == rounds
    assert count["round"] == count["exchange"] == count["count"] == 2 * rounds
    assert count["draw"] == 2 * passes * -(-horizon // protocols.PICK_BLOCK)
    assert count["stage.partners"] == 2
    for name in ("inputs", "d2h", "stats"):
        assert count[name] >= 2, name
    staged = [e for e in events if e["name"] == "stage.partners"][0]["attrs"]
    assert staged["edges"] == g.indices.shape[0] and staged["bytes"] > 0
    by_depth = {e["name"]: e["depth"] for e in events}
    assert by_depth["draw"] == by_depth["exchange"] == by_depth["round"] + 1
