"""The port's random-partner protocols against the JAX package's.

``run_pushpull_sim`` (push-pull and pull) and ``run_pushk_sim`` run in the
JAX package on the CPU and in the port with ``device="cpu"`` (its kernels'
plain torch versions) on graphs, schedules, delays and option models each
package builds from the same seeds. Tolerance: bitwise (integer ops) —
per-node counters and coverage rows must be equal.
"""

import numpy as np
import pytest

import p2p_gossip_tpu as pg
import p2p_gossip_tpu_torch as pt
from p2p_gossip_tpu.models import churn as jchurn
from p2p_gossip_tpu.models import latency as jlatency
from p2p_gossip_tpu.models import protocols as jproto
from p2p_gossip_tpu.models.linkloss import LinkLossModel as JaxLoss
from p2p_gossip_tpu_torch.models import churn, latency, protocols
from p2p_gossip_tpu_torch.models.linkloss import LinkLossModel

FIELDS = ("generated", "received", "forwarded", "sent", "processed", "degree")
HORIZON = 24


def _same(port, want):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(port, f), getattr(want, f), err_msg=f)


def _graphs(kind, n, seed):
    if kind == "er":
        return pt.erdos_renyi(n, 0.04, seed=seed), pg.erdos_renyi(n, 0.04, seed=seed)
    return pt.barabasi_albert(n, 3, seed=seed), pg.barabasi_albert(n, 3, seed=seed)


def _case(kind, n=150, seed=1, delay="uniform1"):
    """Graph, schedule (~3 chunks of 64 shares, generations up to tick 20)
    and delays in both packages' forms."""
    g, jg = _graphs(kind, n, seed)
    case = dict(
        g=g, jg=jg,
        sched=pt.uniform_renewal_schedule(n, 6.0, 0.3, 2.0, 5.0, seed=seed),
        jsched=pg.uniform_renewal_schedule(n, 6.0, 0.3, 2.0, 5.0, seed=seed),
        kw={},
    )
    if delay == "uniform2":
        case["kw"] = dict(constant_delay=2)
    elif delay == "lognormal":
        case["d"] = latency.lognormal_delays(g, 2.0, 0.5, 4, seed=seed)
        case["jd"] = jlatency.lognormal_delays(jg, 2.0, 0.5, 4, seed=seed)
        np.testing.assert_array_equal(case["d"], case["jd"])
    return case


def _run(case, proto, *, port_opts=None, jax_opts=None, **kw):
    """(port (stats, coverage), JAX (stats, coverage)) of one protocol."""
    mode, fanout = proto
    common = dict(case["kw"], **kw)
    if mode == "pushk":
        port_fn, jax_fn = protocols.run_pushk_sim, jproto.run_pushk_sim
        common["fanout"] = fanout
    else:
        port_fn, jax_fn = protocols.run_pushpull_sim, jproto.run_pushpull_sim
        common["mode"] = mode
    port = port_fn(case["g"], case["sched"], HORIZON, ell_delays=case.get("d"),
                   device="cpu", **common, **(port_opts or {}))
    want = jax_fn(case["jg"], case["jsched"], HORIZON, ell_delays=case.get("jd"),
                  **common, **(jax_opts or {}))
    return port, want


def _check(port, want):
    _same(port[0], want[0])
    if want[1] is None:
        assert port[1] is None
    else:
        assert port[1].dtype == want[1].dtype or port[1].dtype == np.int32
        np.testing.assert_array_equal(port[1], np.asarray(want[1]))


PROTOS = [("pushpull", 1), ("pull", 1), ("pushk", 2)]


@pytest.mark.parametrize("proto", PROTOS, ids=lambda p: p[0])
@pytest.mark.parametrize("delay", ["uniform1", "uniform2", "lognormal"])
@pytest.mark.parametrize("kind", ["er", "ba"])
def test_seeded_run_and_coverage_match_jax(kind, delay, proto):
    """Seeded picks over three 64-share chunks (counters add), with the
    coverage rows recorded per round."""
    case = _case(kind, delay=delay)
    assert case["sched"].num_shares > 128
    port, want = _run(case, proto, seed=2**31 + 7, chunk_size=64, record_coverage=True)
    _check(port, want)
    assert port[1].shape == (HORIZON, case["sched"].num_shares)
    assert port[0].received.sum() > 0


@pytest.mark.parametrize("proto", PROTOS, ids=lambda p: p[0])
@pytest.mark.parametrize("kind,delay", [("er", "lognormal"), ("ba", "uniform1")])
def test_churn_and_loss_match_jax(kind, delay, proto):
    case = _case(kind, seed=3, delay=delay)
    g = case["g"]
    cm = churn.random_churn(g.n, HORIZON, 0.3, 4.0, 2, seed=5)
    jcm = jchurn.random_churn(g.n, HORIZON, 0.3, 4.0, 2, seed=5)
    port, want = _run(
        case, proto, seed=11, chunk_size=64, record_coverage=True,
        port_opts=dict(churn=cm, loss=LinkLossModel(0.25, seed=2**31 + 1)),
        jax_opts=dict(churn=jcm, loss=JaxLoss(0.25, seed=2**31 + 1)),
    )
    _check(port, want)
    clean, _ = _run(case, proto, seed=11, chunk_size=64)
    assert port[0].received.sum() < clean[0].received.sum()


@pytest.mark.parametrize("fanout", [1, 3])
def test_fanout_widths_match_jax(fanout):
    case = _case("ba", n=200, seed=4, delay="lognormal")
    port, want = _run(case, ("pushk", fanout), seed=9, chunk_size=128,
                      record_coverage=True)
    _check(port, want)


def test_total_loss_still_counts_sends():
    """p = 1 drops every transmission: nothing is received, yet every
    attempted exchange charges its digest — as in the JAX package."""
    case = _case("er", seed=6)
    for proto in PROTOS:
        port, want = _run(
            case, proto, seed=1,
            port_opts=dict(loss=LinkLossModel(1.0, seed=3)),
            jax_opts=dict(loss=JaxLoss(1.0, seed=3)),
        )
        _check(port, want)
        assert port[0].received.sum() == 0 and port[0].sent.sum() > 0


def test_degree_zero_rows_never_exchange():
    """Isolated nodes (the ELL row is all padding) pick nothing and are
    never picked: equal to the JAX package and idle."""
    edges = np.array([[0, 1], [1, 2], [2, 3], [3, 0], [4, 5], [5, 6], [1, 6]])
    g, jg = pt.Graph.from_edges(10, edges), pg.Graph.from_edges(10, edges)
    assert (g.degree == 0).sum() == 3
    origins = np.array([0, 4, 7, 8, 2], dtype=np.int32)
    ticks = np.array([0, 1, 2, 3, 5], dtype=np.int32)
    case = dict(g=g, jg=jg, sched=pt.Schedule(10, origins, ticks),
                jsched=pg.Schedule(10, origins, ticks), kw={})
    for proto in PROTOS:
        port, want = _run(case, proto, seed=5, record_coverage=True)
        _check(port, want)
        stats = port[0]
        idle = g.degree == 0
        assert (stats.received[idle] == 0).all() and (stats.sent[idle] == 0).all()


# --- one round's destination-owned call against the JAX package's round ---

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from p2p_gossip_tpu.engine.sync import DeviceGraph as JaxDeviceGraph  # noqa: E402
from p2p_gossip_tpu.models.linkloss import drop_mask_jnp  # noqa: E402
from p2p_gossip_tpu.ops import segment as jsegment  # noqa: E402
from p2p_gossip_tpu_torch import convert  # noqa: E402
from p2p_gossip_tpu_torch.models.partnersel import pick_key  # noqa: E402
from p2p_gossip_tpu_torch.ops import kernels  # noqa: E402

ROUND = 9  # the round checked; the ring is the one rounds 0..8 left


@pytest.mark.parametrize("mode", ["pushpull", "pull", "pushk"])
def test_round_call_matches_jax_round(mode):
    """On a ring the port's own rounds captured (log-normal per-edge
    delays, D = 5, churn and loss p = 0.3), round 9's single
    `kernels.scatter_or` call — pull rows and the push plan from
    `_draw_rounds`, ``base = seen`` — equals the round the JAX package
    builds from its own functions: partners from `_select_partners`, the
    coins ``drop_mask_jnp`` in the order of its protocols.py:144-145, the
    push by its `segment.scatter_or`; ``seen | remote | pushed`` (pull:
    ``seen | remote``; fanout push k = 2: ``pushed & ~seen``)."""
    case = _case("er", n=120, seed=7, delay="lognormal")
    g, sched, seed = case["g"], case["sched"], 2**31 + 3
    fanout = 2 if mode == "pushk" else 1
    dg = protocols.PartnerGraph.build(g, case["d"], device="cpu")
    jdg = JaxDeviceGraph.build(case["jg"], case["jd"], bucketed=False)
    n, ring = dg.n, dg.ring_size
    cm = churn.random_churn(g.n, HORIZON, 0.3, 4.0, 2, seed=5)
    jcm = jchurn.random_churn(g.n, HORIZON, 0.3, 4.0, 2, seed=5)
    loss = LinkLossModel(0.3, seed=2**31 + 9).static_cfg
    jloss = JaxLoss(0.3, seed=2**31 + 9).static_cfg
    assert loss == jloss
    nodes = torch.arange(n, dtype=torch.int64)
    key = pick_key(nodes[:, None], torch.arange(fanout)[None, :], seed)
    churn_dev = churn.to_device(cm, "cpu")
    origins, gen_ticks = sched.chunk(64)[0].padded(64, ROUND)
    _, _, _, hist = protocols._run_chunk(
        dg, origins, gen_ticks, key, None, churn_dev, loss, mode=mode, chunk_size=64,
        horizon=ROUND, n_cov=None, plain=False,
    )
    w = hist.shape[-1]
    flat = hist.view(ring * n, w)
    if mode == "pushk":  # any seen will do for the and-not: the ring's OR
        seen = hist[0] | hist[1] | hist[2]
    else:
        seen = hist[(ROUND - 1) % ring]
    assert seen.any()

    draw = protocols._draw_rounds(dg, key, None, churn_dev, loss, ROUND, ROUND + 1, mode)
    offsets, entries = draw["plan"] if "plan" in draw else (None, None)
    pull_row = draw["pull_row"][0] if "pull_row" in draw else None
    out = torch.full((n, w), -1, dtype=torch.int32)
    got = kernels.scatter_or(flat, offsets, entries, pull_row=pull_row, base=seen,
                             andnot=mode == "pushk", out=out)

    # The JAX package's round, from its own functions.
    flat_np = convert.bitmask_to_numpy(flat)
    seen_np = convert.bitmask_to_numpy(seen)
    jseed, t = jnp.uint32(seed), jnp.int32(ROUND)
    rows = jnp.arange(n, dtype=jnp.int32)
    up = jchurn.up_mask_jnp(*jchurn.to_device(jcm), t)
    if mode == "pushk":
        partners, delay = jproto._select_fanout_partners(
            jseed, t, jdg.ell_idx, jdg.ell_delay, jdg.degree, fanout)
        attempted = (jdg.degree > 0)[:, None] & up[:, None] & up[partners]
        senders = rows[:, None]
    else:
        partners, delay = jproto._select_partners(
            jseed, t, jdg.ell_idx, jdg.ell_delay, jdg.degree)
        attempted = (jdg.degree > 0) & up & up[partners]
        senders = rows
    slot = jnp.mod(t - delay, ring)
    pull_ok = attempted & ~drop_mask_jnp(partners, senders, t, *jloss)
    push_ok = attempted & ~drop_mask_jnp(senders, partners, t, *jloss)
    remote = np.where(np.asarray(pull_ok)[..., None],
                      flat_np[np.asarray(slot * n + partners)], 0)
    my_old = flat_np[np.asarray(slot * n + senders)]
    pushed = np.asarray(jsegment.scatter_or(
        n, partners.reshape(-1),
        jnp.where(push_ok[..., None], jnp.asarray(my_old), jnp.uint32(0)).reshape(-1, w)))
    if mode == "pushpull":
        want = seen_np | remote | pushed
    elif mode == "pull":
        want = seen_np | remote
    else:
        want = pushed & ~seen_np
    np.testing.assert_array_equal(convert.bitmask_to_numpy(got), want)
    assert (np.asarray(pull_ok) != np.asarray(attempted)).any()  # the coin dropped some
    assert (want != seen_np).any()


def test_protocols_never_call_the_gather(monkeypatch):
    """The round's pull rides in the destination-owned scatter: a push-pull
    (and pull) run never reaches `kernels.gather_or`."""
    def refuse(*args, **kwargs):
        raise AssertionError("gather_or called on the protocols' path")

    monkeypatch.setattr(kernels, "gather_or", refuse)
    case = _case("er", seed=6, delay="lognormal")
    for mode in ("pushpull", "pull"):
        port, want = _run(case, (mode, 1), seed=4, chunk_size=64)
        _same(port[0], want[0])
