"""The port's random-partner protocols against the numpy oracles, pinned
partners, the pull credit bound and checkpoints that cross packages.

The oracles (``seeded_partners``, ``pushpull_oracle``, ``pushk_oracle``)
are the port's numpy copies; they are held to the JAX package's. Runs of
the port take ``device="cpu"``. Tolerance: bitwise (integer ops).
"""

import numpy as np
import pytest

import p2p_gossip_tpu as pg
import p2p_gossip_tpu_torch as pt
from p2p_gossip_tpu.models import churn as jchurn
from p2p_gossip_tpu.models import protocols as jproto
from p2p_gossip_tpu.models.linkloss import LinkLossModel as JaxLoss
from p2p_gossip_tpu_torch.engine.sync import DeviceGraph
from p2p_gossip_tpu_torch.models import churn, protocols
from p2p_gossip_tpu_torch.models.linkloss import LinkLossModel

FIELDS = ("generated", "received", "forwarded", "sent", "processed", "degree")


def _same(port, want):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(port, f), getattr(want, f), err_msg=f)


def _pair(n=80, p=0.08, seed=0, shares=40):
    g, jg = pt.erdos_renyi(n, p, seed=seed), pg.erdos_renyi(n, p, seed=seed)
    rng = np.random.default_rng(seed)
    origins = rng.integers(0, n, shares).astype(np.int32)
    ticks = rng.integers(0, 10, shares).astype(np.int32)
    return g, jg, pt.Schedule(n, origins, ticks), pg.Schedule(n, origins, ticks)


@pytest.mark.parametrize("fanout", [None, 1, 3])
def test_seeded_partners_match_jax(fanout):
    g, jg, _, _ = _pair(seed=2)
    got = protocols.seeded_partners(g, 16, 2**31 + 3, fanout=fanout)
    want = jproto.seeded_partners(jg, 16, 2**31 + 3, fanout=fanout)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32


@pytest.mark.parametrize("mode", ["pushpull", "pull"])
def test_seeded_run_equals_oracle_and_jax_oracle(mode):
    """A seeded run with one-round delays equals the oracle fed the seeded
    partners, and the port's oracle equals the JAX package's, under churn
    and loss."""
    g, jg, sched, jsched = _pair(seed=3)
    horizon = 16
    cm = churn.random_churn(g.n, horizon, 0.3, 3.0, 1, seed=4)
    jcm = jchurn.random_churn(g.n, horizon, 0.3, 3.0, 1, seed=4)
    loss, jloss = LinkLossModel(0.2, seed=8), JaxLoss(0.2, seed=8)
    partners = protocols.seeded_partners(g, horizon, 5)
    oracle = protocols.pushpull_oracle(g, sched, horizon, partners, churn=cm,
                                       loss=loss, mode=mode)
    _same(oracle, jproto.pushpull_oracle(jg, jsched, horizon, partners, churn=jcm,
                                         loss=jloss, mode=mode))
    got, _ = protocols.run_pushpull_sim(g, sched, horizon, seed=5, churn=cm, loss=loss,
                                        mode=mode, device="cpu")
    _same(got, oracle)


def test_seeded_pushk_equals_oracle_and_jax_oracle():
    g, jg, sched, jsched = _pair(seed=4)
    horizon = 16
    cm = churn.random_churn(g.n, horizon, 0.3, 3.0, 1, seed=6)
    jcm = jchurn.random_churn(g.n, horizon, 0.3, 3.0, 1, seed=6)
    loss, jloss = LinkLossModel(0.15, seed=2), JaxLoss(0.15, seed=2)
    partners = protocols.seeded_partners(g, horizon, 7, fanout=3)
    oracle = protocols.pushk_oracle(g, sched, horizon, partners, churn=cm, loss=loss)
    _same(oracle, jproto.pushk_oracle(jg, jsched, horizon, partners, churn=jcm,
                                      loss=jloss))
    got, _ = protocols.run_pushk_sim(g, sched, horizon, fanout=3, seed=7, churn=cm,
                                     loss=loss, device="cpu")
    _same(got, oracle)


@pytest.mark.parametrize("mode", ["pushpull", "pull", "pushk"])
def test_partners_override_matches_jax_and_oracle(mode):
    """Pinned random (not seeded) partners force a one-round delay, even on
    a graph staged with lognormal delays."""
    g, jg, sched, jsched = _pair(n=60, seed=5)
    horizon = 14
    rng = np.random.default_rng(9)
    ell_idx, _ = g.ell()
    if mode == "pushk":
        k = (rng.random((horizon, g.n, 2)) * g.degree[None, :, None]).astype(np.int64)
        pinned = ell_idx[np.arange(g.n)[None, :, None], k]
    else:
        k = (rng.random((horizon, g.n)) * g.degree[None, :]).astype(np.int64)
        pinned = ell_idx[np.arange(g.n)[None, :], k]
    delays = pt.lognormal_delays(g, 2.0, 0.5, 4, seed=5)
    if mode == "pushk":
        got, _ = protocols.run_pushk_sim(g, sched, horizon, fanout=2, ell_delays=delays,
                                         partners_override=pinned, device="cpu")
        want, _ = jproto.run_pushk_sim(jg, jsched, horizon, fanout=2, ell_delays=delays,
                                       partners_override=pinned)
        oracle = protocols.pushk_oracle(g, sched, horizon, pinned)
    else:
        got, _ = protocols.run_pushpull_sim(g, sched, horizon, ell_delays=delays,
                                            partners_override=pinned, mode=mode,
                                            device="cpu")
        want, _ = jproto.run_pushpull_sim(jg, jsched, horizon, ell_delays=delays,
                                          partners_override=pinned, mode=mode)
        oracle = protocols.pushpull_oracle(g, sched, horizon, pinned, mode=mode)
    _same(got, want)
    _same(got, oracle)


def test_pull_credit_bound_at_the_jax_bound():
    """max degree x chunk width >= 2^32 raises in both packages with the
    same message; one word less does not. A star's hub has degree 2^12, so
    a 2^20-share chunk meets the bound."""
    n = (1 << 12) + 1
    star = np.stack([np.zeros(n - 1, np.int64), np.arange(1, n)], axis=1)
    g, jg = pt.Graph.from_edges(n, star), pg.Graph.from_edges(n, star)
    width = 1 << 20
    protocols.check_pull_credit_width(g, width - 32)
    jproto.check_pull_credit_width(jg, width - 32)
    with pytest.raises(protocols.PullCreditBoundError) as got:
        protocols.check_pull_credit_width(g, width)
    with pytest.raises(jproto.PullCreditBoundError) as want:
        jproto.check_pull_credit_width(jg, width)
    assert str(got.value) == str(want.value)
    sched = pt.Schedule(n, np.zeros(width, np.int32), np.full(width, 99, np.int32))
    for chunk, raises in ((width, True), (width - 32, False)):
        try:
            protocols._check_pull_credit_bound(g, chunk, sched)
        except protocols.PullCreditBoundError:
            assert raises
        else:
            assert not raises
    with pytest.raises(protocols.PullCreditBoundError):
        protocols.run_pushpull_sim(g, sched, 4, chunk_size=width, mode="pull",
                                   device="cpu")
    assert issubclass(protocols.PullCreditBoundError, ValueError)


def test_bucketed_staging_and_coverage_checkpoints_are_refused(tmp_path):
    g, _, sched, _ = _pair(seed=6)
    dg = DeviceGraph.build(g, bucketed=True, device="cpu")
    with pytest.raises(ValueError, match="bucketed=False"):
        protocols.run_pushpull_sim(g, sched, 4, device_graph=dg, device="cpu")
    with pytest.raises(ValueError, match="record_coverage"):
        protocols.run_pushk_sim(g, sched, 4, record_coverage=True, device="cpu",
                                checkpoint_path=str(tmp_path / "c.npz"))
    with pytest.raises(ValueError, match="fanout"):
        protocols.run_pushk_sim(g, sched, 4, fanout=0, device="cpu")
    with pytest.raises(ValueError, match="mode"):
        protocols.run_pushpull_sim(g, sched, 4, mode="push", device="cpu")


def _ckpt_case():
    """Three 64-share chunks under lognormal delays, churn and loss, so every
    part of the fingerprint is in play."""
    g, jg = pt.erdos_renyi(70, 0.08, seed=12), pg.erdos_renyi(70, 0.08, seed=12)
    sched = pt.uniform_renewal_schedule(70, 9.0, 0.45, seed=12)
    jsched = pg.uniform_renewal_schedule(70, 9.0, 0.45, seed=12)
    assert sched.num_shares > 128
    d = pt.lognormal_delays(g, 2.0, 0.5, 4, seed=12)
    cm = churn.random_churn(70, 20, 0.3, 3.0, 2, seed=3)
    jcm = jchurn.random_churn(70, 20, 0.3, 3.0, 2, seed=3)
    port = dict(ell_delays=d, seed=4, chunk_size=64, churn=cm,
                loss=LinkLossModel(0.1, seed=9))
    jax = dict(ell_delays=d, seed=4, chunk_size=64, churn=jcm,
               loss=JaxLoss(0.1, seed=9))
    return (g, sched, port), (jg, jsched, jax)


@pytest.mark.parametrize("proto", ["pushpull", "pushk"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_crosses_packages(tmp_path, writer, proto):
    """One package stops after a chunk, the other resumes from its file to
    the JAX package's uninterrupted counters."""
    (g, sched, port_kw), (jg, jsched, jax_kw) = _ckpt_case()
    if proto == "pushk":
        port_fn, jax_fn = protocols.run_pushk_sim, jproto.run_pushk_sim
        port_kw, jax_kw = dict(port_kw, fanout=2), dict(jax_kw, fanout=2)
    else:
        port_fn, jax_fn = protocols.run_pushpull_sim, jproto.run_pushpull_sim
    want, _ = jax_fn(jg, jsched, 20, **jax_kw)
    ckpt = str(tmp_path / "run.npz")
    if writer == "jax":
        part, _ = jax_fn(jg, jsched, 20, checkpoint_path=ckpt, stop_after_chunks=1,
                         **jax_kw)
        got, _ = port_fn(g, sched, 20, checkpoint_path=ckpt, device="cpu", **port_kw)
    else:
        part, _ = port_fn(g, sched, 20, checkpoint_path=ckpt, stop_after_chunks=1,
                          device="cpu", **port_kw)
        got, _ = jax_fn(jg, jsched, 20, checkpoint_path=ckpt, **jax_kw)
    assert part.received.sum() < want.received.sum()
    _same(got, want)


def test_checkpoint_of_another_protocol_starts_fresh(tmp_path, capsys):
    """A pull checkpoint does not resume a push-pull run (the protocol name
    is part of the fingerprint)."""
    (g, sched, port_kw), _ = _ckpt_case()
    ckpt = str(tmp_path / "run.npz")
    protocols.run_pushpull_sim(g, sched, 20, checkpoint_path=ckpt, stop_after_chunks=1,
                               mode="pull", device="cpu", **port_kw)
    got, _ = protocols.run_pushpull_sim(g, sched, 20, checkpoint_path=ckpt,
                                        device="cpu", **port_kw)
    want, _ = protocols.run_pushpull_sim(g, sched, 20, device="cpu", **port_kw)
    _same(got, want)
    assert "(fingerprint mismatch); starting fresh" in capsys.readouterr().err
