"""Monte-Carlo campaigns of the port (``p2p_gossip_tpu_torch.batch``)
against the JAX package's ``batch``: the same numpy ``ReplicaSet`` through
both runners gives bitwise-equal per-replica counters and coverage rows,
for the flood (coverage and multi-chunk gossip campaigns), the three
random-partner protocols, under churn and link loss (one loss seed for
the cell, or one a replica), in padded batches. Replica r equals the
port's solo run with its seeds; campaign checkpoints resume across the two
packages; the ensemble statistics and sweep records are equal. The port
runs with ``device="cpu"`` (its kernels' plain versions)."""

import dataclasses
import json

import numpy as np
import pytest
import torch

import p2p_gossip_tpu as pg
from p2p_gossip_tpu.batch import campaign as jc
from p2p_gossip_tpu.batch import stats as jstats
from p2p_gossip_tpu.batch import sweep as jsweep
from p2p_gossip_tpu.models import seeds as jseeds

import p2p_gossip_tpu_torch as pt
from p2p_gossip_tpu_torch import telemetry
from p2p_gossip_tpu_torch.batch import campaign as tc
from p2p_gossip_tpu_torch.batch import stats as tstats
from p2p_gossip_tpu_torch.batch import sweep as tsweep
from p2p_gossip_tpu_torch.engine.sync import DeviceGraph, run_flood_coverage, run_sync_sim
from p2p_gossip_tpu_torch.models import seeds as tseeds
from p2p_gossip_tpu_torch.models.linkloss import drop_mask_np, drop_mask_torch
from p2p_gossip_tpu_torch.models.partnersel import pick_index_np, pick_index_torch
from p2p_gossip_tpu_torch.models.protocols import run_pushk_sim, run_pushpull_sim
from p2p_gossip_tpu_torch.ops import kernels

N, P, HORIZON = 48, 0.12, 24
SEEDS = [3, 4, 5, 6, 7]
FIELDS = ("generated", "received", "sent", "coverage")


def _graphs(n=N, p=P, seed=1):
    return pg.erdos_renyi(n, p, seed=seed), pt.erdos_renyi(n, p, seed=seed)


def _delays(kind, jg, tg):
    if kind != "lognormal":
        return None
    want = pg.lognormal_delays(jg, 2.0, 0.5, 4, seed=2)
    got = pt.lognormal_delays(tg, 2.0, 0.5, 4, seed=2)
    np.testing.assert_array_equal(got, want)
    return want


def _port_set(rs):
    """The port's ReplicaSet on the JAX set's own arrays."""
    return tc.ReplicaSet(n=rs.n, origins=rs.origins, gen_ticks=rs.gen_ticks,
                         seeds=rs.seeds, churn=rs.churn)


def _losses(opts):
    """(JAX loss, port loss, loss_seeds) for an option set."""
    if "loss" not in opts:
        return None, None, None
    per_replica = "seeds" in opts
    lseeds = jseeds.replica_loss_seeds(SEEDS) if per_replica else None
    return pg.LinkLossModel(0.2, seed=9), pt.LinkLossModel(0.2, seed=9), lseeds


def assert_same(got, want):
    for key in FIELDS:
        a, b = getattr(got, key), getattr(want, key)
        if b is None:
            assert a is None, key
            continue
        assert a.shape == b.shape, key
        np.testing.assert_array_equal(a, b, err_msg=key)
    np.testing.assert_array_equal(got.seeds, want.seeds)
    np.testing.assert_array_equal(got.degree, want.degree)
    assert (got.horizon, got.batch_size) == (want.horizon, want.batch_size)


OPTIONS = ["plain", "churn+loss", "churn+loss+seeds"]


@pytest.mark.parametrize("delay", ["constant", "lognormal"])
@pytest.mark.parametrize("opts", OPTIONS)
def test_coverage_campaign_matches_jax(opts, delay):
    jg, tg = _graphs()
    delays = _delays(delay, jg, tg)
    churn = dict(churn_prob=0.3, mean_down_ticks=3) if "churn" in opts else {}
    rs = jc.flood_replicas(jg, 5, SEEDS, HORIZON, **churn)
    jl, tl, lseeds = _losses(opts)
    want = jc.run_coverage_campaign(jg, rs, HORIZON, ell_delays=delays, loss=jl,
                                    loss_seeds=lseeds, batch_size=2)
    got = tc.run_coverage_campaign(tg, _port_set(rs), HORIZON, ell_delays=delays,
                                   loss=tl, loss_seeds=lseeds, batch_size=2, device="cpu")
    assert_same(got, want)
    assert got.coverage[:, -1].max() > 5  # the floods spread


@pytest.mark.parametrize("opts", OPTIONS)
def test_gossip_campaign_multichunk_matches_jax(opts):
    jg, tg = _graphs()
    churn = dict(churn_prob=0.3, mean_down_ticks=3) if "churn" in opts else {}
    rs = jc.gossip_replicas(jg, 0.15, 0.005, SEEDS, 30, gen_lo=0.03, gen_hi=0.06, **churn)
    assert rs.shares_per_replica > 64  # three or more 32-share chunks
    jl, tl, lseeds = _losses(opts)
    want = jc.run_gossip_campaign(jg, rs, 30, loss=jl, loss_seeds=lseeds,
                                  chunk_size=32, batch_size=3)
    got = tc.run_gossip_campaign(tg, _port_set(rs), 30, loss=tl, loss_seeds=lseeds,
                                 chunk_size=32, batch_size=3, device="cpu")
    assert_same(got, want)


@pytest.mark.parametrize("opts", OPTIONS)
@pytest.mark.parametrize("protocol", ["pushpull", "pull", "pushk"])
def test_protocol_campaign_matches_jax(protocol, opts):
    jg, tg = _graphs()
    delays = _delays("lognormal" if protocol == "pushpull" else "constant", jg, tg)
    churn = dict(churn_prob=0.3, mean_down_ticks=3) if "churn" in opts else {}
    rs = jc.flood_replicas(jg, 5, SEEDS, HORIZON, **churn)
    jl, tl, lseeds = _losses(opts)
    kw = dict(protocol=protocol, fanout=3, ell_delays=delays, loss_seeds=lseeds,
              batch_size=2)
    want = jc.run_protocol_campaign(jg, rs, HORIZON, loss=jl, **kw)
    got = tc.run_protocol_campaign(tg, _port_set(rs), HORIZON, loss=tl, device="cpu", **kw)
    assert_same(got, want)
    assert got.received.sum() > 0


def test_protocol_campaign_share_chunks_match_jax():
    """Shares past one pass run in chunks (coverage columns chunk by
    chunk), without coverage too."""
    jg, tg = _graphs()
    rs = jc.flood_replicas(jg, 70, SEEDS[:3], HORIZON)
    for record in (True, False):
        kw = dict(protocol="pushpull", chunk_size=32, record_coverage=record)
        want = jc.run_protocol_campaign(jg, rs, HORIZON, **kw)
        got = tc.run_protocol_campaign(tg, _port_set(rs), HORIZON, device="cpu", **kw)
        assert_same(got, want)


def test_replica_builders_match_jax():
    jg, tg = _graphs()
    for build in ("flood", "gossip"):
        if build == "flood":
            want = jc.flood_replicas(jg, 6, SEEDS, HORIZON, churn_prob=0.3)
            got = tc.flood_replicas(tg, 6, SEEDS, HORIZON, churn_prob=0.3)
        else:
            want = jc.gossip_replicas(jg, 0.2, 0.005, SEEDS, 40, 0.05, 0.1, churn_prob=0.3)
            got = tc.gossip_replicas(tg, 0.2, 0.005, SEEDS, 40, 0.05, 0.1, churn_prob=0.3)
        for key in ("origins", "gen_ticks", "seeds"):
            np.testing.assert_array_equal(getattr(got, key), getattr(want, key))
        for a, b in zip(got.churn, want.churn):
            np.testing.assert_array_equal(a, b)
    assert tseeds.replica_loss_seeds(SEEDS) == jseeds.replica_loss_seeds(SEEDS)


@pytest.mark.parametrize("batch_size", [1, 2, 4, None])
def test_batches_and_sentinel_padding_leave_results_unchanged(batch_size):
    """R = 5 in batches that do not divide it (padded with sentinel
    replicas) equals the JAX package's unpadded run, under churn and
    per-replica loss."""
    jg, tg = _graphs()
    rs = jc.flood_replicas(jg, 4, SEEDS, HORIZON, churn_prob=0.3, mean_down_ticks=3)
    jl, tl, lseeds = _losses("churn+loss+seeds")
    want = jc.run_coverage_campaign(jg, rs, HORIZON, loss=jl, loss_seeds=lseeds)
    got = tc.run_coverage_campaign(tg, _port_set(rs), HORIZON, loss=tl, loss_seeds=lseeds,
                                   batch_size=batch_size, device="cpu")
    for key in FIELDS:
        np.testing.assert_array_equal(getattr(got, key), getattr(want, key))
    assert got.batch_size == (batch_size or len(SEEDS))


@pytest.mark.parametrize("kind", ["coverage", "gossip", "pushpull", "pushk"])
def test_replica_equals_the_ports_solo_run(kind):
    """Replica r of a port campaign is the port's solo run with r's seeds:
    its schedule, churn and loss streams (the CLI's offsets)."""
    _, tg = _graphs()
    horizon = 30 if kind == "gossip" else HORIZON
    churn = dict(churn_prob=0.3, mean_down_ticks=3)
    if kind == "gossip":
        rs = tc.gossip_replicas(tg, 0.15, 0.005, SEEDS, horizon, 0.03, 0.06, **churn)
    else:
        rs = tc.flood_replicas(tg, 5, SEEDS, horizon, **churn)
    lseeds = tseeds.replica_loss_seeds(SEEDS)
    kw = dict(loss=pt.LinkLossModel(0.2, seed=0), loss_seeds=lseeds, batch_size=2,
              device="cpu")
    if kind == "coverage":
        res = tc.run_coverage_campaign(tg, rs, horizon, **kw)
    elif kind == "gossip":
        res = tc.run_gossip_campaign(tg, rs, horizon, chunk_size=32, **kw)
    else:
        res = tc.run_protocol_campaign(tg, rs, horizon, protocol=kind, **kw)
    for r, seed in enumerate(SEEDS):
        loss = pt.LinkLossModel(0.2, seed=tseeds.loss_stream_seed(seed))
        churn_r = rs.replica_churn(r)
        sched = rs.replica_schedule(r, horizon)
        cov = None
        if kind == "coverage":
            stats, cov = run_flood_coverage(tg, rs.origins[r], horizon, churn=churn_r,
                                            loss=loss, chunk_size=32, device="cpu")
        elif kind == "gossip":
            stats = run_sync_sim(tg, sched, horizon, chunk_size=32, churn=churn_r, loss=loss,
                                 device="cpu")
        elif kind == "pushpull":
            stats, cov = run_pushpull_sim(tg, sched, horizon, seed=seed, churn=churn_r,
                                          loss=loss, record_coverage=True, device="cpu")
        else:
            stats, cov = run_pushk_sim(tg, sched, horizon, seed=seed, churn=churn_r,
                                       loss=loss, record_coverage=True, device="cpu")
        for key in ("generated", "received", "sent"):
            np.testing.assert_array_equal(getattr(stats, key), getattr(res, key)[r])
        if cov is not None:
            np.testing.assert_array_equal(cov, res.coverage[r])
        if kind in ("coverage", "gossip"):  # the flood's reference invariants
            res.replica_stats(r).check_conservation()


def _campaign(pkg, kind, graph, rs, **kw):
    mod = jc if pkg == "jax" else tc
    if pkg == "port":
        kw["device"] = "cpu"
        rs = _port_set(rs)
    if kind == "coverage":
        return mod.run_coverage_campaign(graph, rs, HORIZON, batch_size=2, **kw)
    return mod.run_protocol_campaign(graph, rs, HORIZON, protocol="pull", batch_size=2, **kw)


@pytest.mark.parametrize("kind", ["coverage", "protocol"])
@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_campaign_checkpoint_resumes_in_the_other_package(writer, reader, kind, tmp_path):
    """A campaign stopped after one batch by one package resumes in the
    other: same fingerprint, same npz keys, and the resumed run equals an
    uninterrupted one."""
    jg, tg = _graphs()
    graphs = {"jax": jg, "port": tg}
    rs = jc.flood_replicas(jg, 5, SEEDS, HORIZON, churn_prob=0.3, mean_down_ticks=3)
    jl, tl, lseeds = _losses("churn+loss+seeds")
    losses = {"jax": jl, "port": tl}
    path = str(tmp_path / "campaign.npz")

    def run(pkg, **kw):
        return _campaign(pkg, kind, graphs[pkg], rs, loss=losses[pkg], loss_seeds=lseeds,
                         checkpoint_path=path, **kw)

    full = _campaign(reader, kind, graphs[reader], rs, loss=losses[reader], loss_seeds=lseeds)
    partial = run(writer, stop_after_batches=1)
    assert partial.received[2:].sum() == 0  # batches 2 and 3 did not run
    resumed = run(reader)
    for key in FIELDS:
        np.testing.assert_array_equal(getattr(resumed, key), getattr(full, key))


@pytest.fixture
def rings_on():
    telemetry.reset()
    telemetry.configure(None, rings=True)
    yield
    telemetry.reset()


def test_campaigns_refuse_telemetry_rings(rings_on):
    """The campaigns no longer refuse telemetry's rings: each runner emits
    one ring and one digest event per replica (their values are held to
    the JAX package's in tests/test_torch_campaign_telemetry.py)."""
    _, tg = _graphs()
    rs = tc.flood_replicas(tg, 3, SEEDS, HORIZON)
    runs = (tc.run_coverage_campaign, tc.run_gossip_campaign, tc.run_protocol_campaign)
    for run in runs:
        run(tg, rs, HORIZON, device="cpu")
    for kind in ("ring", "digest"):
        tags = [(e["kernel"], e["replica"], e["seed"])
                for e in telemetry.events() if e["type"] == kind]
        assert len(tags) == len(runs) * len(SEEDS)
        assert {t[1:] for t in tags} == set(enumerate(SEEDS))


def test_campaign_validation():
    _, tg = _graphs()
    rs = tc.flood_replicas(tg, 3, SEEDS, HORIZON)
    loss = pt.LinkLossModel(0.1)
    with pytest.raises(ValueError, match="requires a loss model"):
        tc.run_coverage_campaign(tg, rs, HORIZON, loss_seeds=SEEDS, device="cpu")
    with pytest.raises(ValueError, match="one seed per replica"):
        tc.run_gossip_campaign(tg, rs, HORIZON, loss=loss, loss_seeds=SEEDS[:2], device="cpu")
    with pytest.raises(ValueError, match="batch_size"):
        tc.run_coverage_campaign(tg, rs, HORIZON, batch_size=0, device="cpu")
    with pytest.raises(ValueError, match="protocol must be"):
        tc.run_protocol_campaign(tg, rs, HORIZON, protocol="push", device="cpu")
    with pytest.raises(ValueError, match="fanout"):
        tc.run_protocol_campaign(tg, rs, HORIZON, protocol="pushk", fanout=0, device="cpu")
    bucketed = DeviceGraph.build(tg, bucketed=True, device="cpu")
    with pytest.raises(ValueError, match="bucketed=False"):
        tc.run_protocol_campaign(tg, rs, HORIZON, device_graph=bucketed, device="cpu")
    with pytest.raises(ValueError, match="one seed per replica"):
        tc.ReplicaSet(n=N, origins=rs.origins, gen_ticks=rs.gen_ticks, seeds=rs.seeds[:2])


def test_pull_credit_bound_matches_jax():
    """A pull campaign whose per-round credit could pass 2^32 is refused
    by both packages with the same error type and message."""
    from p2p_gossip_tpu.models.protocols import PullCreditBoundError as JaxBound
    from p2p_gossip_tpu_torch.models.protocols import PullCreditBoundError

    jg, tg = pg.complete_graph(40), pt.complete_graph(40)
    rs = jc.flood_replicas(jg, 3, SEEDS[:2], 4)
    kw = dict(protocol="pull", chunk_size=2**27)
    with pytest.raises(JaxBound) as want:
        jc.run_protocol_campaign(jg, rs, 4, **kw)
    with pytest.raises(PullCreditBoundError) as got:
        tc.run_protocol_campaign(tg, _port_set(rs), 4, device="cpu", **kw)
    assert str(got.value) == str(want.value)


def _strip_wall(summary):
    summary = json.loads(json.dumps(summary))
    summary.pop("wall_s")
    return summary


@pytest.mark.parametrize("kind", ["coverage", "gossip", "single"])
def test_ensemble_summary_and_report_match_jax(kind):
    jg, tg = _graphs()
    if kind == "gossip":
        rs = jc.gossip_replicas(jg, 0.1, 0.005, SEEDS, 30, 0.03, 0.06)
        want = jc.run_gossip_campaign(jg, rs, 30, chunk_size=32)
        got = tc.run_gossip_campaign(tg, _port_set(rs), 30, chunk_size=32, device="cpu")
    else:
        seeds = SEEDS[:1] if kind == "single" else SEEDS
        rs = jc.flood_replicas(jg, 4, seeds, HORIZON)
        want = jc.run_coverage_campaign(jg, rs, HORIZON)
        got = tc.run_coverage_campaign(tg, _port_set(rs), HORIZON, device="cpu")
    for fraction in (0.5, 0.99):
        a = tstats.ensemble_summary(got, fraction)
        b = jstats.ensemble_summary(want, fraction)
        assert _strip_wall(a) == _strip_wall(b)
        json.dumps(a, allow_nan=False)
    if kind == "coverage":
        np.testing.assert_array_equal(tstats.ttc_matrix(got.coverage, N),
                                      jstats.ttc_matrix(want.coverage, N))
    records = [{"cell": {"protocol": "push", "p": P}, "summary": tstats.ensemble_summary(got)}]
    assert tstats.format_campaign_report(records) == jstats.format_campaign_report(
        [{"cell": {"protocol": "push", "p": P}, "summary": jstats.ensemble_summary(want)}])


@pytest.mark.parametrize("samples", [[], [3.0], [1.0, 5.0, 2.0, 8.0, 8.0, 13.0]])
def test_percentile_summary_and_mean_ci_match_jax(samples):
    samples = np.asarray(samples)
    assert tstats.percentile_summary(samples) == jstats.percentile_summary(samples)
    assert tstats.mean_ci(samples) == jstats.mean_ci(samples)


@pytest.mark.parametrize("spec", [
    jsweep.example_spec(),
    {"protocol": ["push", "pushpull", "pull", "pushk"], "fanout": [2, 3], "p": [0.1, 0.2],
     "replicas": [5, 9]},
    {"lossProb": [0.0, 0.1, 0.2], "churnProb": [0.0, 0.5], "topology": "ba", "p": 2.0},
])
def test_expand_grid_matches_jax(spec):
    assert tsweep.expand_grid(spec) == jsweep.expand_grid(spec)
    assert tsweep.example_spec() == jsweep.example_spec()
    assert (tsweep._DEFAULTS, tsweep.GRID_AXES) == (jsweep._DEFAULTS, jsweep.GRID_AXES)


@pytest.mark.parametrize("spec", [{"bogus": 1}, {"numNodes": [10, 20]}])
def test_expand_grid_refuses_what_jax_refuses(spec):
    with pytest.raises(ValueError) as want:
        jsweep.expand_grid(spec)
    with pytest.raises(ValueError) as got:
        tsweep.expand_grid(spec)
    assert str(got.value) == str(want.value)


def _without_wall(record):
    record = json.loads(json.dumps(record))
    record.pop("wall_s")
    record["summary"].pop("wall_s")
    return record


def test_run_sweep_records_match_jax():
    spec = {"numNodes": 40, "p": 0.15, "protocol": ["push", "pushpull", "pushk"],
            "lossProb": [0.0, 0.2], "churnProb": 0.2, "replicas": 3, "shares": 3,
            "horizon": 20}
    emitted = []
    got = tsweep.run_sweep(spec, batch_size=2, emit=emitted.append, device="cpu")
    want = jsweep.run_sweep(spec, batch_size=2)
    assert emitted == got and len(got) == 6
    assert [_without_wall(r) for r in got] == [_without_wall(r) for r in want]
    assert {r["platform"] for r in got} == {"cpu"}
    assert tstats.format_campaign_report(got) == jstats.format_campaign_report(want)


# --- the two kernel inputs a replica axis changed ---------------------------------

def test_gather_or_replicas_plain_equals_solo_calls():
    """Plain gather_or with B = 3 stacked rings and per-replica loss seeds
    equals three solo calls, each on its replica's rows with its own seed;
    keying the coin by the stacked row instead of the node id (a solo call
    over the whole stack) gives another result."""
    rng = np.random.default_rng(0)
    b, n, w, cap, ring = 3, 40, 5, 6, 3
    hist = torch.as_tensor(rng.integers(-2**31, 2**31, (ring, b * n, w), dtype=np.int64)
                           .astype(np.int32))
    idx = torch.as_tensor(rng.integers(0, n, (n, cap)).astype(np.int32))
    mask = torch.as_tensor(rng.random((n, cap)) < 0.8)
    delay = torch.as_tensor(rng.integers(1, ring, (n, cap)).astype(np.int32))
    up = torch.as_tensor(rng.random(b * n) > 0.2)
    seeds = np.asarray([7, 2**31 + 5, 12345], dtype=np.uint32)
    threshold = int(0.4 * 2**32)
    loss = (threshold, torch.as_tensor(seeds.view(np.int32)))
    got = kernels.gather_or(hist, 4, idx, mask, delay, loss=loss, up=up, replicas=b,
                            out=torch.empty((b * n, w), dtype=torch.int32))
    for r in range(b):
        rows = slice(r * n, (r + 1) * n)
        solo = kernels.gather_or(hist[:, rows], 4, idx, mask, delay,
                                 loss=(threshold, int(seeds[r])), up=up[rows],
                                 out=torch.empty((n, w), dtype=torch.int32))
        np.testing.assert_array_equal(got[rows].numpy(), solo.numpy())
    # The coin keyed by the stacked row r*n + dst (one seed, one flat ELL
    # over the stack) drops other edges.
    flat_idx = torch.cat([idx + r * n for r in range(b)])
    keyed_by_row = kernels.gather_or(
        hist, 4, flat_idx, mask.repeat(b, 1), delay.repeat(b, 1),
        loss=(threshold, int(seeds[0])), up=up,
        out=torch.empty((b * n, w), dtype=torch.int32))
    assert not torch.equal(keyed_by_row[n:], got[n:])
    assert kernels.launches["gather_or"] == 0  # CPU tensors: the plain version


def test_coverage_per_slot_replicas_plain_equals_solo_calls():
    rng = np.random.default_rng(1)
    words = torch.as_tensor(rng.integers(-2**31, 2**31, (4, 50, 6), dtype=np.int64)
                            .astype(np.int32))
    got = kernels.coverage_per_slot(words[:, :, :5], 150)
    assert got.shape == (4, 150)
    for r in range(4):
        np.testing.assert_array_equal(got[r].numpy(),
                                      kernels.coverage_per_slot(words[r, :, :5], 150).numpy())


def test_coin_and_pick_take_a_seed_tensor():
    """drop_mask_torch and pick_key broadcast a tensor of seeds (uint32
    bit patterns in int32) as per-replica streams, bit for bit the numpy
    spec with each seed."""
    seeds = np.asarray([1, 2**31 + 9, 2**32 - 1], dtype=np.uint32)
    seed_t = torch.as_tensor(seeds.view(np.int32))[:, None]
    src, dst = np.arange(20)[None, :], (np.arange(20) * 7 % 20)[None, :]
    got = drop_mask_torch(torch.as_tensor(src), torch.as_tensor(dst), 5, 2**31, seed_t)
    picks = pick_index_torch(torch.as_tensor(src), 5, 0, 6, seed_t)
    for r, seed in enumerate(seeds):
        np.testing.assert_array_equal(got[r].numpy(), drop_mask_np(src, dst, 5, 2**31,
                                                                   int(seed))[0])
        np.testing.assert_array_equal(picks[r].numpy(), pick_index_np(src, 5, 0, 6,
                                                                       int(seed))[0])


def test_campaign_result_helpers_match_jax():
    jg, tg = _graphs()
    rs = jc.flood_replicas(jg, 4, SEEDS[:3], HORIZON)
    want = jc.run_coverage_campaign(jg, rs, HORIZON)
    got = tc.run_coverage_campaign(tg, _port_set(rs), HORIZON, device="cpu")
    assert got.num_replicas == want.num_replicas == 3
    for key, vals in want.totals_per_replica().items():
        np.testing.assert_array_equal(got.totals_per_replica()[key], vals)
    for r in range(3):
        a, b = got.replica_stats(r), want.replica_stats(r)
        for f in dataclasses.fields(b):
            if f.name != "extra":
                np.testing.assert_array_equal(getattr(a, f.name), getattr(b, f.name))
