"""The gather masked by the destinations' seen-sets (`ops.kernels.gather_or`
with ``seen``) and the flood engine that runs it.

CPU: ``gather_or(..., seen=s)`` equals ``gather_or(...) & ~s`` bitwise
(the plain versions) with uniform and per-edge delays, on a full-width
and a bucketed ELL, with the loss coin and the up mask, with two replicas
and per-replica loss seeds, with a row of more than 128 entries, at W = 4,
128 and 1,024 words (8- and 32-word sectors). The engine passes each
tick's ``seen`` to the gather (the raw gather with telemetry's rings on)
and stays bitwise the JAX package's in counters, executed ticks and
coverage rows, under loss, churn, a per-edge delay ring and a campaign of
two replicas. The gather's counter reaches the entries' ``stats`` span.

Card (``card`` marker, skipped without one): the kernel against the plain
version with ``seen`` on ragged shapes, its counts against the unmasked
gather's loads, and whole runs against ``plain=True`` runs. On the card,
without the JAX package: ``python -m pytest --noconftest -p no:cacheprovider
-m card tests/test_torch_gather_seen.py``. The JAX package is imported only
inside the CPU parity tests."""

import numpy as np
import pytest
import torch

import p2p_gossip_tpu_torch as pt
from p2p_gossip_tpu_torch import telemetry
from p2p_gossip_tpu_torch.engine import sync
from p2p_gossip_tpu_torch.ops import ell, kernels

N, CAP, HUB_CAP, RING = 40, 12, 140, 3
LAYOUTS = ["uniform", "per_edge", "bucketed", "bucketed_per_edge"]
OPTIONS = ["none", "loss+up", "replicas"]


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _clean_telemetry(monkeypatch):
    monkeypatch.delenv("P2P_TELEMETRY", raising=False)
    telemetry.reset()
    yield
    telemetry.reset()


def _words(rng, shape):
    return torch.as_tensor(rng.integers(-2**31, 2**31, shape, dtype=np.int64).astype(np.int32))


def _ring(rng, b, w):
    """A (D, B*N, W) frontier ring whose rows hold bits in a few 16-byte
    units, as a flood's do, with its exact sector occupancy."""
    hist = _words(rng, (RING, b * N, w))
    units = -(-w // 4)
    keep = torch.as_tensor(np.repeat(rng.random((RING, b * N, units)) < 0.3, 4, axis=2)[..., :w])
    hist = torch.where(keep, hist, 0)
    occ = torch.stack([kernels.sector_occupancy(h) for h in hist])
    return hist, occ


def _seen(rng, rows, w):
    """Seen-sets with every kind of unit: random words, whole units of all
    ones (nothing lacking), zero units, a saturated row and an empty one."""
    seen = _words(rng, (rows, w))
    units = -(-w // 4)
    kind = np.repeat(rng.integers(0, 3, (rows, units)), 4, axis=1)[:, :w]
    seen = torch.where(torch.as_tensor(kind == 1), -1, seen)
    seen = torch.where(torch.as_tensor(kind == 2), 0, seen)
    seen[0] = -1
    seen[1] = 0
    return seen


def _ell(rng):
    """An (N, HUB_CAP) ELL: row 3 a hub with every entry valid (two staging
    rounds of 128), the others at most CAP valid entries."""
    idx = torch.as_tensor(rng.integers(0, N, (N, HUB_CAP)).astype(np.int32))
    mask = torch.as_tensor(rng.random((N, HUB_CAP)) < 0.8)
    mask[:, CAP:] = False
    mask[3] = True
    delay = torch.as_tensor(rng.integers(1, RING, (N, HUB_CAP)).astype(np.int32))
    return idx, mask, delay


def _buckets(rng, idx, mask, delay, per_edge):
    """Two buckets in shuffled row order: the hub alone at its cap, the
    other rows at CAP."""
    order = rng.permutation(np.arange(N)[np.arange(N) != 3])
    out = []
    for rows, cap in ((np.asarray([3]), HUB_CAP), (order, CAP)):
        r = torch.as_tensor(rows.astype(np.int64))
        out.append((torch.as_tensor(rows.astype(np.int32)), idx[r, :cap].contiguous(),
                    mask[r, :cap].contiguous(),
                    delay[r, :cap].contiguous() if per_edge else None))
    return tuple(out)


def _gather(layout, hist, occ, idx, mask, delay, buckets, tick, **kw):
    per_edge = layout.endswith("per_edge")
    if layout.startswith("bucketed"):
        return ell.propagate_bucketed(hist, tick, buckets, n_out=N, ring_size=RING,
                                      uniform_delay=None if per_edge else 1, occ=occ, **kw)
    if per_edge:
        return ell.propagate(hist, tick, idx, delay, mask, ring_size=RING, occ=occ, **kw)
    return ell.propagate_uniform(hist, tick, idx, mask, ring_size=RING, uniform_delay=1,
                                 occ=occ, **kw)


@pytest.mark.parametrize("w", [4, 128, 1024])
@pytest.mark.parametrize("opts", OPTIONS)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_masked_gather_is_the_raw_gather_and_not_seen(layout, opts, w):
    rng = np.random.default_rng([LAYOUTS.index(layout), OPTIONS.index(opts), w])
    b = 2 if opts == "replicas" else 1
    hist, occ = _ring(rng, b, w)
    idx, mask, delay = _ell(rng)
    buckets = _buckets(rng, idx, mask, delay, layout.endswith("per_edge"))
    kw = dict(replicas=b)
    if opts == "loss+up":
        kw.update(loss=(int(0.3 * 2**32), 2**31 + 7), up=torch.as_tensor(rng.random(N) > 0.2))
    elif opts == "replicas":
        seeds = np.asarray([11, 2**31 + 5], dtype=np.uint32).view(np.int32)
        kw.update(loss=(int(0.3 * 2**32), torch.as_tensor(seeds)),
                  up=torch.as_tensor(rng.random(b * N) > 0.2))
    seen = _seen(rng, b * N, w)
    raw = _gather(layout, hist, occ, idx, mask, delay, buckets, 5, **kw)
    got = _gather(layout, hist, occ, idx, mask, delay, buckets, 5, seen=seen, **kw)
    assert torch.equal(got, raw & ~seen)
    assert (raw & seen).any() and got.any()  # the mask cleared bits and kept some
    assert not got[0].any()  # a saturated destination gets nothing
    if opts == "none" and layout == "per_edge":  # and the raw gather is the oracle's
        want = ell.propagate_reference(hist, 5, idx, delay, mask, ring_size=RING)
        assert torch.equal(raw, want)


def test_masked_gather_checks_its_arguments():
    rng = np.random.default_rng(0)
    hist, occ = _ring(rng, 1, 4)
    idx, mask, _ = _ell(rng)
    out = torch.empty((N, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="seen"):
        kernels.gather_or(hist, 0, idx, mask, uniform_slot=0, out=out,
                          seen=torch.zeros((N, 3), dtype=torch.int32))
    with pytest.raises(ValueError, match="stats needs seen"):
        kernels.gather_or(hist, 0, idx, mask, uniform_slot=0, out=out,
                          stats=torch.zeros(2, dtype=torch.int64))
    seen = _seen(rng, N, 4)
    stats = torch.zeros(2, dtype=torch.int64)
    got = kernels.gather_or(hist, 0, idx, mask, uniform_slot=0, occ=occ, out=out.clone(),
                            seen=seen, stats=stats)
    raw = kernels.gather_or(hist, 0, idx, mask, uniform_slot=0, occ=occ, out=out.clone())
    assert torch.equal(got, raw & ~seen)
    assert stats.tolist() == [0, 0]  # the plain version counts nothing


# --- the engine -------------------------------------------------------------------

def _spy(monkeypatch):
    """Record each gather_or call's ``seen`` and ``stats``."""
    calls = []
    gather = kernels.gather_or

    def spy(*args, **kw):
        calls.append((kw.get("seen"), kw.get("stats")))
        return gather(*args, **kw)

    monkeypatch.setattr(kernels, "gather_or", spy)
    return calls


def _same(port, want):
    for f in ("generated", "received", "forwarded", "sent", "processed", "degree"):
        np.testing.assert_array_equal(getattr(port, f), getattr(want, f), err_msg=f)


ENGINE_CASES = ["er_loss", "er_churn", "er_lognormal", "ba_coverage_loss_churn"]


@pytest.mark.parametrize("case", ENGINE_CASES)
def test_engine_runs_the_masked_gather_and_equals_jax(case, monkeypatch):
    import p2p_gossip_tpu as pg
    from p2p_gossip_tpu.engine.sync import run_flood_coverage as jax_flood_coverage
    from p2p_gossip_tpu.engine.sync import run_sync_sim as jax_sync_sim

    calls = _spy(monkeypatch)
    if case.startswith("ba"):
        g, jg = pt.barabasi_albert(300, m=3, seed=2), pg.barabasi_albert(300, m=3, seed=2)
        origins = np.arange(0, 300, 7)
        kw_p = dict(churn=pt.random_churn(300, 40, outage_prob=0.3, mean_down_ticks=3,
                                          max_outages=2, seed=4),
                    loss=pt.LinkLossModel(0.2, seed=3))
        kw_j = dict(churn=pg.random_churn(300, 40, outage_prob=0.3, mean_down_ticks=3,
                                          max_outages=2, seed=4),
                    loss=pg.LinkLossModel(0.2, seed=3))
        dg = sync.DeviceGraph.build(g, bucketed=True, device="cpu")
        stats, cov = sync.run_flood_coverage(g, origins, 40, chunk_size=64, device_graph=dg,
                                             device="cpu", **kw_p)
        jstats, jcov = jax_flood_coverage(jg, origins, 40, chunk_size=64, **kw_j)
        np.testing.assert_array_equal(cov, jcov)
        assert cov[-1].max() > 200  # the floods spread
    else:
        g, jg = pt.erdos_renyi(80, 0.08, seed=6), pg.erdos_renyi(80, 0.08, seed=6)
        sched = pt.uniform_renewal_schedule(80, sim_time=3.0, tick_dt=0.005, seed=6)
        jsched = pg.uniform_renewal_schedule(80, sim_time=3.0, tick_dt=0.005, seed=6)
        kw_p, kw_j, dg = {}, {}, None
        if case == "er_loss":
            kw_p["loss"], kw_j["loss"] = pt.LinkLossModel(0.3, seed=1), pg.LinkLossModel(0.3, seed=1)
        elif case == "er_churn":
            ckw = dict(outage_prob=0.3, mean_down_ticks=20, max_outages=3, seed=2)
            kw_p["churn"] = pt.random_churn(80, 700, **ckw)
            kw_j["churn"] = pg.random_churn(80, 700, **ckw)
        else:
            d = pt.lognormal_delays(g, mean_ticks=2.0, sigma=0.6, max_ticks=5, seed=1)
            kw_p["ell_delays"] = kw_j["ell_delays"] = d
            dg = sync.DeviceGraph.build(g, d, bucketed=True, device="cpu")
        stats = sync.run_sync_sim(g, sched, 700, chunk_size=128, device_graph=dg,
                                  device="cpu", **kw_p)
        jstats = jax_sync_sim(jg, jsched, 700, chunk_size=128, **kw_j)
        assert stats.extra["ticks_executed"] == jstats.extra["ticks_executed"]
    _same(stats, jstats)
    assert calls and all(seen is not None and stats_ is None for seen, stats_ in calls)


def test_campaign_of_two_replicas_runs_the_masked_gather(monkeypatch):
    import p2p_gossip_tpu as pg
    from p2p_gossip_tpu.batch import campaign as jc
    from p2p_gossip_tpu.models import seeds as jseeds

    from p2p_gossip_tpu_torch.batch import campaign as tc

    calls = _spy(monkeypatch)
    jg, tg = pg.erdos_renyi(48, 0.12, seed=1), pt.erdos_renyi(48, 0.12, seed=1)
    rs = jc.flood_replicas(jg, 5, [3, 4], 24, churn_prob=0.3, mean_down_ticks=3)
    lseeds = jseeds.replica_loss_seeds([3, 4])
    want = jc.run_coverage_campaign(jg, rs, 24, loss=pg.LinkLossModel(0.2, seed=9),
                                    loss_seeds=lseeds, batch_size=2)
    got = tc.run_coverage_campaign(
        tg, tc.ReplicaSet(n=rs.n, origins=rs.origins, gen_ticks=rs.gen_ticks, seeds=rs.seeds,
                          churn=rs.churn),
        24, loss=pt.LinkLossModel(0.2, seed=9), loss_seeds=lseeds, batch_size=2, device="cpu")
    for key in ("generated", "received", "sent", "coverage"):
        np.testing.assert_array_equal(getattr(got, key), getattr(want, key), err_msg=key)
    assert got.coverage[:, -1].max() > 5
    assert calls and all(seen is not None and seen.shape[0] == 2 * 48 for seen, _ in calls)


def test_rings_keep_the_raw_gather(monkeypatch):
    """With telemetry's rings on the tick gathers unmasked (the rows count
    the raw wire), and its events and counters stay the JAX package's."""
    import p2p_gossip_tpu as pg
    from p2p_gossip_tpu import telemetry as jax_tel
    from p2p_gossip_tpu.engine.sync import run_sync_sim as jax_sync_sim

    calls = _spy(monkeypatch)
    jg, tg = pg.erdos_renyi(64, 0.12, seed=0), pt.erdos_renyi(64, 0.12, seed=0)
    rng = np.random.default_rng(0)
    origins = rng.integers(0, 64, 80).astype(np.int32)
    ticks = rng.integers(0, 24, 80).astype(np.int32)
    kw_j = dict(chunk_size=32, loss=pg.LinkLossModel(0.2, seed=3))
    kw_p = dict(chunk_size=32, loss=pt.LinkLossModel(0.2, seed=3))
    jax_tel.reset()
    try:
        jax_tel.configure(None, rings=True)
        telemetry.configure(None, rings=True)
        want = jax_sync_sim(jg, pg.Schedule(64, origins, ticks), 48, **kw_j)
        got = sync.run_sync_sim(tg, pt.Schedule(64, origins, ticks), 48, device="cpu", **kw_p)
        kinds = ("ring", "digest")
        want_ev = [e for e in jax_tel.events() if e["type"] in kinds]
        got_ev = [e for e in telemetry.events() if e["type"] in kinds]
    finally:
        jax_tel.reset()
    assert got.equal_counts(want)
    assert want_ev and got_ev == want_ev
    assert calls and all(seen is None and stats is None for seen, stats in calls)


@pytest.mark.parametrize("entry", ["run_sync_sim", "run_flood_coverage"])
def test_gather_counts_reach_the_stats_span(entry, monkeypatch):
    """The entry allocates the counter once a run with the span sink on and
    the rings off (on the card), hands it to every gather and puts its two
    words on its ``stats`` span; without the sink, or on the CPU, there is
    no counter."""
    g = pt.erdos_renyi(60, 0.1, seed=1)
    sched = pt.uniform_renewal_schedule(60, sim_time=1.0, tick_dt=0.01, lo=0.2, hi=0.6, seed=1)

    def run():
        if entry == "run_sync_sim":
            sync.run_sync_sim(g, sched, 100, device="cpu")
        else:
            sync.run_flood_coverage(g, [0, 9, 33], 30, device="cpu")

    dg = sync.DeviceGraph.build(g, device="cpu")
    assert sync._gather_stats(dg, False) is None  # the sink is off
    telemetry.configure(None, rings=False)
    assert sync._gather_stats(dg, False) is None  # on the CPU the kernel never runs
    made = []

    def counter(dg_, plain):
        made.append(torch.tensor([5, 7], dtype=torch.int64))
        return made[-1]

    monkeypatch.setattr(sync, "_gather_stats", counter)
    calls = _spy(monkeypatch)
    run()
    spans = [e for e in telemetry.events() if e.get("name") == "stats"]
    assert len(made) == 1 and len(spans) == 1
    assert spans[0]["attrs"] == {"gather_units_read": 5, "gather_units_pruned": 7}
    assert calls and all(stats is made[0] for _, stats in calls)


# --- on the card -------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: run on the chip")
    return torch.device("cuda", 0)


def _would_load(hist, occ, idx, mask, delay, tick, loss, b, w):
    """Units the unmasked kernel loads: every unit of each staged
    neighbour's occupied sectors (a staged neighbour: valid, kept by the
    coin, occupied)."""
    from p2p_gossip_tpu_torch.models.linkloss import drop_mask_torch

    n_units = w // 4 if w % 4 == 0 else w
    unit_words = 4 if w % 4 == 0 else 1
    sw = kernels.sector_words(w)
    units_of = torch.tensor([sum(1 for u in range(n_units) if (u * unit_words) // sw == s)
                             for s in range(32)], dtype=torch.int64)
    total = 0
    n = idx.shape[0]
    slot = torch.remainder(tick - delay.long(), hist.shape[0])
    for r in range(b):
        keep = mask.clone()
        if loss is not None:
            seed = loss[1][r].item() & 0xFFFFFFFF if b > 1 else loss[1]
            keep &= ~drop_mask_torch(idx, torch.arange(n)[:, None], tick, loss[0], seed)
        words = occ[slot, r * N + idx.long()].long() & 0xFFFFFFFF
        bits = (words[..., None] >> torch.arange(32)) & 1
        total += int(((bits * units_of).sum(-1) * keep).sum())
    return total


@pytest.mark.card
@pytest.mark.parametrize("w", [1, 3, 4, 5, 128, 300, 1024, 1027])
@pytest.mark.parametrize("opts", OPTIONS)
def test_kernel_equals_plain_with_seen_on_card(card, opts, w):
    rng = np.random.default_rng([OPTIONS.index(opts), w])
    b = 2 if opts == "replicas" else 1
    hist, occ = _ring(rng, b, w)
    idx, mask, delay = _ell(rng)
    kw = dict(replicas=b)
    if opts == "loss+up":
        kw.update(loss=(int(0.3 * 2**32), 2**31 + 7))
    elif opts == "replicas":
        seeds = np.asarray([11, 2**31 + 5], dtype=np.uint32).view(np.int32)
        kw.update(loss=(int(0.3 * 2**32), torch.as_tensor(seeds).to(card)))
    seen = _seen(rng, b * N, w)
    hist_c, occ_c, idx_c, mask_c, delay_c, seen_c = (
        t.to(card) for t in (hist, occ, idx, mask, delay, seen))
    up = torch.as_tensor(rng.random(b * N) > 0.2) if opts == "loss+up" and b == 1 else None
    stats = torch.zeros(2, dtype=torch.int64, device=card)

    def run(plain, seen_, stats_=None):
        return kernels.gather_or(hist_c, 5, idx_c, mask_c, delay_c, occ=occ_c,
                                 out=torch.full((b * N, w), -1, dtype=torch.int32, device=card),
                                 seen=seen_, stats=stats_, plain=plain,
                                 up=None if up is None else up.to(card), **kw)

    got = run(False, seen_c, stats)
    want = run(True, seen_c)
    assert torch.equal(got, want)
    assert torch.equal(run(False, seen_c), want)  # the counting-free instantiation
    assert torch.equal(run(False, None), run(True, None))  # the unmasked kernel
    read, pruned = stats.tolist()
    if up is None:  # every destination up: the counts cover the unmasked loads
        assert read + pruned == _would_load(hist, occ, idx, mask, delay, 5, kw.get("loss"),
                                            b, w)
    assert read > 0 and pruned > 0


@pytest.mark.card
@pytest.mark.parametrize("entry", ["run_sync_sim", "run_flood_coverage"])
def test_masked_runs_equal_plain_and_count_on_card(card, entry):
    g = pt.erdos_renyi(3000, 0.005, seed=1)
    sched = pt.uniform_renewal_schedule(3000, sim_time=1.0, tick_dt=0.005, lo=0.2, hi=0.6,
                                        seed=1)
    origins = np.random.default_rng(4).integers(0, g.n, 256)

    def run(plain):
        if entry == "run_sync_sim":
            return sync.run_sync_sim(g, sched, 400, device=card, plain=plain), None
        return sync.run_flood_coverage(g, origins, 64, device=card, plain=plain)

    want, want_cov = run(True)
    telemetry.configure(None, rings=False)
    got, got_cov = run(False)
    _same(got, want)
    if got_cov is not None:
        np.testing.assert_array_equal(got_cov, want_cov)
    attrs = [e["attrs"] for e in telemetry.events() if e.get("name") == "stats"][0]
    assert attrs["gather_units_read"] > 0 and attrs["gather_units_pruned"] > 0
