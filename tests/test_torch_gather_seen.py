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
two replicas. With the span sink on, the entries call the gather as with
it off.

Card (``card`` marker, skipped without one): the kernel against the plain
version with ``seen`` on ragged shapes, and whole runs against
``plain=True`` runs. On the card,
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
    seen = _seen(rng, N, 4)
    got = kernels.gather_or(hist, 0, idx, mask, uniform_slot=0, occ=occ, out=out.clone(),
                            seen=seen)
    raw = kernels.gather_or(hist, 0, idx, mask, uniform_slot=0, occ=occ, out=out.clone())
    assert torch.equal(got, raw & ~seen)


# --- the engine -------------------------------------------------------------------

def _spy(monkeypatch):
    """Record each gather_or call's keyword arguments."""
    calls = []
    gather = kernels.gather_or

    def spy(*args, **kw):
        calls.append(kw)
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
    assert calls and all(kw["seen"] is not None for kw in calls)


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
    assert calls and all(kw["seen"] is not None and kw["seen"].shape[0] == 2 * 48
                         for kw in calls)


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
    assert calls and all(kw["seen"] is None for kw in calls)


@pytest.mark.parametrize("entry", ["run_sync_sim", "run_flood_coverage"])
def test_sink_on_launches_the_timed_gather(entry, monkeypatch):
    """With telemetry's span sink on (its rings off) an entry calls the
    gather with the keywords of a run with the sink off, ``seen`` given and
    nothing counted; its ``stats`` span carries no gather counts, and its
    counters are the sink-off run's."""
    g = pt.erdos_renyi(60, 0.1, seed=1)
    sched = pt.uniform_renewal_schedule(60, sim_time=1.0, tick_dt=0.01, lo=0.2, hi=0.6, seed=1)

    def run():
        if entry == "run_sync_sim":
            return sync.run_sync_sim(g, sched, 100, device="cpu"), None
        return sync.run_flood_coverage(g, [0, 9, 33], 30, device="cpu")

    calls = _spy(monkeypatch)
    off, off_cov = run()
    off_keys = [sorted(kw) for kw in calls]
    calls.clear()
    telemetry.configure(None, rings=False)
    on, on_cov = run()
    assert off_keys and [sorted(kw) for kw in calls] == off_keys
    assert all(kw["seen"] is not None and "stats" not in kw for kw in calls)
    spans = [e for e in telemetry.events() if e.get("name") == "stats"]
    assert len(spans) == 1
    assert spans[0].get("attrs", {}) == {}  # no counts: the span times the stats only
    assert on.equal_counts(off)
    assert on.extra.get("ticks_executed") == off.extra.get("ticks_executed")
    if on_cov is not None:
        np.testing.assert_array_equal(on_cov, off_cov)


# --- on the card -------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: run on the chip")
    return torch.device("cuda", 0)


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

    def run(plain, seen_):
        return kernels.gather_or(hist_c, 5, idx_c, mask_c, delay_c, occ=occ_c,
                                 out=torch.full((b * N, w), -1, dtype=torch.int32, device=card),
                                 seen=seen_, plain=plain,
                                 up=None if up is None else up.to(card), **kw)

    assert torch.equal(run(False, seen_c), run(True, seen_c))
    assert torch.equal(run(False, None), run(True, None))  # the unmasked kernel


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
    assert [e.get("attrs", {}) for e in telemetry.events() if e.get("name") == "stats"] == [{}]
