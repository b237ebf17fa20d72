"""The flood tick's update (`engine.sync.apply_tick_updates` over
`ops.kernels.tick_update`), given the tick's generation events.

CPU: the plain path equals the dense path it replaced (the events
scattered into an (N, W) plane by `ops.bitmask.slot_scatter`, then the
torch passes) bitwise, in every output and in-place update, on single
calls and on whole runs with the engine's options; the engines call
``sync.apply_tick_updates`` by its module-level name once a tick.

Card (``card`` marker, skipped without one): the kernel against the plain
path at ragged and full sizes, whole runs against ``plain=True`` runs, one
launch a tick and no generation plane. On the card, without the JAX
package: ``python -m pytest --noconftest -p no:cacheprovider -m card
tests/test_torch_tick_update.py``. This file imports no JAX."""

import os
import sys

import numpy as np
import pytest
import torch

import p2p_gossip_tpu_torch as pt
from p2p_gossip_tpu_torch.batch import campaign
from p2p_gossip_tpu_torch.engine import sync
from p2p_gossip_tpu_torch.engine.sync import TickGenerations, apply_tick_updates
from p2p_gossip_tpu_torch.models.linkloss import LinkLossModel
from p2p_gossip_tpu_torch.ops import bitmask, kernels

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

FIELDS = ("generated", "received", "forwarded", "sent", "processed", "degree")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: run on the chip")
    return torch.device("cuda", 0)


def dense_tick_update(seen, arrivals, rows, slots, active, gen_cnt, received, sent, degree,
                      frontier, out):
    """The tick's update as the engines ran it before the events were passed
    on: the generation plane built by the caller, the live bits (zero
    before the connect tick) through the passes, the plane ORed into seen
    after them before the connect tick."""
    n, w = seen.shape
    gen_bits = bitmask.slot_scatter(n, w, rows, slots, active)
    live_bits = gen_bits if frontier else torch.zeros_like(gen_bits)
    newly = arrivals & ~seen
    newly_cnt = bitmask.popcount_rows(newly, plain=True)
    seen |= arrivals
    seen |= live_bits
    newly_out = torch.bitwise_or(newly, live_bits, out=out)
    received += newly_cnt
    sent += (newly_cnt + gen_cnt) * degree
    if not frontier:
        seen |= gen_bits
    return newly_out, newly_cnt


def _words(rng, shape, density=1.0):
    words = rng.integers(-2**31, 2**31, shape, dtype=np.int64)
    words[rng.random(shape) >= density] = 0
    return torch.as_tensor(words.astype(np.int32))


def _case(name):
    """One update's inputs: (seen, arrivals, rows, slots, active, gen_cnt,
    received, sent, degree, frontier, out given)."""
    rng = np.random.default_rng(sum(map(ord, name)))
    b, n, w, s = 1, 40, 3, 24
    if name == "w1":
        w, s = 1, 20
    if name == "stacked":
        b = 3
    rows_n = b * n
    seen = _words(rng, (rows_n, w), 0.3)
    arrivals = _words(rng, (rows_n, w), 0.5)
    origins = rng.integers(0, n, s)
    rows = (origins[None, :] + np.arange(b)[:, None] * n).reshape(-1)
    slots = np.tile(rng.permutation(32 * w)[:s], b)
    active = rng.random(b * s) < 0.5
    if name == "bit31":
        slots[:3] = [31, 63, 95 % (32 * w)]
        active[:3] = True
    if name == "shared_word":  # three events, one word of one row
        rows[:3], slots[:3], active[:3] = rows[0], [0, 5, 31], True
    if name == "inactive":
        active[:] = False
    if name == "out_of_range":
        rows[:2], active[:2] = [-1, rows_n], True
    degree = rng.integers(0, 200, rows_n)
    received = rng.integers(0, 1000, rows_n)
    sent = rng.integers(0, 10**6, rows_n)
    if name == "wrap":  # both counters driven past 2^31 - 1
        received = np.full(rows_n, 2**31 - 3)
        sent = np.full(rows_n, 2**31 - 5)
        degree = np.full(rows_n, 10**6)
        arrivals = _words(rng, (rows_n, w), 1.0)
    gen_cnt = np.bincount(rows[active & (rows >= 0) & (rows < rows_n)], minlength=rows_n)
    if name == "pre_connect":
        gen_cnt[:] = 0  # the engines charge no generation before the connect tick
    i32 = lambda a: torch.as_tensor(np.asarray(a, dtype=np.int64).astype(np.int32))  # noqa: E731
    return (seen, arrivals, torch.as_tensor(rows), torch.as_tensor(slots),
            torch.as_tensor(active), i32(gen_cnt), i32(received), i32(sent), i32(degree),
            name != "pre_connect", name != "out_none")


CASES = ("plain", "bit31", "shared_word", "inactive", "out_of_range", "stacked",
         "pre_connect", "wrap", "out_none", "w1")


@pytest.mark.parametrize("name", CASES)
def test_events_equal_the_dense_plane(name):
    seen, arrivals, rows, slots, active, gen_cnt, received, sent, degree, frontier, has_out \
        = _case(name)
    state = [(seen.clone(), received.clone(), sent.clone()) for _ in range(2)]
    outs = [torch.full_like(seen, 7) if has_out else None for _ in range(2)]
    got = apply_tick_updates(state[0][0], arrivals, TickGenerations(rows, slots, active,
                                                                    frontier),
                             gen_cnt, state[0][1], state[0][2], degree, out=outs[0])
    want = dense_tick_update(state[1][0], arrivals, rows, slots, active, gen_cnt,
                             state[1][1], state[1][2], degree, frontier, outs[1])
    assert got[0] is state[0][0] and got[2] is state[0][1] and got[3] is state[0][2]
    assert not has_out or got[1] is outs[0]
    for a, b in zip((got[1], got[4]) + state[0], want + state[1]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    if name == "wrap":  # the int32 counters wrap: exact modulo 2^32
        cnt = got[4].to(torch.int64)
        want_recv = (2**31 - 3 + cnt) % 2**32
        want_sent = (2**31 - 5 + (cnt + gen_cnt) * 10**6) % 2**32
        assert torch.equal(state[0][1].to(torch.int64) % 2**32, want_recv)
        assert torch.equal(state[0][2].to(torch.int64) % 2**32, want_sent)
        assert (state[0][1] < 0).any() and (state[0][2] < 0).any()


def _graph_and_schedule(n=60, p=0.12, sim_time=2.0, seed=3):
    g = pt.erdos_renyi(n, p, seed=seed)
    sched = pt.uniform_renewal_schedule(n, sim_time=sim_time, tick_dt=0.005, lo=0.2, hi=0.6,
                                        seed=seed)
    return g, sched


RUNS = {
    "plain": {},
    "connect": dict(connect_tick=100),  # 45 of the 277 generations before it
    "churn_loss": dict(churn="churn", loss="loss"),
}


def _run_kwargs(name, n, horizon):
    kw = dict(RUNS[name])
    if kw.get("churn"):
        kw["churn"] = pt.random_churn(n, horizon, outage_prob=0.3, mean_down_ticks=20, seed=5)
    if kw.get("loss"):
        kw["loss"] = LinkLossModel(0.1, seed=9)
    return kw


def _same(a, b):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    assert a.extra.get("ticks_executed") == b.extra.get("ticks_executed")


@pytest.mark.parametrize("name", sorted(RUNS))
def test_whole_runs_equal_the_dense_plane(name, monkeypatch):
    """Every tick of a flood and a coverage run through the events equals
    the same run with the dense plane in place of the events."""
    g, sched = _graph_and_schedule()
    horizon = 500
    kw = _run_kwargs(name, g.n, horizon)
    got = sync.run_sync_sim(g, sched, horizon, device="cpu", **kw)
    cov_kw = {k: v for k, v in kw.items() if k != "connect_tick"}
    origins = np.random.default_rng(2).integers(0, g.n, 8)
    got_cov = sync.run_flood_coverage(g, origins, 40, device="cpu", **cov_kw)
    monkeypatch.setattr(kernels, "tick_update_plain", dense_tick_update)
    want = sync.run_sync_sim(g, sched, horizon, device="cpu", **kw)
    want_cov = sync.run_flood_coverage(g, origins, 40, device="cpu", **cov_kw)
    _same(got, want)
    _same(got_cov[0], want_cov[0])
    np.testing.assert_array_equal(got_cov[1], want_cov[1])
    assert got.totals()["processed"] > 0


def test_campaign_batch_equals_the_dense_plane(monkeypatch):
    """B = 3 stacked replicas: stacked rows, a per-row degree."""
    g, _ = _graph_and_schedule()
    reps = campaign.flood_replicas(g, 8, np.arange(3) + 11, 40)
    got = campaign.run_coverage_campaign(g, reps, 40, device="cpu")
    monkeypatch.setattr(kernels, "tick_update_plain", dense_tick_update)
    want = campaign.run_coverage_campaign(g, reps, 40, device="cpu")
    for key in ("received", "sent", "coverage"):
        np.testing.assert_array_equal(getattr(got, key), getattr(want, key))


@pytest.mark.parametrize("entry", ["run_sync_sim", "run_flood_coverage"])
def test_one_module_level_call_a_tick(entry, monkeypatch):
    """The ticks reach the update through ``sync.apply_tick_updates``, the
    name the benchmark's fault injection replaces, once a tick."""
    calls = []
    orig = sync.apply_tick_updates

    def counting(seen, arrivals, gen_bits, gen_cnt, received, sent, degree, *, out=None,
                 plain=False):
        calls.append(isinstance(gen_bits, TickGenerations))
        return orig(seen, arrivals, gen_bits, gen_cnt, received, sent, degree, out=out,
                    plain=plain)

    monkeypatch.setattr(sync, "apply_tick_updates", counting)
    g, sched = _graph_and_schedule()
    if entry == "run_sync_sim":
        ticks = sync.run_sync_sim(g, sched, 500, device="cpu").extra["ticks_executed"]
    else:
        covered = []
        cov = bitmask.coverage_per_slot
        monkeypatch.setattr(bitmask, "coverage_per_slot",
                            lambda *a, **k: covered.append(1) or cov(*a, **k))
        sync.run_flood_coverage(g, np.arange(8) * 7, 40, device="cpu")
        ticks = len(covered)
    assert ticks > 0 and len(calls) == ticks and all(calls)


# --- on the card ---------------------------------------------------------------

CARD_SHAPES = ((777, 3), (1000, 1), (513, 4), (100_000, 1024), (1_000_000, 128))


@pytest.mark.card
@pytest.mark.parametrize("sparse", [None, chip_smoke.TICK_UPDATE_SPARSE], ids=["dense", "sparse"])
@pytest.mark.parametrize("n,w", CARD_SHAPES)
def test_kernel_equals_plain_on_card(card, n, w, sparse):
    rng = np.random.default_rng(n + w)
    case = chip_smoke.tick_update_inputs(rng, n, w, min(32 * w, 32_768), card, sparse)
    kernels.reset_launches()
    for frontier in (True, False):
        assert chip_smoke.check_tick_update_case(f"({n}, {w})", case, frontier) == 0
    torch.cuda.synchronize()
    assert kernels.launches["tick_update"] == 2


@pytest.mark.card
@pytest.mark.parametrize("entry", ["run_sync_sim", "run_flood_coverage"])
def test_whole_runs_on_card(card, entry, monkeypatch):
    """A run on the card equals its ``plain=True`` run; the kernel launches
    once a tick and no generation plane is built."""
    g = pt.erdos_renyi(3000, 0.005, seed=1)
    sched = pt.uniform_renewal_schedule(3000, sim_time=1.0, tick_dt=0.005, lo=0.2, hi=0.6,
                                        seed=1)
    scattered = []
    scatter = bitmask.slot_scatter
    monkeypatch.setattr(bitmask, "slot_scatter",
                        lambda *a, **k: scattered.append(1) or scatter(*a, **k))

    def run(plain):
        kernels.reset_launches()
        scattered.clear()
        if entry == "run_sync_sim":
            stats = sync.run_sync_sim(g, sched, 400, device=card, plain=plain)
            ticks = stats.extra["ticks_executed"]
            cov = None
        else:
            origins = np.random.default_rng(4).integers(0, g.n, 256)
            stats, cov = sync.run_flood_coverage(g, origins, 64, device=card, plain=plain)
            ticks = kernels.launches["coverage_per_slot"] if not plain else len(scattered)
        torch.cuda.synchronize()
        return stats, cov, ticks, dict(kernels.launches), len(scattered)

    got, got_cov, ticks, launches, planes = run(False)
    want, want_cov, plain_ticks, plain_launches, plain_planes = run(True)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    if got_cov is not None:
        np.testing.assert_array_equal(got_cov, want_cov)
    assert ticks > 0 and launches["tick_update"] == ticks and planes == 0
    assert launches["popcount_rows"] == 0
    assert plain_launches["tick_update"] == 0 and plain_planes == plain_ticks == ticks
