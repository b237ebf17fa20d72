"""Campaign telemetry of the port (``p2p_gossip_tpu_torch.batch`` with the
rings on) against the JAX package's: the coverage, gossip and protocol
campaigns' ``ring`` and ``digest`` events equal the JAX campaigns' value
for value, ``replica``, ``seed`` and the progress beats' ``digest_head``
included (every op is integer: the tolerance is bitwise); replica r's
events equal the port's solo telemetry-on run with its seeds; results with
the rings on equal results with them off. Also the batched ``tick_digest``
(its plain version against the per-replica fold and the numpy twin on
ragged shapes) and the batched row builders, which make no host copy.

The port runs on the CPU (its kernels' plain torch versions), the JAX
package on the CPU as its own tests run it."""

import numpy as np
import pytest
import torch

import p2p_gossip_tpu as pg
import p2p_gossip_tpu_torch as pt
from p2p_gossip_tpu import telemetry as jax_tel
from p2p_gossip_tpu.batch import campaign as jc
from p2p_gossip_tpu.models import seeds as jseeds
from p2p_gossip_tpu.telemetry import digest as jax_digest
from p2p_gossip_tpu_torch import telemetry
from p2p_gossip_tpu_torch.batch import campaign as tc
from p2p_gossip_tpu_torch.engine.sync import run_flood_coverage, run_sync_sim
from p2p_gossip_tpu_torch.models import seeds as tseeds
from p2p_gossip_tpu_torch.models.protocols import run_pushk_sim, run_pushpull_sim
from p2p_gossip_tpu_torch.ops import kernels
from p2p_gossip_tpu_torch.telemetry import digest, rings

N, P, HORIZON = 48, 0.12, 24
SEEDS = [3, 4, 5, 6, 7]
U32 = 0xFFFFFFFF


@pytest.fixture(autouse=True)
def _clean_telemetry(monkeypatch):
    monkeypatch.delenv("P2P_TELEMETRY", raising=False)
    monkeypatch.delenv("P2P_HEARTBEAT", raising=False)
    for tel in (telemetry, jax_tel):
        tel.reset()
        tel.configure_heartbeat(None)
    yield
    for tel in (telemetry, jax_tel):
        tel.reset()
        tel.configure_heartbeat(None)


def _graphs():
    return pg.erdos_renyi(N, P, seed=1), pt.erdos_renyi(N, P, seed=1)


def _port_set(rs):
    return tc.ReplicaSet(n=rs.n, origins=rs.origins, gen_ticks=rs.gen_ticks,
                         seeds=rs.seeds, churn=rs.churn)


def _events(tel):
    """(ring and digest events, the progress beats' digest heads)."""
    evs = tel.events()
    return ([e for e in evs if e["type"] in ("ring", "digest")],
            [e.get("digest_head") for e in evs if e["type"] == "progress"])


# (kind, option set): the flood's coverage and multi-chunk gossip campaigns
# and the three protocols, plain and under churn + per-replica loss.
CASES = [
    ("coverage", "plain"), ("coverage", "churn+loss"), ("gossip", "plain"),
    ("gossip", "churn+loss"), ("pushpull", "plain"), ("pushpull", "churn+loss"),
    ("pull", "churn+loss"), ("pushk", "churn+loss"),
]


def _run(pkg, kind, opts, graph, rs):
    """One campaign of ``kind`` in package ``pkg`` (R = 5 in batches of 2:
    the last batch padded with a sentinel replica)."""
    mod = jc if pkg == "jax" else tc
    kw = dict(batch_size=2)
    if pkg == "port":
        kw["device"] = "cpu"
        rs = _port_set(rs)
    if "loss" in opts:
        model = pg.LinkLossModel if pkg == "jax" else pt.LinkLossModel
        kw.update(loss=model(0.2, seed=9), loss_seeds=jseeds.replica_loss_seeds(SEEDS))
    if kind == "coverage":
        return mod.run_coverage_campaign(graph, rs, HORIZON, **kw)
    if kind == "gossip":
        return mod.run_gossip_campaign(graph, rs, 30, chunk_size=32, **kw)
    return mod.run_protocol_campaign(graph, rs, HORIZON, protocol=kind, fanout=2, **kw)


def _replicas(kind, opts, jg):
    churn = dict(churn_prob=0.3, mean_down_ticks=3) if "churn" in opts else {}
    if kind == "gossip":
        rs = jc.gossip_replicas(jg, 0.15, 0.005, SEEDS, 30, gen_lo=0.03, gen_hi=0.06, **churn)
        assert rs.shares_per_replica > 64  # three or more 32-share chunks
        return rs
    return jc.flood_replicas(jg, 5, SEEDS, HORIZON, **churn)


@pytest.mark.parametrize("kind,opts", CASES)
def test_campaign_events_equal_the_jax_packages(kind, opts):
    jg, tg = _graphs()
    rs = _replicas(kind, opts, jg)
    jax_tel.configure(None, rings=True)
    telemetry.configure(None, rings=True)
    want_res = _run("jax", kind, opts, jg, rs)
    got_res = _run("port", kind, opts, tg, rs)
    want, want_heads = _events(jax_tel)
    got, got_heads = _events(telemetry)
    assert want and len(got) == len(want)
    for w, g in zip(want, got):
        assert g == w, (w["type"], w.get("replica"), w.get("chunk"))
    # One ring and one digest event per live replica and chunk, sentinel
    # replica 5 of the third batch emitting nothing.
    assert sorted({e["replica"] for e in got}) == list(range(len(SEEDS)))
    assert {e["seed"] for e in got} == set(SEEDS)
    assert got_heads == want_heads and any(h is not None for h in got_heads)
    for key in ("received", "sent"):
        np.testing.assert_array_equal(getattr(got_res, key), getattr(want_res, key))


@pytest.mark.parametrize("kind", ["coverage", "gossip", "pushpull", "pushk"])
def test_rings_leave_campaign_results_unchanged(kind):
    _, tg = _graphs()
    jg, _ = _graphs()
    rs = _replicas(kind, "churn+loss", jg)
    off = _run("port", kind, "churn+loss", tg, rs)
    telemetry.configure(None, rings=True)
    on = _run("port", kind, "churn+loss", tg, rs)
    for key in ("received", "sent", "coverage"):
        a, b = getattr(on, key), getattr(off, key)
        if b is None:
            assert a is None
        else:
            np.testing.assert_array_equal(a, b)
    rec = telemetry.events()
    for r in range(len(SEEDS)):
        newly = sum(sum(e["metrics"]["newly_infected"]) for e in rec
                    if e["type"] == "ring" and e["replica"] == r)
        assert newly == int(off.received[r].sum())


def _by_tick(event, key):
    """{absolute tick: value} of a ring column or a digest stream."""
    values = event["values"] if key is None else event["metrics"][key]
    return {event["t0"] + i: v for i, v in enumerate(values)}


@pytest.mark.parametrize("kind", ["coverage", "gossip", "pushpull", "pushk"])
def test_replica_events_equal_the_ports_solo_runs(kind):
    """Replica r's ring rows equal its solo run's tick for tick (a batch
    runs on to its slowest replica, and r's rows past its own quiescence
    are zero), and its digests equal the solo digests over every tick the
    solo run executed (past them, r's digest holds its final state's)."""
    _, tg = _graphs()
    horizon = 30 if kind == "gossip" else HORIZON
    churn = dict(churn_prob=0.3, mean_down_ticks=3)
    if kind == "gossip":
        rs = tc.gossip_replicas(tg, 0.15, 0.005, SEEDS, horizon, 0.03, 0.06, **churn)
    else:
        rs = tc.flood_replicas(tg, 5, SEEDS, horizon, **churn)
    kw = dict(loss=pt.LinkLossModel(0.2, seed=0),
              loss_seeds=tseeds.replica_loss_seeds(SEEDS), batch_size=2, device="cpu")
    telemetry.configure(None, rings=True)
    if kind == "coverage":
        tc.run_coverage_campaign(tg, rs, horizon, **kw)
    elif kind == "gossip":
        tc.run_gossip_campaign(tg, rs, horizon, chunk_size=4096, **kw)
    else:
        tc.run_protocol_campaign(tg, rs, horizon, protocol=kind, **kw)
    camp = [e for e in telemetry.events() if e["type"] in ("ring", "digest")]
    for r, seed in enumerate(SEEDS):
        telemetry.reset()
        telemetry.configure(None, rings=True)
        loss = pt.LinkLossModel(0.2, seed=tseeds.loss_stream_seed(seed))
        churn_r, sched = rs.replica_churn(r), rs.replica_schedule(r, horizon)
        if kind == "coverage":
            run_flood_coverage(tg, rs.origins[r], horizon, churn=churn_r, loss=loss,
                               chunk_size=32, device="cpu")
        elif kind == "gossip":
            run_sync_sim(tg, sched, horizon, churn=churn_r, loss=loss, device="cpu")
        else:
            run = run_pushpull_sim if kind == "pushpull" else run_pushk_sim
            run(tg, sched, horizon, seed=seed, churn=churn_r, loss=loss,
                record_coverage=True, device="cpu")
        solo = {e["type"]: e for e in telemetry.events() if e["type"] in ("ring", "digest")}
        mine = {e["type"]: e for e in camp if e["replica"] == r}
        assert mine["ring"]["seed"] == mine["digest"]["seed"] == seed
        for col in telemetry.METRIC_COLUMNS:
            want, got = _by_tick(solo["ring"], col), _by_tick(mine["ring"], col)
            for t in set(want) | set(got):
                assert got.get(t, 0) == want.get(t, 0), (r, col, t)
        # The solo run's executed ticks: its digests up to the last nonzero
        # one (the slots past its exit stay zero).
        want, got = _by_tick(solo["digest"], None), _by_tick(mine["digest"], None)
        last = max(t for t, v in want.items() if v)
        assert all(got[t] == v for t, v in want.items() if t <= last), r


# --- the batched tick_digest ------------------------------------------------------

def _stacked_state(rng, b, n, w, with_hi):
    seen = rng.integers(0, 2**32, (b * n, w), dtype=np.uint32)
    seen[rng.random((b * n, w)) < 0.3] = 0
    counters = [rng.integers(-2**31, 2**31, b * n).astype(np.int32) for _ in range(2)]
    for c in counters:
        c[rng.random(b * n) < 0.3] = 0
    hi = rng.integers(0, 7, b * n).astype(np.int32) if with_hi else None
    return seen, counters[0], counters[1], hi


@pytest.mark.parametrize("b,n,w", [(1, 13, 3), (3, 37, 5), (8, 9, 4), (3, 1, 1), (2, 20, 0)])
@pytest.mark.parametrize("with_hi", [False, True])
def test_batched_digest_equals_the_per_replica_fold(b, n, w, with_hi):
    """Replica r's slot holds the digest of its own rows salted by node id
    (the numpy twin and the JAX fold of rows r*N.. r*N+N-1), whatever
    stride the slots have; B = 1 is the solo call."""
    rng = np.random.default_rng(b * 100 + n * 10 + w)
    seen, received, sent_lo, hi = _stacked_state(rng, b, n, w, with_hi)
    want = []
    for r in range(b):
        part = slice(r * n, (r + 1) * n)
        one = digest.tick_digest_np(seen[part], received[part], sent_lo[part],
                                    None if hi is None else hi[part])
        assert one == int(jax_digest.tick_digest_np(
            seen[part], received[part], sent_lo[part], None if hi is None else hi[part]))
        want.append(one)
    args = [torch.as_tensor(seen.view(np.int32)), torch.as_tensor(received),
            torch.as_tensor(sent_lo), None if hi is None else torch.as_tensor(hi)]
    plain = kernels.tick_digest_plain(*args, replicas=b)
    assert plain.shape == (b,) and plain.tolist() == want
    ring = digest.init_batched(b, 4, "cpu")
    digest.write_batched(ring, 2, *args)
    assert [v & U32 for v in ring[:, 2].tolist()] == want
    assert not ring[:, [0, 1, 3]].any()
    if b == 1:
        solo = kernels.tick_digest(*args)
        assert int(solo[0]) & U32 == want[0]


def test_batched_digest_argument_checks():
    seen = torch.ones((6, 2), dtype=torch.int32)
    cnt = torch.zeros(6, dtype=torch.int32)
    with pytest.raises(ValueError, match="replicas"):
        kernels.tick_digest(seen, cnt, cnt, replicas=4)
    with pytest.raises(ValueError, match="out must be"):
        kernels.tick_digest(seen, cnt, cnt, replicas=3, out=torch.zeros(2, dtype=torch.int32))
    kernels.reset_launches()
    out = kernels.tick_digest(seen, cnt, cnt, replicas=3)
    assert out.shape == (3,) and kernels.launches["tick_digest"] == 0


# --- the batched row builders -------------------------------------------------------

def test_batched_flood_row_equals_each_replicas_solo_row():
    """`flood_row` on a (B, capacity, M) ring writes row t of each replica
    from the stacked state, equal to the row each replica's own (N, W)
    state writes into a solo ring."""
    rng = np.random.default_rng(4)
    b, n, w = 3, 11, 2

    def words(shape):
        return torch.as_tensor(rng.integers(0, 2**32, shape, dtype=np.uint32).view(np.int32))

    arrivals, newly, lossless = words((b * n, w)), words((b * n, w)), words((b * n, w))
    delta = torch.as_tensor(rng.integers(0, 5, b * n).astype(np.int32))
    degree = torch.as_tensor(rng.integers(0, 9, b * n).astype(np.int32))
    met, _ = rings.chunk_rings(6, "cpu", b)
    rings.flood_row(met, 4, arrivals, newly, delta, degree, lossless)
    for r in range(b):
        part = slice(r * n, (r + 1) * n)
        solo, _ = rings.chunk_rings(6, "cpu")
        rings.flood_row(solo, 4, arrivals[part], newly[part], delta[part], degree[part],
                        lossless[part])
        assert torch.equal(met[r], solo)
    assert met[:, 4, 0].tolist() == [
        int(kernels.popcount_rows(newly[r * n:(r + 1) * n]).sum()) for r in range(b)]


def test_batched_rows_make_no_host_copy(monkeypatch):
    """With the rings on, a campaign's ticks and rounds write their rows and
    digests with no host-to-device copy: `torch.as_tensor` and
    `torch.tensor` raise inside the row builders and the digest."""
    _, tg = _graphs()
    jg, _ = _graphs()
    rs = _replicas("coverage", "churn+loss", jg)
    telemetry.configure(None, rings=True)

    def refuse(*args, **kwargs):
        raise AssertionError("host copy in a per-tick telemetry path")

    for module, names in ((rings, ("row", "flood_row", "u32sum", "total_bits", "write_batched")),
                          (digest, ("write", "write_batched"))):
        for name in names:
            fn = getattr(module, name)

            def guarded(*args, _fn=fn, **kwargs):
                with monkeypatch.context() as m:
                    m.setattr(torch, "as_tensor", refuse)
                    m.setattr(torch, "tensor", refuse)
                    return _fn(*args, **kwargs)

            monkeypatch.setattr(module, name, guarded)
    for kind in ("coverage", "pushpull"):
        _run("port", kind, "churn+loss", tg, rs)
    assert sum(e["type"] == "ring" for e in telemetry.events()) == 2 * len(SEEDS)
