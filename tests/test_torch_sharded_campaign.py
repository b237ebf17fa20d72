"""The port's sharded campaigns (``p2p_gossip_tpu_torch.batch.campaign_sharded``)
and the campaign runners' ``mesh=`` on gloo ranks of the CPU, against the
JAX package's on the 8-virtual-device CPU mesh of the same shape: bitwise
(integer ops, tolerance 0) on every replica's counters and coverage rows,
``extra['mesh' | 'ring' | 'exchange']`` and telemetry events, for every
(replicas x nodes) split, exchange and async spelling, with churn and
loss (one seed a replica, or the cell's one); checkpoints either package
resumes; batch rounding with sentinel replicas; the mesh's factorization.

One world of 4 spawned ranks (`parallel.launch.spawn`) runs every case of
this module, each on its factorized mesh over the world's first ranks,
while threads of this process run the JAX references; the parametrised
tests read both. The workers import only the port."""

import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import jax

import p2p_gossip_tpu as pg
from p2p_gossip_tpu import telemetry as jax_tel
from p2p_gossip_tpu.batch import campaign as jc
from p2p_gossip_tpu.batch import campaign_sharded as jcs
from p2p_gossip_tpu.batch.stats import ensemble_summary as jax_summary
from p2p_gossip_tpu.models.latency import lognormal_delays as jax_lognormal
from p2p_gossip_tpu.parallel.mesh import make_mesh as jax_mesh

import p2p_gossip_tpu_torch as pt
from p2p_gossip_tpu_torch.batch import campaign as tc
from p2p_gossip_tpu_torch.batch import campaign_sharded as tcs
from p2p_gossip_tpu_torch.batch.stats import ensemble_summary
from p2p_gossip_tpu_torch.models.latency import lognormal_delays
from p2p_gossip_tpu_torch.parallel import launch
from p2p_gossip_tpu_torch.parallel.mesh import auto_axis_split, campaign_node_bytes

CAMP = "p2p_gossip_tpu_torch.batch.campaign_sharded:run_sharded_campaign"
PCAMP = "p2p_gossip_tpu_torch.batch.campaign_sharded:run_sharded_protocol_campaign"
MESHED = "p2p_gossip_tpu_torch.batch.campaign:run_{}_campaign"
HORIZON, P_HORIZON = 40, 12
LOSS_SEEDS = [1001, 1002, 1003, 1004]


def _sets(pkg_campaign, graph, *, R=4, S=10, horizon=HORIZON, seed=11, churn=False):
    """The JAX test's replica set: uneven live shares (replica R-1's last
    three are sentinels), per-replica churn intervals when asked."""
    rng = np.random.default_rng(seed)
    origins = rng.integers(0, graph.n, size=(R, S)).astype(np.int32)
    gen_ticks = rng.integers(0, 6, size=(R, S)).astype(np.int32)
    gen_ticks[-1, S - 3:] = horizon
    ch = None
    if churn:
        cs = rng.integers(0, 10, size=(R, graph.n, 2)).astype(np.int32)
        ce = cs + rng.integers(0, 6, size=(R, graph.n, 2)).astype(np.int32)
        ch = (cs, ce)
    return pkg_campaign.ReplicaSet(graph.n, origins, gen_ticks,
                                   np.arange(300, 300 + R, dtype=np.int64), churn=ch)


def _inputs(pkg, pkg_campaign, lognormal):
    g = pkg.erdos_renyi(72, 0.08, seed=4)
    g_small = pkg.erdos_renyi(64, 0.1, seed=5)
    four = _sets(pkg_campaign, g)
    return dict(
        g=g, g_small=g_small, plain=four, churn=_sets(pkg_campaign, g, churn=True),
        pchurn=_sets(pkg_campaign, g, churn=True, horizon=P_HORIZON),
        two=_sets(pkg_campaign, g, R=2, horizon=32),
        three=pkg_campaign.ReplicaSet(g.n, four.origins[:3], four.gen_ticks[:3],
                                      four.seeds[:3]),
        cover=pkg_campaign.flood_replicas(g, 6, [41, 42, 43, 44], 32),
        meshed=pkg_campaign.flood_replicas(g_small, 2, list(range(5)), 16, churn_prob=0.2),
        loss=pkg.LinkLossModel(0.2, seed=77),
        shared_loss=pkg.LinkLossModel(0.3, seed=9),
        ploss=pkg.LinkLossModel(0.25, seed=3),
        delays=lognormal(g, mean_ticks=2.0, sigma=0.5, max_ticks=4, seed=2),
    )


NODE_BYTES = campaign_node_bytes(72, 72 * 8, 10)

# (name, mesh kwargs, target, replica set, horizon, kwargs by input name)
FLOOD = [
    ("dense-1x4", dict(replicas=1), "plain", HORIZON, {}),
    ("dense-2x2", dict(replicas=2), "plain", HORIZON, {}),
    ("dense-4x1", dict(replicas=4), "plain", HORIZON, {}),
    ("auto-4x1", dict(replicas="auto", node_bytes=NODE_BYTES, hbm_bytes=NODE_BYTES),
     "plain", HORIZON, {}),
    ("delta-loss-churn-2x2", dict(replicas=2), "churn", HORIZON,
     dict(loss="loss", loss_seeds=LOSS_SEEDS, ring_mode="sharded", exchange="delta")),
    ("delta-loss-churn-1x4", dict(replicas=1), "churn", HORIZON,
     dict(loss="loss", loss_seeds=LOSS_SEEDS, exchange="delta")),
    ("hub-coverage-2x2", dict(replicas=2), "churn", HORIZON,
     dict(exchange="hub", hub_rows=4, record_coverage=True)),
    ("async-1x4", dict(replicas=1), "plain", HORIZON, dict(exchange="async", async_k=2)),
    ("async-dense-2x2", dict(replicas=2), "churn", HORIZON,
     dict(exchange="async-dense", async_k=2, loss="loss")),
    ("shared-loss-2x2", dict(replicas=2), "two", 32, dict(loss="shared_loss")),
    ("coverage-2x2", dict(replicas=2), "cover", 32, dict(record_coverage=True)),
    ("rounding-2x2", dict(replicas=2), "three", HORIZON, {}),
    ("lognormal-async-delta-2x2", dict(replicas=2), "churn", HORIZON,
     dict(ell_delays="delays", exchange="async-delta", async_k=2, loss="loss",
          loss_seeds=LOSS_SEEDS, record_coverage=True)),
    ("lognormal-replicated-1x4", dict(replicas=1), "plain", HORIZON,
     dict(ell_delays="delays", ring_mode="replicated")),
]
PROTOCOL = [
    (f"pushpull-{ex}", dict(replicas=2), "pchurn", P_HORIZON,
     dict(protocol="pushpull", loss="ploss", loss_seeds=LOSS_SEEDS, record_coverage=True,
          exchange=ex, **({"hub_rows": 4} if ex == "hub" else {})))
    for ex in ("dense", "delta", "hub", "auto", "async", "async-dense", "async-delta")
] + [
    ("pull-delta-1x4", dict(replicas=1), "pchurn", P_HORIZON,
     dict(protocol="pull", loss="ploss", exchange="delta")),
    ("pushk-sharded-4x1", dict(replicas=4), "pchurn", P_HORIZON,
     dict(protocol="pushk", fanout=2, ring_mode="sharded", loss="ploss",
          loss_seeds=LOSS_SEEDS)),
    ("pushk-replicated-1x4", dict(replicas=1), "pchurn", P_HORIZON,
     dict(protocol="pushk", fanout=3, ring_mode="replicated")),
    ("pushpull-lognormal-sharded-1x4", dict(replicas=1), "pchurn", P_HORIZON,
     dict(protocol="pushpull", ell_delays="delays", ring_mode="sharded",
          record_coverage=True)),
    ("pull-lognormal-replicated-2x2", dict(replicas=2), "pchurn", P_HORIZON,
     dict(protocol="pull", ell_delays="delays", ring_mode="replicated", loss="ploss",
          loss_seeds=LOSS_SEEDS)),
]
# Telemetry-on runs: (name, mesh kwargs, target kind, set, horizon, kwargs).
TELEMETRY = [
    ("tel-flood-2x2", dict(replicas=2), "plain", HORIZON, dict(exchange="delta")),
    ("tel-pushpull-2x2", dict(replicas=2), "pchurn", P_HORIZON,
     dict(protocol="pushpull", loss="ploss", exchange="async-delta")),
]
# The mesh= runners on a (shares, nodes) = (2, 2) mesh of the 4 ranks.
MESHED_RUNS = [("coverage", {}), ("gossip", dict(chunk_size=32)),
               ("protocol", dict(protocol="pushpull"))]
MATRIX = FLOOD + PROTOCOL
# The protocol campaign the port resumes from JAX's checkpoint (1 x 4).
PROTOCOL_RESUME = dict(protocol="pull", exchange="delta", loss="ploss", batch_size=2)


def _resolve(h, kwargs):
    """A case's kwargs with its ``loss`` and ``ell_delays`` named by input."""
    return {k: h[v] if k in ("loss", "ell_delays") else v for k, v in kwargs.items()}


def _target(kwargs):
    return PCAMP if "protocol" in kwargs else CAMP


def _dims(mesh_kw):
    """(replica shards, node shards) of a case's mesh on 4 ranks."""
    if mesh_kw["replicas"] == "auto":
        return auto_axis_split(4, mesh_kw["node_bytes"], mesh_kw["hbm_bytes"])
    return mesh_kw["replicas"], 4 // mesh_kw["replicas"]


def _cases(h, tmp):
    """(mesh kwargs, target, args, kwargs[, events]) of every world call,
    and their names."""
    names, calls = [], []
    for name, mesh_kw, set_name, horizon, kw in MATRIX:
        names.append(name)
        calls.append((mesh_kw, _target(kw), (h["g"], h[set_name], horizon), _resolve(h, kw)))
    for name, mesh_kw, set_name, horizon, kw in TELEMETRY:
        names.append(name)
        calls.append((mesh_kw, _target(kw), (h["g"], h[set_name], horizon), _resolve(h, kw),
                      True))
    names += ["superset", "too-few", "resume", "write", "resume-protocol"]
    calls += [
        (dict(replicas=2), CAMP, (h["g"], h["plain"], HORIZON), {}),
        (dict(n_node_shards=4, replicas=2), CAMP, (h["g"], h["plain"], HORIZON), {}),
        (dict(replicas=2), CAMP, (h["g"], h["plain"], 32),
         dict(batch_size=2, checkpoint_path=str(tmp / "jax.npz"))),
        (dict(replicas=2), CAMP, (h["g"], h["plain"], 32),
         dict(batch_size=2, checkpoint_path=str(tmp / "port.npz"), stop_after_batches=1)),
        (dict(replicas=1), PCAMP, (h["g"], h["pchurn"], P_HORIZON),
         _resolve(h, dict(PROTOCOL_RESUME, checkpoint_path=str(tmp / "jax-protocol.npz")))),
    ]
    return names, calls


def _jax_run(h, mesh_kw, set_name, horizon, kw, **extra):
    r, n = _dims(mesh_kw)
    mesh = jax_mesh(n, devices=jax.devices("cpu")[:r * n], replicas=r)
    fn = jcs.run_sharded_protocol_campaign if "protocol" in kw else jcs.run_sharded_campaign
    return fn(h["g"], h[set_name], horizon, mesh, **_resolve(h, kw), **extra)


def _jax_events(h, case):
    _, mesh_kw, set_name, horizon, kw = case
    jax_tel.reset()
    jax_tel.configure(None, rings=True)
    try:
        _jax_run(h, mesh_kw, set_name, horizon, kw)
        return jax_tel.events()
    finally:
        jax_tel.reset()


def _jax_meshed(h, kind, kw):
    fn = getattr(jc, f"run_{kind}_campaign")
    return fn(h["g_small"], h["meshed"], 16, mesh=jax_mesh(2, 4), **kw)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case's results, rank by rank, from one world of 4 ranks, and
    the JAX references, run in this process meanwhile. The JAX checkpoint
    the port resumes is written first."""
    tmp = tmp_path_factory.mktemp("sharded_campaign")
    hj = _inputs(pg, jc, jax_lognormal)
    _jax_run(hj, dict(replicas=2), "plain", 32, {}, batch_size=2,
             checkpoint_path=str(tmp / "jax.npz"), stop_after_batches=1)
    _jax_run(hj, dict(replicas=1), "pchurn", P_HORIZON, PROTOCOL_RESUME,
             checkpoint_path=str(tmp / "jax-protocol.npz"), stop_after_batches=1)
    # The event runs first: the JAX sink is global, the matrix's runs share it.
    want = {case[0]: _jax_events(hj, case) for case in TELEMETRY}
    ht = _inputs(pt, tc, lognormal_delays)
    names, calls = _cases(ht, tmp)
    meshed = [((2, 2) + (MESHED.format(kind), (ht["g_small"], ht["meshed"], 16), kw))
              for kind, kw in MESHED_RUNS]
    with ThreadPoolExecutor(4) as pool:
        world = pool.submit(launch.spawn, _world, 4, calls, meshed, timeout_s=120.0)
        refs = {case[0]: pool.submit(_jax_run, hj, *case[1:]) for case in MATRIX}
        meshed_refs = {kind: pool.submit(_jax_meshed, hj, kind, kw) for kind, kw in MESHED_RUNS}
        want.update({name: ref.result() for name, ref in refs.items()})
        want.update({f"meshed-{k}": ref.result() for k, ref in meshed_refs.items()})
        results = world.result()
    got = {name: [r[0][i] for r in results] for i, name in enumerate(names)}
    got.update({f"meshed-{kind}": [r[1][i] for r in results]
                for i, (kind, _) in enumerate(MESHED_RUNS)})
    return got, want, hj, tmp


def _world(calls, meshed):
    """The 4-rank world's worker: the factorized-mesh calls, then the
    mesh= runners on the (2, 2) shares mesh."""
    return (launch.call_on_replica_meshes(calls, "cpu"),
            launch.call_on_meshes(meshed, "cpu"))


def _same_campaign(a, b, extra=("mesh", "ring", "exchange")):
    for f in ("generated", "received", "sent", "degree"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    assert (a.coverage is None) == (b.coverage is None)
    if a.coverage is not None:
        assert np.array_equal(a.coverage, b.coverage)
    assert a.batch_size == b.batch_size
    for key in extra:
        assert a.extra[key] == b.extra[key], key


def _one(results, extra=("mesh", "ring", "exchange")):
    """Rank 0's result, after checking every rank returned the same."""
    for r in results[1:]:
        _same_campaign(r, results[0], extra)
    return results[0]


@pytest.mark.parametrize("case", MATRIX, ids=[c[0] for c in MATRIX])
def test_matches_jax(case, runs):
    """Every split, exchange and async spelling, with churn and loss: each
    replica's counters and coverage rows, ``extra['mesh']``, ``['ring']``
    and ``['exchange']`` (the achieved delta counters too) equal the JAX
    sharded campaign's."""
    got, want, _, _ = runs
    res = _one(got[case[0]])
    _same_campaign(res, want[case[0]])
    assert res.extra["mesh"]["replica_shards"] == _dims(case[1])[0]
    assert res.extra["resident_bytes"] > 0
    assert res.received.sum() > 0


def test_delta_runs_ship_entries(runs):
    """The delta runs on two and four node shards exchange entries, each
    replica counted: used entries and exchange ticks over the live
    replicas (equal to JAX's above)."""
    got = runs[0]
    for name in ("delta-loss-churn-2x2", "delta-loss-churn-1x4", "pushpull-delta"):
        ex = _one(got[name]).extra["exchange"]
        assert ex["mode"] == "delta" and ex["achieved_used_entries"] > 0
    assert _one(got["pushpull-delta"]).extra["exchange"]["exchange_ticks"] == 4 * P_HORIZON
    assert _one(got["hub-coverage-2x2"]).extra["exchange"]["hub_count"] == 4


def test_coverage_ensemble_summary(runs):
    """The coverage campaign's ensemble statistics equal JAX's."""
    got, want, _, _ = runs
    res = _one(got["coverage-2x2"])
    assert res.coverage.shape == (4, 32, 6)
    mine, theirs = ensemble_summary(res, 0.99), jax_summary(want["coverage-2x2"], 0.99)
    mine.pop("wall_s", None), theirs.pop("wall_s", None)
    assert mine == theirs


def test_batch_rounding_and_sentinel_padding(runs):
    """R = 3 over 2 replica shards: the batch rounds up to 4 with a
    sentinel replica whose rows are dropped, equal to the R = 4 run's first
    three replicas."""
    got = runs[0]
    three, four = _one(got["rounding-2x2"]), _one(got["superset"])
    assert three.batch_size == 4 and three.received.shape == (3, 72)
    assert np.array_equal(three.received, four.received[:3])
    assert np.array_equal(three.sent, four.sent[:3])


@pytest.mark.parametrize("case", TELEMETRY, ids=[c[0] for c in TELEMETRY])
def test_telemetry_events_match_jax(case, runs):
    """With the rings on, the first rank's ring and digest events (one a
    live replica, with ``replica`` and ``seed``) equal the JAX sharded
    campaign's, and the progress beats carry the same ``digest_head``."""
    got, want, _, _ = runs
    _, events = got[case[0]][0]

    def pick(evs, kinds=("ring", "digest")):
        return [{k: v for k, v in e.items() if k != "wall"} for e in evs if e["type"] in kinds]

    mine, theirs = pick(events), pick(want[case[0]])
    assert mine and mine == theirs
    assert {e["replica"] for e in mine} == {0, 1, 2, 3}
    heads = [[e.get("digest_head") for e in pick(evs, ("progress",))]
             for evs in (events, want[case[0]])]
    assert heads[0] == heads[1] and heads[0][0] is not None
    for r in got[case[0]][1:]:  # only the first rank emits them
        assert pick(r[1], ("ring", "digest", "progress")) == []


def test_port_resumes_a_jax_checkpoint(runs):
    """JAX ran one of two batches and wrote its checkpoint; the port, on
    the same 2 x 2 split, resumes it and ends with the full campaign."""
    got, _, hj, _ = runs
    full = _jax_run(hj, dict(replicas=2), "plain", 32, {}, batch_size=2)
    _same_campaign(_one(got["resume"]), full)


def test_port_resumes_a_jax_protocol_checkpoint(runs):
    """The same for the protocol campaign (pull, delta, 1 x 4): the JAX
    fingerprint, resolved exchange included, is the port's. (The achieved
    exchange counters are not checkpointed: a resumed run reports its own
    batches' traffic, in either package.)"""
    got, _, hj, _ = runs
    full = _jax_run(hj, dict(replicas=1), "pchurn", P_HORIZON, PROTOCOL_RESUME)
    _same_campaign(_one(got["resume-protocol"]), full, extra=("mesh", "ring"))


def test_jax_resumes_a_port_checkpoint(runs):
    """The port ran one of two batches and wrote its checkpoint (the first
    rank only); JAX resumes it and ends with the full campaign, which the
    interrupted one is not."""
    got, _, hj, tmp = runs
    partial = _one(got["write"])
    resumed = _jax_run(hj, dict(replicas=2), "plain", 32, {}, batch_size=2,
                       checkpoint_path=str(tmp / "port.npz"))
    full = _jax_run(hj, dict(replicas=2), "plain", 32, {}, batch_size=2)
    _same_campaign(resumed, full)
    assert not np.array_equal(partial.received, full.received)


def test_mesh_factorization(runs):
    """``make_mesh(replicas=...)``: explicit counts, ``"auto"`` from the
    node bytes (the whole graph fits a rank: every rank a replica shard),
    and a shape the world cannot hold refused with JAX's message shape."""
    got = runs[0]
    assert _one(got["dense-2x2"]).extra["mesh"] == {
        "replica_shards": 2, "node_shards": 2, "local_replicas": 2}
    assert _one(got["auto-4x1"]).extra["mesh"]["node_shards"] == 1
    assert auto_axis_split(8, node_bytes=None) == (8, 1)
    assert auto_axis_split(8, node_bytes=3_000_000, hbm_bytes=1_000_000) == (2, 4)
    assert auto_axis_split(8, node_bytes=10**12, hbm_bytes=1_000_000) == (1, 8)
    for r in got["too-few"]:
        assert r == ("ValueError", "mesh 2x4 (replicas x nodes) needs 8 ranks, have 4")


def test_campaign_rejects_a_non_factorized_mesh():
    """A (shares, nodes) mesh is refused before any collective."""
    g = pt.erdos_renyi(32, 0.15, seed=0)
    reps = tc.flood_replicas(g, 4, [0, 1], 16)
    solo = types.SimpleNamespace(shape={"shares": 1, "nodes": 2}, coordinate=(0, 0))
    for fn in (tcs.run_sharded_campaign, tcs.run_sharded_protocol_campaign):
        with pytest.raises(ValueError, match="replicas"):
            fn(g, reps, 16, solo)


@pytest.mark.parametrize("kind", [k for k, _ in MESHED_RUNS])
def test_campaign_runners_mesh_replica_axis(kind, runs):
    """``mesh=`` on the coverage, gossip and protocol runners: the replica
    axis over the 4 ranks of a (2, 2) mesh, the batch rounded up to 8 (the
    JAX package's test_protocol_campaign_mesh_replica_axis on 8 devices),
    every rank returning JAX's counters and coverage rows."""
    got, want, _, _ = runs
    res = _one(got[f"meshed-{kind}"], extra=())
    assert res.batch_size == 8
    _same_campaign(res, want[f"meshed-{kind}"], extra=())
