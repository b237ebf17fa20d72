"""The port's gossip server on a (replicas, nodes) mesh of gloo ranks
(``GossipServer(mesh=...)``) against the JAX package's server on
``make_slot_mesh(4, devices=jax.devices("cpu"))`` (tests/test_serve.py's
mesh test) and the port's single-device server: every request's counters
and coverage rows bitwise equal (integer ops, tolerance 0) on every rank,
for flood, push-pull, pull, fanout push, a lossy and a churn flood, with
the dense, delta and hub exchanges, on ``make_slot_mesh(4)`` (4 x 1), a
2 x 2 and a 1 x 4 mesh; the first rank's ``request`` and ``slot`` events
equal to JAX's (timing fields aside, the cost's traffic fields value for
value) and no event from the other ranks; a preempted request resumed
across a mesh server and a single-device one, both ways; admission equal
on every rank under differing per-rank budgets; the refusals (slots not
dividing the replica shards, a rank outside the mesh).

One world of 4 spawned ranks (`parallel.launch.spawn`) runs every case,
while a thread of this process runs the JAX server; the parametrised
tests read both."""

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import jax

from p2p_gossip_tpu import telemetry as jax_tel
from p2p_gossip_tpu.parallel.mesh import make_slot_mesh as jax_slot_mesh
from p2p_gossip_tpu.serve.server import GossipServer as JaxServer

from p2p_gossip_tpu_torch import telemetry
from p2p_gossip_tpu_torch.parallel import launch
from p2p_gossip_tpu_torch.serve.request import SimRequest
from p2p_gossip_tpu_torch.serve.server import GossipServer

RANKS = 4
TOPO = {"family": "erdos_renyi", "n": 40, "p": 0.15, "seed": 2}
TOPO_WS = {"family": "watts_strogatz", "n": 40, "k": 4, "beta": 0.1, "seed": 3}
MIXED = [
    ("f1", dict(seeds=(0, 1, 2))),
    ("pp", dict(protocol="pushpull", seeds=(3, 4))),
    ("pull", dict(protocol="pull", seeds=(5,), topology=TOPO_WS)),
    ("pk", dict(protocol="pushk", seeds=(6, 7), fanout=3)),
    ("lossy", dict(seeds=(8,), loss_prob=0.1)),
    ("churn", dict(seeds=(9, 10), churn_prob=0.2)),
    ("f2", dict(seeds=(11, 12, 13, 14, 15))),
]
MESHES = ("slot", "2x2", "1x4")
EXCHANGES = ("dense", "delta", "hub")
FIELDS = ("generated", "received", "sent", "coverage")
TRAFFIC = ("bytes_per_tick", "flops_per_tick", "slot_bytes", "request_bytes")
TIMING = ("wall_s", "turnaround_s", "cost")
BUDGET_CASES = {  # each rank's budget, relative to the request's modeled bytes
    "one-rank-short": (100, -1, 100, 100),
    "every-rank-fits": (0, 1, 7, 1000),
    "the-others-unbudgeted": (None, -1, None, None),
}


def _req(rid, protocol="flood", seeds=(0, 1), topology=TOPO, **kw):
    return SimRequest.make(topology, protocol, 8, 8, seeds, request_id=rid, **kw)


def _requests():
    return [_req(rid, **kw).to_dict() for rid, kw in MIXED]


def _arrays(result):
    return {f: np.asarray(getattr(result, f)) for f in FIELDS}


def _served_events(events):
    """The ``request`` and ``slot`` events, timing fields and the cost's
    residency aside (the cost's traffic fields kept)."""
    out = []
    for e in events:
        if e["type"] not in ("request", "slot"):
            continue
        kept = {k: v for k, v in e.items() if k not in TIMING}
        if "cost" in e:
            kept["traffic"] = {k: e["cost"][k] for k in TRAFFIC}
        out.append(kept)
    return out


def _meshes():
    from p2p_gossip_tpu_torch.parallel.mesh import make_mesh, make_slot_mesh

    return {"slot": make_slot_mesh(4, device="cpu"),
            "2x2": make_mesh(2, replicas=2, device="cpu"),
            "1x4": make_mesh(4, replicas=1, device="cpu")}


def _drain(server, requests):
    for r in requests:
        server.submit(r)
    steps = []
    while (step := server.step()) is not None:
        steps.append(step)
    return steps


def _world(requests, tmp):
    """Every rank: the mixed drain on each mesh and exchange, the
    checkpoint hand-overs, the budgets, the refusals."""
    import torch.distributed as dist

    from p2p_gossip_tpu_torch.parallel.mesh import make_mesh, make_slot_mesh
    from p2p_gossip_tpu_torch.serve.request import build_graph
    from p2p_gossip_tpu_torch.serve.scheduler import mesh_request_cost

    rank = dist.get_rank()
    meshes = _meshes()
    out = {"shapes": {name: dict(m.shape) for name, m in meshes.items()}, "drains": {}}
    for name, mesh in meshes.items():
        for ex in EXCHANGES:
            telemetry.reset()
            telemetry.configure(None, rings=False)
            try:
                server = GossipServer(slots=4, mesh=mesh, exchange=ex)
                steps = _drain(server, requests)
                out["drains"][name, ex] = dict(
                    results={r["request_id"]: _arrays(server.result(r["request_id"]))
                             for r in requests},
                    events=_served_events(telemetry.events()),
                    models=[(server._states[s["request_ids"][0]].cost["dispatch_bytes"],
                             s["resident_bytes"]) for s in steps])
            finally:
                telemetry.reset()
            launch.progress()

    # A mesh server checkpoints at a preemption; the parent resumes it.
    mesh = meshes["2x2"]
    writer = GossipServer(slots=2, mesh=mesh, checkpoint_dir=os.path.join(tmp, "mesh"))
    writer.submit(_req("ck-mesh", protocol="pushpull", seeds=(0, 1, 2, 3)).to_dict())
    writer.step()
    out["preempted"] = writer.preempt("ck-mesh")
    # The parent's single-device checkpoint resumes here.
    reader = GossipServer(slots=2, mesh=mesh, checkpoint_dir=os.path.join(tmp, "single"))
    reader.submit(_req("ck-single", seeds=(0, 1, 2, 3)).to_dict())
    out["resumed_dispatches"] = reader.drain()
    out["resumed"] = _arrays(reader.result("ck-single"))
    launch.progress()

    # Admission: each rank its own budget around the request's modeled cost.
    req = _req("big", seeds=(0, 1))
    cost = mesh_request_cost(req, build_graph(TOPO).degree, 4, 4, 1)["dispatch_bytes"]
    out["cost"] = cost
    out["budgets"] = {}
    for case, deltas in BUDGET_CASES.items():
        d = deltas[rank]
        server = GossipServer(slots=4, mesh=meshes["slot"],
                              hbm_budget_bytes=None if d is None else cost + d)
        rid = server.submit(req.to_dict())
        dispatches = server.drain()
        out["budgets"][case] = (server.status(rid), dispatches)

    # The refusals: slots not over the replica shards; a rank outside a mesh.
    try:
        GossipServer(slots=6, mesh=make_mesh(1, replicas=4, device="cpu"))
    except ValueError as e:
        out["indivisible"] = str(e)
    half = make_mesh(2, replicas=1, device="cpu")  # ranks 0 and 1
    try:
        GossipServer(slots=4, mesh=half)
        out["outside"] = None
    except ValueError as e:
        out["outside"] = str(e)
    out["slot3"] = dict(make_slot_mesh(3, device="cpu").shape)
    return out


def _jax_server(requests):
    jax_tel.reset()
    jax_tel.configure(None, rings=False)
    try:
        server = JaxServer(slots=4, mesh=jax_slot_mesh(4, devices=jax.devices("cpu")))
        for r in requests:
            server.submit(r)
        server.drain()
        results = {r["request_id"]: _arrays(server.result(r["request_id"])) for r in requests}
        return results, _served_events(jax_tel.events())
    finally:
        jax_tel.reset()


def _single(requests, **kw):
    server = GossipServer(slots=4, device="cpu", **kw)
    for r in requests:
        server.submit(r)
    server.drain()
    return {r["request_id"]: _arrays(server.result(r["request_id"])) for r in requests}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every rank's results from one world of 4 ranks, the JAX server's
    (run meanwhile in a thread) and the single-device port server's."""
    tmp = tmp_path_factory.mktemp("serve_mesh")
    for tel in (telemetry, jax_tel):
        tel.reset()
    single_ck = GossipServer(slots=2, device="cpu", checkpoint_dir=str(tmp / "single"))
    single_ck.submit(_req("ck-single", seeds=(0, 1, 2, 3)).to_dict())
    single_ck.step()
    single_ck.preempt("ck-single")
    requests = _requests()
    with ThreadPoolExecutor(1) as pool:
        jax_run = pool.submit(_jax_server, requests)
        ranks = launch.spawn(_world, RANKS, requests, str(tmp), timeout_s=120.0)
        want, want_events = jax_run.result()
    return dict(ranks=ranks, want=want, want_events=want_events, single=_single(requests),
                tmp=tmp)


def _same(got, want, label):
    for f in FIELDS:
        assert got[f].shape == want[f].shape and np.array_equal(got[f], want[f]), \
            f"{label}: {f}"


def test_meshes_have_the_jax_shapes(world):
    for out in world["ranks"]:
        assert out["shapes"] == {"slot": {"replicas": 4, "nodes": 1},
                                 "2x2": {"replicas": 2, "nodes": 2},
                                 "1x4": {"replicas": 1, "nodes": 4}}
        assert out["slot3"] == {"replicas": 1, "nodes": 4}


@pytest.mark.parametrize("exchange", EXCHANGES)
@pytest.mark.parametrize("mesh", MESHES)
def test_every_request_equals_the_jax_mesh_server(mesh, exchange, world):
    """Every rank ends with every request's full arrays, bitwise those of
    JAX's server over make_slot_mesh(4) and of the single-device port."""
    for rank, out in enumerate(world["ranks"]):
        got = out["drains"][mesh, exchange]["results"]
        assert set(got) == set(world["want"])
        for rid, want in world["want"].items():
            _same(got[rid], want, f"rank {rank} {rid}")
            _same(got[rid], world["single"][rid], f"rank {rank} {rid} single")


@pytest.mark.parametrize("exchange", EXCHANGES)
@pytest.mark.parametrize("mesh", MESHES)
def test_first_rank_events_equal_the_jax_servers(mesh, exchange, world):
    """The first rank's request and slot events are JAX's (the same plans,
    the cost's traffic fields); no other rank emits one."""
    ranks = world["ranks"]
    first = ranks[0]["drains"][mesh, exchange]["events"]
    assert first == world["want_events"]
    assert {e["event"] for e in first if e["type"] == "request"} >= {
        "submitted", "admitted", "dispatched", "done"}
    assert all(not out["drains"][mesh, exchange]["events"] for out in ranks[1:])


@pytest.mark.parametrize("mesh", MESHES)
def test_admission_model_prices_the_runners_ranks(mesh, world):
    """The per-rank admission model (`mesh_request_cost`) is the sharded
    runner's own modeled peak of the dispatch's rank, within 10%, on every
    exchange (the delta capacity priced at its largest cut)."""
    for out in world["ranks"]:
        for ex in EXCHANGES:
            for model, runner in out["drains"][mesh, ex]["models"]:
                assert abs(model - runner) <= 0.10 * runner, (mesh, ex, model, runner)


def test_checkpoint_written_on_a_mesh_resumes_in_a_single_device_server(world):
    """The first rank alone writes the preempted request's file; a
    single-device server resumes it and ends with the whole result."""
    ranks = world["ranks"]
    assert [out["preempted"] for out in ranks] == [2] * RANKS
    files = list((world["tmp"] / "mesh").iterdir())
    assert len(files) == 1
    req = _req("ck-mesh", protocol="pushpull", seeds=(0, 1, 2, 3)).to_dict()
    server = GossipServer(slots=2, device="cpu", checkpoint_dir=str(world["tmp"] / "mesh"))
    server.submit(req)
    assert server.drain() == 1  # only the two replicas the mesh server left
    _same(_arrays(server.result("ck-mesh")), _single([req])["ck-mesh"], "ck-mesh")


def test_single_device_checkpoint_resumes_on_a_mesh(world):
    req = _req("ck-single", seeds=(0, 1, 2, 3)).to_dict()
    want = _single([req])["ck-single"]
    for out in world["ranks"]:
        assert out["resumed_dispatches"] == 1
        _same(out["resumed"], want, "ck-single")


@pytest.mark.parametrize("case", list(BUDGET_CASES))
def test_admission_is_the_same_on_every_rank(case, world):
    """Each rank's own budget around the request's modeled bytes: the
    smallest over the mesh decides, so every rank admits or rejects alike
    (a rank without a budget counts as none)."""
    got = [out["budgets"][case] for out in world["ranks"]]
    want = ("done", 1) if case == "every-rank-fits" else ("rejected", 0)
    assert got == [want] * RANKS
    assert len({out["cost"] for out in world["ranks"]}) == 1


def test_server_slots_must_divide_over_replica_shards(world):
    for out in world["ranks"]:
        assert "replica shards" in out["indivisible"]


def test_a_rank_outside_the_mesh_raises(world):
    outside = [out["outside"] for out in world["ranks"]]
    assert outside[:2] == [None, None]
    assert all("not in the mesh" in msg for msg in outside[2:])
