"""The port's gossip server (``p2p_gossip_tpu_torch.serve``) against the JAX
package's (``p2p_gossip_tpu.serve``), as tests/test_serve.py holds the
JAX one: request JSON and validation, topology fingerprints and signature
keys equal to the JAX strings, the same slot plans for one trace, a mixed
drain whose every result is bitwise the JAX server's and a port solo
campaign's, preemption and resume in one server and across the two
packages through a checkpoint directory, duplicate ids, admission against
an explicit budget with the port's own memory model, a mesh of the wrong
kind refused, a schema-valid event stream, and the bench's smoke run.

The port runs on the CPU (its kernels' plain torch versions), the JAX
package on the CPU as its own tests run it."""

import collections
import json
import types
import weakref

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from p2p_gossip_tpu import telemetry as jax_tel
from p2p_gossip_tpu.serve import request as jreq
from p2p_gossip_tpu.serve import scheduler as jsched
from p2p_gossip_tpu.serve.server import GossipServer as JaxServer
from p2p_gossip_tpu_torch import telemetry
from p2p_gossip_tpu_torch.batch import campaign as tc
from p2p_gossip_tpu_torch.engine.sync import _chunk_state
from p2p_gossip_tpu_torch.models.linkloss import LinkLossModel
from p2p_gossip_tpu_torch.models.seeds import replica_loss_seeds
from p2p_gossip_tpu_torch.serve import bench, scheduler
from p2p_gossip_tpu_torch.serve import request as request_mod
from p2p_gossip_tpu_torch.serve.request import (
    PROTOCOLS,
    TOPOLOGY_FAMILIES,
    SimRequest,
    build_graph,
    topology_fingerprint,
    validate_request,
)
from p2p_gossip_tpu_torch.serve.scheduler import SlotScheduler, modeled_request_cost
from p2p_gossip_tpu_torch.serve.server import GossipServer
from p2p_gossip_tpu_torch.telemetry import schema

TOPO = {"family": "erdos_renyi", "n": 40, "p": 0.15, "seed": 2}
TOPO_WS = {"family": "watts_strogatz", "n": 40, "k": 4, "beta": 0.1, "seed": 3}
FIELDS = ("generated", "received", "sent", "coverage")


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


def _req(rid, protocol="flood", seeds=(0, 1), topology=TOPO, **kw):
    return SimRequest.make(topology, protocol, 2, 10, seeds, request_id=rid, **kw)


def _jax(req: SimRequest):
    return jreq.SimRequest.from_dict(req.to_dict())


def _server(**kw):
    return GossipServer(device="cpu", **kw)


def _assert_bitwise(got, want, label):
    for f in FIELDS:
        a, b = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
        assert a.shape == b.shape and np.array_equal(a, b), f"{label}: {f}"


# --- the request model ------------------------------------------------------------

def test_request_json_round_trip_equals_the_jax_packages():
    req = _req("r1", protocol="pushk", fanout=3, loss_prob=0.1, churn_prob=0.2)
    back = SimRequest.from_json(req.to_json())
    assert back == req and back.replicas == 2
    assert SimRequest.from_dict(json.loads(req.to_json())) == req
    assert req.to_json() == _jax(req).to_json()
    assert SimRequest.from_json(_jax(req).to_json()) == req
    assert PROTOCOLS == jreq.PROTOCOLS
    assert {k: v[1:] for k, v in TOPOLOGY_FAMILIES.items()} == {
        k: v[1:] for k, v in jreq.TOPOLOGY_FAMILIES.items()}


@pytest.mark.parametrize("bad", [
    {"request_id": "", "topology": {"family": "nope"}, "protocol": "carrier-pigeon",
     "shares": 0, "horizon": 1, "seeds": [], "loss_prob": 2.0},
    "not a dict",
    {"topology": 7},
    {"request_id": "x", "topology": {"family": "ring", "n": 8, "p": 0.1},
     "protocol": "flood", "shares": 2, "horizon": 4, "seeds": [1]},
    {"request_id": "x", "topology": {"family": "erdos_renyi", "n": 8},
     "protocol": "pushk", "shares": 2, "horizon": 4, "seeds": [1], "fanout": 0,
     "max_outages": 0, "exchange": "carrier", "mean_down_ticks": "long"},
])
def test_validation_errors_equal_the_jax_packages(bad):
    errs = validate_request(bad)
    assert errs and errs == jreq.validate_request(bad)


def test_validation_collects_every_problem():
    bad = {"request_id": "", "topology": {"family": "nope"}, "protocol": "carrier-pigeon",
           "shares": 0, "horizon": 1, "seeds": [], "loss_prob": 2.0}
    joined = "\n".join(validate_request(bad))
    for fragment in ("request_id", "family", "protocol", "shares", "seeds", "loss_prob"):
        assert fragment in joined, fragment
    assert validate_request(_req("x").to_dict() | {"topology": {"family": "ring", "n": 8}}) == []
    with pytest.raises(ValueError):
        SimRequest.make(TOPO, "flood", 0, 10, [1])


@pytest.mark.parametrize("kw", [
    {}, {"protocol": "pushk", "fanout": 3}, {"loss_prob": 0.1}, {"churn_prob": 0.2},
    {"topology": TOPO_WS}, {"exchange": "delta"},
    {"topology": {"family": "grid", "rows": 4, "cols": 5, "torus": True}},
])
def test_fingerprints_and_signature_keys_are_the_jax_strings(kw):
    req = _req("a", **kw)
    assert req.topology_fp == _jax(req).topology_fp
    assert topology_fingerprint(req.topology) == jreq.topology_fingerprint(req.topology)
    assert req.static_signature() == _jax(req).static_signature()
    assert req.signature_key() == _jax(req).signature_key()


def test_topology_fingerprint_order_invariant_and_graphs_equal():
    a = {"family": "erdos_renyi", "n": 40, "p": 0.15, "seed": 2}
    b = {"seed": 2, "p": 0.15, "n": 40, "family": "erdos_renyi"}
    assert topology_fingerprint(a) == topology_fingerprint(b)
    assert topology_fingerprint(a) != topology_fingerprint(dict(a, seed=3))
    for topo in (a, TOPO_WS, {"family": "barabasi_albert", "n": 30, "m": 3}):
        np.testing.assert_array_equal(build_graph(topo).edges(), jreq.build_graph(topo).edges())


def test_static_signature_batching_rules():
    assert _req("a", seeds=(0, 1)).static_signature() == \
        _req("b", seeds=(7, 8, 9)).static_signature()
    assert _req("a", fanout=2).static_signature() == _req("b", fanout=5).static_signature()
    assert _req("a", protocol="pushk", fanout=2).static_signature() != \
        _req("b", protocol="pushk", fanout=5).static_signature()
    assert _req("a").static_signature() != _req("b", loss_prob=0.1).static_signature()
    assert _req("a").static_signature()[-1] is None
    assert _req("a", churn_prob=0.1).static_signature()[-1] is not None


# --- the scheduler ------------------------------------------------------------------

def _plans(sched_mod, req_mod, trace, slots):
    sched = sched_mod.SlotScheduler(slots=slots)
    for i, d in enumerate(trace):
        sched.enqueue(req_mod.SimRequest.from_dict(d))
        if i == 5:  # a request leaves the queue mid-trace
            sched.remove(trace[2]["request_id"])
    plans = []
    while (plan := sched.next_plan()) is not None:
        plans.append((plan.signature_key, [(u.request_id, u.replica, u.seq) for u in plan.units],
                      plan.slots, plan.occupied, plan.request_ids))
    return plans


def test_scheduler_packs_the_jax_packages_plans():
    trace = bench.build_trace(14, seed=3, **{k: v for k, v in bench.SMOKE.items()
                                             if k != "requests"})
    plans = _plans(scheduler, request_mod, trace, 4)
    assert plans == _plans(jsched, jreq, trace, 4)
    assert any(len(p[4]) > 1 for p in plans)  # requests share a dispatch


def test_scheduler_remove_and_fifo():
    sched = SlotScheduler(slots=4)
    sched.enqueue(_req("r1", seeds=(0, 1, 2)))
    sched.enqueue(_req("p", protocol="pushpull", seeds=(3,)))
    sched.enqueue(_req("r2", seeds=(4, 5)))
    plan = sched.next_plan()
    assert [(u.request_id, u.replica) for u in plan.units] == [
        ("r1", 0), ("r1", 1), ("r1", 2), ("r2", 0)]
    assert sched.remove("r2") == 1 and sched.queue_depth() == 1
    assert {u.request_id for u in sched.next_plan().units} == {"p"}
    assert sched.next_plan() is None
    with pytest.raises(ValueError):
        SlotScheduler(slots=0)


# --- admission and the memory model ------------------------------------------------

@pytest.mark.parametrize("protocol", ["flood", "pushpull", "pushk"])
@pytest.mark.parametrize("n", [40, 5000])
def test_modeled_bytes_equal_the_staged_nbytes(protocol, n):
    """The model's staged graph is the staging the server holds (the
    flood's `DeviceGraph`, bucketed from 4,096 nodes; the protocols' CSR,
    `PartnerGraph`) byte for byte, and a flood slot's state is
    `_chunk_state`'s; the traffic fields are the JAX package's."""
    topo = {"family": "erdos_renyi", "n": n, "p": min(1.0, 6 / n), "seed": 1}
    req = SimRequest.make(topo, protocol, 100, 12, (0, 1, 2), request_id="m")
    g = build_graph(topo)
    cost = modeled_request_cost(req, g.degree, slots=4)
    dg = _server(slots=4)._device_graph(req)
    if protocol == "flood":
        staged = [dg.ell_idx, dg.ell_delay, dg.ell_mask, dg.degree]
        for bucket in dg.buckets or ():
            staged += [t for t in bucket if t is not None]
        assert (dg.buckets is not None) == (n >= 4096)
    else:
        staged = [dg.indptr, dg.indices, dg.degree]
        assert dg.edge_delay is None and dg.nbytes == sum(t.nbytes for t in staged)
    assert cost["staged_bytes"] == sum(t.nbytes for t in staged)
    assert cost["dispatch_bytes"] == cost["staged_bytes"] + 4 * cost["resident_bytes"]
    want = jsched.modeled_request_cost(_jax(req), g.n, g.max_degree)
    for key in ("bytes_per_tick", "flops_per_tick", "slot_bytes", "request_bytes"):
        assert cost[key] == want[key], key
    if protocol == "flood":
        w = 4  # 100 shares with the 128-share floor
        state = sum(t.nbytes for t in _chunk_state(dg, w, replicas=1))
        tick = n * w * 4 + 2 * n * 4
        assert cost["resident_bytes"] == state + tick + 4 * n + 14 * 100 * 4 + 128 * 20


class _LiveBytes(TorchDispatchMode):
    """Peak bytes of the CPU tensors alive at once while the mode is on:
    each op's outputs counted by storage until their last tensor dies."""

    def __init__(self):
        super().__init__()
        self.refs, self.size, self.now, self.peak = collections.Counter(), {}, 0, 0

    def _drop(self, key):
        self.refs[key] -= 1
        if not self.refs[key]:
            self.now -= self.size.pop(key)
            del self.refs[key]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor) and t.untyped_storage().nbytes():
                key = t.untyped_storage().data_ptr()
                if key not in self.size:
                    self.size[key] = t.untyped_storage().nbytes()
                    self.now += self.size[key]
                    self.peak = max(self.peak, self.now)
                self.refs[key] += 1
                weakref.finalize(t, self._drop, key)
        return out


@pytest.mark.parametrize("opts", [{}, {"loss_prob": 0.1}, {"churn_prob": 0.2}])
def test_pull_model_equals_the_live_peak_on_the_cpu(opts):
    """A pull dispatch's peak (the 16-round draw) has no sort, so its live
    tensors on the CPU are the card's: the model of the staged graph plus
    8 slots is the peak of live bytes within 1%, plain, lossy and under
    churn (the push modes add the card's sort scratch, which chip_smoke
    phase 13 measures)."""
    topo = {"family": "erdos_renyi", "n": 2000, "p": 0.05, "seed": 0}
    srv = _server(slots=8)
    srv.submit(dict(request_id="pull", topology=topo, protocol="pull", shares=256,
                    horizon=16, seeds=list(range(8)), **opts))
    live = _LiveBytes()
    with live:
        assert srv.drain() == 1
    model = srv._states["pull"].cost["dispatch_bytes"]
    assert abs(live.peak - model) < 0.01 * model, (live.peak, model)


def test_admission_rejects_with_an_explicit_budget():
    srv = _server(slots=4)
    cost = modeled_request_cost(_req("x"), build_graph(TOPO).degree, slots=4)
    for budget, admitted in ((cost["dispatch_bytes"], True), (cost["dispatch_bytes"] - 1, False)):
        srv = _server(slots=4, hbm_budget_bytes=budget)
        telemetry.configure(None, rings=False)
        rid = srv.submit(_req("big"))
        assert (srv.status(rid) == "queued") == admitted
        if not admitted:
            with pytest.raises(ValueError, match="rejected"):
                srv.result(rid)
            rej = [e for e in telemetry.events()
                   if e.get("type") == "request" and e.get("event") == "rejected"]
            assert rej and rej[-1]["cost"] == cost and "HBM budget" in rej[-1]["reason"]
            assert srv.drain() == 0
        telemetry.reset()
    # On the CPU no budget applies unless one is given.
    assert _server(slots=4).submit(_req("free")) == "free"
    ok, _, reason = SlotScheduler(4).admit(_req("r"), build_graph(TOPO).degree,
                                           max_request_bytes=10)
    assert not ok and "per-request cap" in reason


# --- the server ---------------------------------------------------------------------

MIXED = [
    ("f1", dict(seeds=(0, 1, 2))),
    ("f2", dict(seeds=(3, 4))),
    ("lossy", dict(seeds=(5,), loss_prob=0.1)),
    ("pp", dict(protocol="pushpull", seeds=(6, 7))),
    ("pull", dict(protocol="pull", seeds=(8,), topology=TOPO_WS)),
    ("pk", dict(protocol="pushk", seeds=(9, 10), fanout=3, churn_prob=0.2)),
]


def _solo(req: SimRequest):
    graph = build_graph(req.topology)
    reps = tc.flood_replicas(graph, req.shares, list(req.seeds), req.horizon,
                             churn_prob=req.churn_prob, mean_down_ticks=req.mean_down_ticks,
                             max_outages=req.max_outages)
    loss = LinkLossModel(req.loss_prob) if req.loss_prob > 0 else None
    lseeds = replica_loss_seeds(list(req.seeds)) if loss else None
    if req.protocol == "flood":
        return tc.run_coverage_campaign(graph, reps, req.horizon, loss=loss, loss_seeds=lseeds,
                                        device="cpu")
    return tc.run_protocol_campaign(graph, reps, req.horizon, protocol=req.protocol,
                                    fanout=req.fanout, record_coverage=True, loss=loss,
                                    loss_seeds=lseeds, device="cpu")


def test_mixed_drain_equals_the_jax_server_and_solo_campaigns(tmp_path):
    stream = tmp_path / "serve.jsonl"
    telemetry.configure(str(stream), rings=False)
    try:
        srv, jsrv = _server(slots=4), JaxServer(slots=4)
        reqs = [_req(rid, **kw) for rid, kw in MIXED]
        for r in reqs:
            srv.submit(r.to_json())
            jsrv.submit(r.to_dict())
        batches = srv.drain()
        assert batches == jsrv.drain() >= 5
        assert srv.stats() == jsrv.stats()
        assert srv.stats()["done"] == len(reqs) and 0 < srv.slot_occupancy() <= 1.0
        for r in reqs:
            got = srv.result(r.request_id)
            _assert_bitwise(got, jsrv.result(r.request_id), r.request_id)
            _assert_bitwise(got, _solo(r), r.request_id)
            assert got.extra["signature"] == r.signature_key()
    finally:
        telemetry.close()
    lines = stream.read_text().splitlines()
    assert schema.validate_stream(lines) == []
    events = [json.loads(ln) for ln in lines]
    assert {e["event"] for e in events if e["type"] == "request"} >= {
        "submitted", "admitted", "dispatched", "done"}
    slots = [e for e in events if e["type"] == "slot"]
    assert len(slots) == batches and any(len(e["request_ids"]) > 1 for e in slots)
    beats = [e for e in events if e["type"] == "progress" and e.get("kernel") == "serve.server"]
    assert beats and all(isinstance(e["active_requests"], int)
                         and isinstance(e["queue_depth"], int) for e in beats)


def test_campaign_telemetry_rides_the_servers_stream():
    """With the rings on, each dispatch carries its live replicas' ring and
    digest events (the campaign runners'), and the stream validates."""
    telemetry.configure(None, rings=True)
    srv = _server(slots=4)
    for rid, kw in MIXED[:4]:
        srv.submit(_req(rid, **kw))
    srv.drain()
    events = telemetry.events()
    assert schema.validate_stream([json.dumps(e) for e in events]) == []
    digests = [e for e in events if e["type"] == "digest"]
    assert len(digests) == sum(len(kw["seeds"]) for _, kw in MIXED[:4])


def test_preempt_and_resume_in_one_server():
    srv = _server(slots=2)
    req = _req("long", seeds=(0, 1, 2, 3, 4))
    srv.submit(req)
    srv.step()
    assert srv.preempt("long") == 3 and srv.status("long") == "preempted"
    assert srv.drain() == 0
    assert srv.resume("long") == 3 and srv.drain() == 2
    _assert_bitwise(srv.result("long"), _solo(req), "long")
    with pytest.raises(ValueError, match="not resumable"):
        srv.resume("long")


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_preempted_request_resumes_in_the_other_package(writer, reader, tmp_path):
    """A partial result one package's server checkpoints at a batch
    boundary, the other's resumes from the same directory: same file
    name, keys and fingerprint, and the result equals a whole run."""
    servers = {"jax": lambda: JaxServer(slots=2, checkpoint_dir=str(tmp_path)),
               "port": lambda: _server(slots=2, checkpoint_dir=str(tmp_path))}
    req = _req("ck", protocol="pushpull", seeds=(0, 1, 2, 3))
    first = servers[writer]()
    first.submit(req.to_dict())
    first.step()
    first.preempt("ck")
    assert len(list(tmp_path.iterdir())) == 1
    second = servers[reader]()
    second.submit(req.to_dict())
    assert second.drain() == 1  # only the two replicas the writer left
    _assert_bitwise(second.result("ck"), _solo(req), "ck")


def test_duplicate_ids_and_the_mesh_are_refused():
    """A duplicate request id, and a mesh that is not the sharded
    campaigns' (replicas, nodes) one (a (shares, nodes) mesh); the server on
    a (replicas, nodes) mesh runs in tests/test_torch_serve_mesh.py."""
    srv = _server(slots=4)
    srv.submit(_req("dup", seeds=(0,)))
    with pytest.raises(ValueError, match="duplicate"):
        srv.submit(_req("dup", seeds=(1,)))
    shares_mesh = types.SimpleNamespace(shape={"shares": 1, "nodes": 1}, coordinate=(0, 0))
    with pytest.raises(ValueError, match=r"\(replicas, nodes\) mesh"):
        GossipServer(slots=4, mesh=shares_mesh)


def test_server_device_defaults_to_cuda():
    """``device=None`` means CUDA: without a card the server refuses to
    start rather than fall back to the CPU."""
    if torch.cuda.is_available():
        assert GossipServer(slots=2).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            GossipServer(slots=2)


def test_bench_smoke_runs_and_verifies(capsys):
    assert bench.main(["--device", "cpu", "--smoke"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    row = json.loads(lines[-1])
    assert row["bitwise_ok"] is True and row["verified"] == row["requests"] == 12
    assert row["signatures"] == 10 and row["dispatches"] >= row["signatures"]
    assert any("requests/s" in ln for ln in lines[:-1])
    assert any("p99" in ln and "occupancy" in ln for ln in lines[:-1])
