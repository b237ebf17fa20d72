"""Gossip-as-a-service: the in-process request server (the JAX package's
``serve/server.py`` on one device).

`GossipServer` turns the campaign runners into a request-serving
surface: clients `submit()` JSON-serializable `SimRequest`s, a drain loop
packs compatible requests into shared replica slots (serve/scheduler.py)
and dispatches each batch onto the port's campaign runners
(`batch/campaign.py`, on the server's device), and per-request results
come back bitwise-identical to solo campaign runs with the same seeds
(slot placement and batch composition are semantically inert; the
campaign runners' sentinel padding guarantees it).

Lifecycle: ``submitted -> admitted|rejected``; admitted units queue,
``step()`` runs one continuous-batching dispatch, ``done`` fires when a
request's last replica lands. A long request can be **preempted** at
any batch boundary (`preempt`: pending units leave the queue, progress
is checkpointed when a ``checkpoint_dir`` is configured) and later
`resume`d — in this server or a fresh one (`submit` reloads a matching
checkpoint by fingerprint, utils/checkpoint.py) — into whatever slot
indices the scheduler hands out next; results stay bitwise-identical.
The checkpoint files are the JAX server's (same names, keys and
fingerprint): a partial result either server writes, the other resumes.

Result streaming rides the telemetry stack: ``request``/``slot`` events
(telemetry/schema.py v2) into the JSONL sink, the campaign runners' own
per-dispatch ``progress``/``digest``/``ring`` events, and heartbeat
payloads carrying ``active_requests``/``queue_depth`` so stall detection
stays meaningful while one process multiplexes many runs.

Graphs are cached per topology fingerprint, and their `DeviceGraph`
stagings per (fingerprint, bucketing): one build and one staging per
distinct topology, however many requests name it.

Not ported: the JAX server's ``mesh`` (its sharded dispatch waits for
the sharded campaigns, the next multi-GPU slice of ROADMAP §1 item 4; a
mesh raises NotImplementedError).
``exchange`` and ``async_k`` configure only that sharded dispatch, and
are accepted and unused, as in a JAX server without a mesh.
"""

from __future__ import annotations

import os
import time

import numpy as np

from p2p_gossip_tpu_torch import telemetry
from p2p_gossip_tpu_torch.models.linkloss import LinkLossModel
from p2p_gossip_tpu_torch.models.seeds import replica_loss_seeds
from p2p_gossip_tpu_torch.serve.request import SimRequest, build_graph
from p2p_gossip_tpu_torch.serve.scheduler import BatchPlan, SlotScheduler
from p2p_gossip_tpu_torch.utils import logging as p2plog
from p2p_gossip_tpu_torch.utils.checkpoint import (
    fingerprint,
    load_checkpoint,
    save_checkpoint,
)
from p2p_gossip_tpu_torch.utils.device import resolve_device

log = p2plog.get_logger("Serve.Server")

_PROGRESS_KERNEL = "serve.server"


class RequestState:
    """Server-side bookkeeping of one request: accumulated per-replica
    arrays (rows land as dispatches complete, in seed order regardless
    of slot index) plus lifecycle status and timing."""

    def __init__(self, request: SimRequest, n: int, cost: dict):
        self.request = request
        self.n = n
        self.cost = cost
        self.status = "queued"
        self.reason: str | None = None
        self.submit_t = time.perf_counter()
        self.done_t: float | None = None
        r, horizon, s = request.replicas, request.horizon, request.shares
        self.done = np.zeros(r, dtype=bool)
        self.generated = np.zeros((r, n), dtype=np.int64)
        self.received = np.zeros((r, n), dtype=np.int64)
        self.sent = np.zeros((r, n), dtype=np.int64)
        self.coverage = np.zeros((r, horizon, s), dtype=np.int64)
        self.degree: np.ndarray | None = None

    @property
    def replicas_done(self) -> int:
        return int(self.done.sum())

    @property
    def complete(self) -> bool:
        return bool(self.done.all())

    @property
    def turnaround_s(self) -> float | None:
        if self.done_t is None:
            return None
        return self.done_t - self.submit_t

    def checkpoint_fingerprint(self) -> str:
        """Identity of a resumable partial result: the static signature
        plus the seed list (everything that determines every row)."""
        return fingerprint(
            "serve.request", *self.request.static_signature(),
            np.asarray(self.request.seeds, dtype=np.int64),
        )


class GossipServer:
    """In-process continuous-batching simulation server (module
    docstring). ``slots`` is the fixed replica batch of every dispatch;
    ``device=None`` means CUDA (`utils.device.resolve_device`: no CPU
    fallback, ``device="cpu"`` runs the kernels' plain versions).

    ``hbm_budget_bytes`` is the admission budget for one dispatch's
    modeled device bytes (`serve.scheduler.modeled_request_cost`); None
    means `engine.sync.device_budget_bytes` at submission (the card's free
    memory, 0 and so no check on the CPU)."""

    def __init__(
        self,
        slots: int = 8,
        mesh=None,
        hbm_budget_bytes: int | None = None,
        max_request_bytes: int | None = None,
        checkpoint_dir: str | None = None,
        exchange: str = "dense",
        async_k: int = 2,
        *,
        device=None,
    ):
        if mesh is not None:
            raise NotImplementedError(
                "a server over a device mesh waits for the next multi-GPU slice "
                "(ROADMAP §1 item 4: the server's mesh= branch, after "
                "protocols_sharded and campaign_sharded)"
            )
        self.device = resolve_device(device)
        self.slots = int(slots)
        self.hbm_budget_bytes = hbm_budget_bytes
        self.max_request_bytes = max_request_bytes
        self.checkpoint_dir = checkpoint_dir
        self.exchange = exchange
        self.async_k = async_k
        self.scheduler = SlotScheduler(slots)
        self._states: dict[str, RequestState] = {}
        self._graphs: dict = {}
        self._device_graphs: dict = {}
        self._batches = 0
        self._occupied_slots = 0

    # -- graph cache -------------------------------------------------------

    def _graph(self, request: SimRequest):
        fp = request.topology_fp
        if fp not in self._graphs:
            self._graphs[fp] = build_graph(request.topology)
        return self._graphs[fp]

    def _device_graph(self, request: SimRequest):
        """The `DeviceGraph` per (topology, protocol family) on the
        server's device: partner selection reads the full ELL, so the
        partnered protocols need ``bucketed=False`` (batch/campaign.py's
        rule)."""
        from p2p_gossip_tpu_torch.engine.sync import DeviceGraph

        # None = the auto default the solo flood reference builds with;
        # False = the full-ELL form partner selection requires.
        bucketed = None if request.protocol == "flood" else False
        key = (request.topology_fp, bucketed)
        if key not in self._device_graphs:
            self._device_graphs[key] = DeviceGraph.build(
                self._graph(request), bucketed=bucketed, device=self.device
            )
        return self._device_graphs[key]

    # -- telemetry ---------------------------------------------------------

    def _emit_request(self, state: RequestState, event: str, **extra):
        ev = {
            "type": "request",
            "request_id": state.request.request_id,
            "event": event,
            "signature": state.request.signature_key(),
            "protocol": state.request.protocol,
            "replicas": state.request.replicas,
            "replicas_done": state.replicas_done,
        }
        for k, v in extra.items():
            if v is not None:
                ev[k] = v
        telemetry.emit(ev)

    def _heartbeat(self):
        telemetry.emit_progress(
            _PROGRESS_KERNEL,
            chunk=self._batches,
            active_requests=self.active_requests(),
            queue_depth=self.scheduler.queue_depth(),
        )

    # -- submission --------------------------------------------------------

    def submit(self, request) -> str:
        """Validate, admit (or reject), and queue a request; returns its
        id. Accepts a `SimRequest` or its dict/JSON form. When a
        ``checkpoint_dir`` holds a matching partial result (same
        fingerprint), completed replicas are restored and only the
        remainder queues — the cross-process resume path."""
        if isinstance(request, str):
            request = SimRequest.from_json(request)
        elif isinstance(request, dict):
            request = SimRequest.from_dict(request)
        rid = request.request_id
        if rid in self._states:
            raise ValueError(f"duplicate request_id {rid!r}")
        graph = self._graph(request)
        budget = self.hbm_budget_bytes
        if budget is None:
            from p2p_gossip_tpu_torch.engine.sync import device_budget_bytes

            budget = device_budget_bytes(self.device)
        admitted, cost, reason = self.scheduler.admit(
            request, graph.degree, hbm_budget_bytes=budget,
            max_request_bytes=self.max_request_bytes,
        )
        state = RequestState(request, graph.n, cost)
        state.degree = graph.degree.astype(np.int64)
        self._states[rid] = state
        self._emit_request(state, "submitted")
        if not admitted:
            state.status = "rejected"
            state.reason = reason
            log.warn(f"rejected request {rid}: {reason}")
            self._emit_request(state, "rejected", reason=reason, cost=cost)
            return rid
        resumed = self._try_restore(state)
        self._emit_request(state, "admitted", cost=cost,
                           queue_depth=self.scheduler.queue_depth())
        pending = [r for r in range(request.replicas) if not state.done[r]]
        if pending:
            self.scheduler.enqueue(request, pending)
        if resumed:
            self._emit_request(state, "resumed",
                               queue_depth=self.scheduler.queue_depth())
        if state.complete:
            self._finish(state)
        self._heartbeat()
        return rid

    # -- checkpointing -----------------------------------------------------

    def _checkpoint_path(self, state: RequestState) -> str | None:
        if self.checkpoint_dir is None:
            return None
        return os.path.join(
            self.checkpoint_dir,
            f"request_{state.checkpoint_fingerprint()[:24]}.npz",
        )

    def _save_partial(self, state: RequestState):
        path = self._checkpoint_path(state)
        if path is None or not state.done.any():
            return
        os.makedirs(self.checkpoint_dir, exist_ok=True)
        save_checkpoint(
            path,
            {
                "done": state.done,
                "generated": state.generated,
                "received": state.received,
                "sent": state.sent,
                "coverage": state.coverage,
            },
            {"fingerprint": state.checkpoint_fingerprint(),
             "request": state.request.to_dict()},
        )

    def _try_restore(self, state: RequestState) -> bool:
        path = self._checkpoint_path(state)
        if path is None:
            return False
        loaded = load_checkpoint(path)
        if loaded is None:
            return False
        arrays, meta = loaded
        if meta.get("fingerprint") != state.checkpoint_fingerprint():
            log.warn(
                f"checkpoint {path} is from a different request "
                "(fingerprint mismatch); ignoring"
            )
            return False
        state.done[:] = arrays["done"]
        for name in ("generated", "received", "sent", "coverage"):
            getattr(state, name)[:] = arrays[name]
        log.info(
            f"restored request {state.request.request_id} from {path}: "
            f"{state.replicas_done}/{state.request.replicas} replicas done"
        )
        return bool(state.done.any())

    # -- preemption --------------------------------------------------------

    def preempt(self, request_id: str) -> int:
        """Evict a request at the current batch boundary: pending units
        leave the queue, completed rows stay (and persist when a
        checkpoint dir is configured). Returns the evicted unit count."""
        state = self._states[request_id]
        dropped = self.scheduler.remove(request_id)
        if not state.complete:
            state.status = "preempted"
        self._save_partial(state)
        self._emit_request(state, "preempted",
                           queue_depth=self.scheduler.queue_depth())
        self._heartbeat()
        return dropped

    def resume(self, request_id: str) -> int:
        """Requeue a preempted request's remaining replicas. They join
        the back of their signature's queue — later arrivals land in
        different slot indices than the original placement, which must
        not (and does not) change any result."""
        state = self._states[request_id]
        if state.status not in ("preempted", "queued"):
            raise ValueError(
                f"request {request_id} is {state.status}, not resumable"
            )
        pending = [
            r for r in range(state.request.replicas) if not state.done[r]
        ]
        queued = self.scheduler.enqueue(state.request, pending) if pending \
            else 0
        state.status = "queued"
        self._emit_request(state, "resumed",
                           queue_depth=self.scheduler.queue_depth())
        if state.complete:
            self._finish(state)
        self._heartbeat()
        return queued

    # -- dispatch ----------------------------------------------------------

    def _run_batch(self, plan: BatchPlan):
        """One continuous-batching dispatch: assemble the same-signature
        units into a ReplicaSet (per-unit seeds; scenario params shared
        by signature equality) and run it through the matching campaign
        runner with ``batch_size == slots`` — one padded batch of one
        shape per signature."""
        from p2p_gossip_tpu_torch.batch.campaign import (
            flood_replicas,
            run_coverage_campaign,
            run_protocol_campaign,
        )

        ref = self._states[plan.units[0].request_id].request
        graph = self._graph(ref)
        seeds = [
            self._states[u.request_id].request.seeds[u.replica]
            for u in plan.units
        ]
        replicas = flood_replicas(
            graph, ref.shares, seeds, ref.horizon,
            churn_prob=ref.churn_prob,
            mean_down_ticks=ref.mean_down_ticks,
            max_outages=ref.max_outages,
        )
        loss = LinkLossModel(ref.loss_prob) if ref.loss_prob > 0 else None
        lseeds = replica_loss_seeds(seeds) if loss is not None else None
        common = dict(
            loss=loss, loss_seeds=lseeds, batch_size=self.slots,
            device_graph=self._device_graph(ref), device=self.device,
        )
        if ref.protocol == "flood":
            return run_coverage_campaign(graph, replicas, ref.horizon, **common)
        return run_protocol_campaign(
            graph, replicas, ref.horizon, protocol=ref.protocol,
            fanout=ref.fanout, record_coverage=True, **common,
        )

    def step(self) -> dict | None:
        """Run one dispatch (None when idle): pop the next slot plan,
        run it, scatter rows back into each request's accumulators, and
        emit the ``slot`` event + heartbeat. Returns the dispatch
        summary."""
        plan = self.scheduler.next_plan()
        if plan is None:
            return None
        t0 = time.perf_counter()
        result = self._run_batch(plan)
        wall = time.perf_counter() - t0
        touched: dict[str, RequestState] = {}
        for i, unit in enumerate(plan.units):
            state = self._states[unit.request_id]
            r = unit.replica
            state.generated[r] = result.generated[i]
            state.received[r] = result.received[i]
            state.sent[r] = result.sent[i]
            state.coverage[r] = np.asarray(
                result.coverage[i], dtype=np.int64
            )
            state.done[r] = True
            touched[unit.request_id] = state
        self._batches += 1
        self._occupied_slots += plan.occupied
        slot_ev = {
            "type": "slot",
            "batch": self._batches - 1,
            "signature": plan.signature_key,
            "slots": plan.slots,
            "occupied": plan.occupied,
            "request_ids": plan.request_ids,
            "wall_s": round(wall, 4),
        }
        telemetry.emit(slot_ev)
        for state in touched.values():
            if state.complete:
                self._finish(state)
            else:
                self._emit_request(state, "dispatched")
                # Batch-boundary persistence: the preemption contract
                # says anything completed by now survives an eviction.
                self._save_partial(state)
        self._heartbeat()
        return {
            "batch": self._batches - 1,
            "signature": plan.signature_key,
            "occupied": plan.occupied,
            "slots": plan.slots,
            "request_ids": plan.request_ids,
            "wall_s": wall,
        }

    def _finish(self, state: RequestState):
        if state.done_t is None:
            state.done_t = time.perf_counter()
        state.status = "done"
        self._emit_request(state, "done",
                           turnaround_s=round(state.turnaround_s, 4))

    def drain(self, max_batches: int | None = None) -> int:
        """Run dispatches until the queue empties (or ``max_batches``).
        Returns the number of batches run."""
        ran = 0
        while max_batches is None or ran < max_batches:
            if self.step() is None:
                break
            ran += 1
        return ran

    # -- results / introspection ------------------------------------------

    def status(self, request_id: str) -> str:
        return self._states[request_id].status

    def active_requests(self) -> int:
        return sum(
            1 for s in self._states.values() if s.status == "queued"
        )

    def slot_occupancy(self) -> float:
        """Mean fraction of slots carrying live work across dispatches."""
        if self._batches == 0:
            return 0.0
        return self._occupied_slots / (self._batches * self.slots)

    def stats(self) -> dict:
        states = self._states.values()
        return {
            "requests": len(self._states),
            "active_requests": self.active_requests(),
            "done": sum(1 for s in states if s.status == "done"),
            "rejected": sum(1 for s in states if s.status == "rejected"),
            "preempted": sum(1 for s in states if s.status == "preempted"),
            "queue_depth": self.scheduler.queue_depth(),
            "batches": self._batches,
            "slot_occupancy": round(self.slot_occupancy(), 4),
        }

    def result(self, request_id: str):
        """The completed request's `CampaignResult` — row r bitwise a
        solo campaign run with ``seeds[r]``. Raises until ``done``."""
        from p2p_gossip_tpu_torch.batch.campaign import CampaignResult

        state = self._states[request_id]
        if state.status == "rejected":
            raise ValueError(
                f"request {request_id} was rejected: {state.reason}"
            )
        if not state.complete:
            raise ValueError(
                f"request {request_id} is {state.status} "
                f"({state.replicas_done}/{state.request.replicas} replicas)"
            )
        return CampaignResult(
            n=state.n,
            seeds=np.asarray(state.request.seeds, dtype=np.int64),
            generated=state.generated,
            received=state.received,
            sent=state.sent,
            degree=state.degree,
            horizon=state.request.horizon,
            wall_s=state.turnaround_s or 0.0,
            batch_size=self.slots,
            coverage=state.coverage,
            extra={
                "request_id": request_id,
                "signature": state.request.signature_key(),
                "cost": state.cost,
            },
        )
