"""Continuous-batching slot scheduler + admission control (the JAX
package's ``serve/scheduler.py``, with the port's own memory model).

The serving problem is the inference server's: many small requests and a
fixed number of replica slots per dispatch. The scheduler bin-packs
compatible work — requests whose `static_signature()` matches — into
those slots:

- Every request decomposes into per-replica **slot units** (one seed =
  one slot). Units queue FIFO per signature.
- A **dispatch** (`next_plan`) fills up to ``slots`` units from the
  signature owning the globally oldest pending unit: freed slots at a
  batch boundary are backfilled from whatever compatible work is queued
  — continuous batching — and units from *different* requests share one
  batch whenever their signatures agree. Short of compatible work, the
  campaign runners' sentinel padding (gen_ticks == horizon) fills the
  idle slots, so a signature's dispatches always have one shape.
- **Admission control** prices a request before it queues: a request
  whose modeled dispatch cannot fit the device budget is rejected up
  front instead of running out of memory mid-dispatch.

The traffic fields of the cost (``bytes_per_tick``, ``flops_per_tick``,
``slot_bytes``, ``request_bytes``) are the JAX package's formulas, value
for value. Residency is the port's own: the JAX package prices a slot
with its sharded engine's rough per-node guess against a TPU's 16 GB of
HBM; the port prices a dispatch as what its campaign runner holds on the
device, counted from the code (`modeled_request_cost`), against the
caller's budget or the card's free memory (the server's choice).

Slot *indices* are semantically inert — a unit's result depends only on
its request's scenario and its own seed, never on which row of the batch
it rides — which is what makes preemption cheap: evicted units simply
requeue (new arrival order, so a resume lands in different slot indices)
and produce bitwise-identical results.

This module is host-only (numpy): the server loop (serve/server.py) owns
every device interaction.
"""

from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np

from p2p_gossip_tpu_torch.serve.request import SimRequest

_WORD_BITS = 32
_WORD_BYTES = 4
_INT_BYTES = 4

# Facts of the campaign runners that the memory model counts: a server
# request runs at a constant delay of 1 tick (a ring of D = 2 slots); the
# flood's pass is the shares word-rounded with a 128-share floor, a
# protocol's at most 128 shares (`batch.campaign`).
_RING_SLOTS = 2
_PASS_FLOOR = 128


def _words(shares: int) -> int:
    return -(-int(shares) // _WORD_BITS)


def staged_graph_bytes(degree: np.ndarray, protocol: str) -> int:
    """Bytes of the `DeviceGraph` a dispatch of ``protocol`` stages once
    for its topology: the flood's default (degree-bucketed from 4,096
    nodes), the protocols' full-width ELL (``bucketed=False``: the picks
    index it)."""
    from p2p_gossip_tpu_torch.engine.sync import _staged_graph_bytes
    from p2p_gossip_tpu_torch.ops.ell import DEFAULT_DEGREE_BLOCK

    bucketed = None if protocol == "flood" else False
    return _staged_graph_bytes(np.asarray(degree), DEFAULT_DEGREE_BLOCK, True, bucketed)


def slot_resident_bytes(request: SimRequest, n: int) -> int:
    """Device bytes one replica slot of a dispatch holds at the dispatch's
    peak, counted from the campaign runner the request's protocol runs (a
    batch of B replicas stacks its state along the rows, so B slots hold B
    times this; 4-byte int32 and 8-byte int64 tensors, 1-byte bools):

    - flood (`batch.campaign.run_coverage_campaign` ->
      `engine.sync._run_chunk_coverage`), at W words a row (the shares with
      a 128-share floor), peaking at the tick update (`ops.kernels.
      tick_update`): ``seen`` and the D-slot frontier ring, the ring's (D,
      N) occupancy, the counters, the tick's (N, W) ``arrivals`` and two
      (N,) temporaries (as `engine.sync.flood_resident_hbm_bytes` counts
      them), the stacked
      ``degree``, the (horizon + 2, S) coverage rows, the pass's int64
      rows and slots and int32 ticks, and under churn the two (N, K)
      interval arrays;
    - protocols (`run_protocol_campaign` -> `models.protocols._run_chunk`),
      at W words a row (at most 128 shares a pass), peaking while
      `_draw_rounds` draws its block of R = min(16, horizon) rounds of c
      picks (E = R c entries a node): the ring, its (D, N) counts, fanout
      push's ``seen``, ``fired``, the int64 ``sent`` and the last pass's
      received and sent; the int64 pick keys and node ids, the int32 row
      seeds, the draw's int64 rows and node ids and int32 degrees; the
      coverage rows of this pass and the last; and per entry the pick
      (int64), the neighbour (int32), the stacked partner (int64), the
      sender row (int32) and the attempt (bool), 25 bytes, then
      - pull: the served row (int64) and the pull row's int64 select and
        int32 copy, 45 in all; under loss the coin's five int64 hash
        temporaries and the kept served row, 73, and 12 a node (the
        seeds, int32 and int64);
      - push-pull and fanout push: at the push plan's stable sort
        (`ops.kernels.scatter_or_plan`) the round offsets and sources
        (int64 each), the keep mask, the int32 keys in and out, the int64
        order, and the sort's own scratch (a second key and value buffer
        and the int64 index input: 20 bytes), 53 more; push-pull also
        keeps its served (int64) and pull rows (int32): 90 and 78 in all;
        under loss the kept coins (one bool a coin) and 4 a node (seeds);
      - under churn one bool an entry (the partner's up bit), 16 a node
        (the block's up mask) and the two (N, K) interval arrays.

    `chip_smoke.py` phase 13 holds the model to the card's peak device
    memory over a flood and a protocol dispatch."""
    from p2p_gossip_tpu_torch.models.protocols import PICK_BLOCK

    n, s, horizon = int(n), int(request.shares), int(request.horizon)
    d = _RING_SLOTS
    lossy, churn = request.loss_prob > 0, request.churn_prob > 0
    intervals = 2 * int(request.max_outages) * 4 if churn else 0
    if request.protocol == "flood":
        w = _words(max(s, _PASS_FLOOR))
        row = w * _WORD_BYTES
        state = (1 + d) * n * row + d * n * 4 + 2 * n * 4
        tick = n * row + 2 * n * 4
        cover = (horizon + 2) * s * 4
        events = w * _WORD_BITS * (8 + 8 + 4)
        return state + tick + n * 4 + cover + events + n * intervals
    w = _words(min(max(s, 1), _PASS_FLOOR))
    row = w * _WORD_BYTES
    c = int(request.fanout) if request.protocol == "pushk" else 1
    entries = min(PICK_BLOCK, horizon) * c
    state = d * row + d * 4 + 4 + 8 + 4 + 8
    if request.protocol == "pushk":
        state += row
    keys = 8 * c + 8 + 4 + 8 + 8 + 4
    per_entry = {"pull": 45, "pushpull": 90, "pushk": 78}[request.protocol]
    per_node = 0
    if lossy:
        per_entry = {"pull": 73, "pushpull": 92, "pushk": 79}[request.protocol]
        per_node += 12 if request.protocol == "pull" else 4
    if churn:
        per_entry += 1
        per_node += 16 + intervals
    cover = 2 * horizon * min(s, w * _WORD_BITS) * 4
    return n * (state + keys + per_node + entries * per_entry) + cover


def modeled_request_cost(request: SimRequest, degree, slots: int = 1) -> dict:
    """Modeled traffic and residency of a request on its graph (host
    arithmetic only, so admission never touches a device).

    The traffic model is the JAX package's, value for value: each tick's
    dominant memory traffic is the neighbour gather over the padded ELL
    (``entries * (w*4 + 4)`` bytes: w words of remote state + the int32
    index per entry) plus the elementwise OR/mask/counter passes
    (``6 * n * w * 4``); flops are the OR-reduce word ops of the same
    gather. Residency is the port's: ``staged_bytes`` the dispatch's
    `DeviceGraph` (`staged_graph_bytes`), ``resident_bytes`` one replica
    slot (`slot_resident_bytes`), ``dispatch_bytes`` the staged graph plus
    ``slots`` slots — what a dispatch of the request holds on the device
    and what admission compares against the budget."""
    degree = np.asarray(degree)
    n = int(degree.shape[0])
    ell_width = max(int(degree.max()) if n else 0, 1)
    entries = n * ell_width
    w = _words(request.shares)
    bytes_per_tick = entries * (w * _WORD_BYTES + _INT_BYTES) + 6 * n * w * _WORD_BYTES
    flops_per_tick = entries * w
    slot_bytes = bytes_per_tick * int(request.horizon)
    staged = staged_graph_bytes(degree, request.protocol)
    resident = slot_resident_bytes(request, n)
    return {
        "bytes_per_tick": int(bytes_per_tick),
        "flops_per_tick": int(flops_per_tick),
        "slot_bytes": int(slot_bytes),
        "request_bytes": int(slot_bytes) * request.replicas,
        "resident_bytes": int(resident),
        "staged_bytes": int(staged),
        "dispatch_bytes": int(staged + resident * int(slots)),
    }


def _mesh_rank_bytes(request: SimRequest, degree: np.ndarray, rb: int, replica_shards: int,
                     k: int, exchange: str, async_k: int) -> tuple[int, int]:
    """(staged, pass) device bytes of one rank of a dispatch on a (replicas,
    nodes) mesh: ``rb`` local replicas over this rank's ``n / k`` rows, in
    the sharded campaign runners' own terms (`parallel.engine_sharded.
    _Runner.resident_bytes` for the flood, `parallel.protocols_sharded.
    _Runner.resident_bytes` for the protocols) for the shape a server
    request takes there: one delay of 1 tick (a sharded ring of 2 slots, 3
    under async K = 2), one pass of the request's shares, coverage on.
    Host arithmetic on the degree array only: the flood's staged shard is
    the whole graph's degree buckets (or full-width ELL, the smaller) over
    ``k``, and the
    delta capacity is the runners' on the largest cut a shard can have
    (none on one node shard, at most ``n / k`` rows otherwise); the hub
    exchange is priced as the delta one (its hub ring rows uncounted)."""
    from p2p_gossip_tpu_torch.parallel.async_ticks import (
        effective_ring,
        group_offsets,
        parse_exchange,
    )
    from p2p_gossip_tpu_torch.parallel.exchange import delta_capacity

    n, s, horizon = int(degree.shape[0]), int(request.shares), int(request.horizon)
    n_padded = -(-n // k) * k
    n_loc = n_padded // k
    w = _words(max(1, s))
    row = w * _WORD_BYTES
    loc, glob = rb * n_loc * row, rb * n_padded * row
    transpose = glob if rb > 1 and k > 1 else 0
    transport, k_async = parse_exchange(exchange, async_k)
    ring = effective_ring(_RING_SLOTS, k_async)
    delta = transport in ("delta", "hub") or (transport == "auto" and k > 1)
    outages = int(request.max_outages) if request.churn_prob > 0 else 0
    # The coverage rows: the flood's of the shares, a protocol's of its pass.
    cover = rb * (replica_shards + 1) * horizon * 4
    if request.protocol == "flood":
        cover *= s
        capacity = delta_capacity(n_loc if k > 1 else 1, n_loc, w) if delta else 0
        from p2p_gossip_tpu_torch.engine.sync import _staged_graph_bytes
        from p2p_gossip_tpu_torch.ops.ell import DEFAULT_DEGREE_BLOCK

        # The shard's degree buckets, or its direct ELL where bucketing saves
        # little (`stage_sharded_graph`'s rule).
        staged = min(_staged_graph_bytes(degree, DEFAULT_DEGREE_BLOCK, True, bucketed)
                     for bucketed in (True, False)) // k
        staged += n_loc * k if delta else 0
        staged += rb * n_loc * 4 if rb > 1 else 0
        passed = 2 * rb * n_loc * outages * 4
        state = rb * ((ring + 1) * n_loc * row + 2 * n_loc * 4) + cover
        state += rb * 2 * ring * k * capacity * 4
        offs = group_offsets((1,), k_async)[0] if k_async else ()
        canvases = len(offs) * (1 if delta else 2) if offs else 1
        tick = loc + canvases * glob + rb * n_padded * 4 + transpose
        return staged, passed + state + tick
    anti = request.protocol != "pushk"
    delta = delta and anti
    landed = k_async > 0 and not delta
    picks = int(request.fanout) if request.protocol == "pushk" else 1
    dmax = max(int(degree.max()) if n else 0, 1)
    capacity = delta_capacity(n_loc, n_loc, w) if delta else 0
    staged = n_loc * (8 * dmax + 8 + 1 + 8 + 8) + (n_loc if delta else 0)
    staged += rb * n_loc * (8 + 1 + 8 + 8 + 8) if rb > 1 else 0
    staged += rb * n_loc * (picks + 1) * 8
    passed = 2 * rb * n_padded * outages * 4
    state = rb * ring * n_loc * row + loc + rb * n_loc * 12 + cover * w * _WORD_BITS
    if delta:
        state += 2 * glob + rb * 2 * ring * k * capacity * 4
    elif landed:
        state += glob
    own = 0 if request.protocol == "pull" else picks * loc
    pulled = loc if anti else 0
    read = 3 * loc + (0 if delta or landed else glob + transpose) if anti else 0
    peaks = [own + read, 3 * loc + (rb * n_padded * 8 if request.protocol == "pull" else 0)]
    if request.protocol != "pull":
        peaks.append(own + pulled + 2 * glob + loc)
    if delta:
        peaks.append(2 * loc + max(loc, 2 * rb * capacity * 4))
    if landed:
        peaks.append(loc + glob + transpose)
    return staged, passed + state + max(peaks)


def mesh_request_cost(request: SimRequest, degree, slots: int, replica_shards: int,
                      node_shards: int, exchange: str = "dense", async_k: int = 2) -> dict:
    """`modeled_request_cost` for a server on a (replicas, nodes) mesh, per
    rank: the traffic fields are the JAX package's, value for value;
    ``staged_bytes`` and ``resident_bytes`` are one rank's staged operands
    and pass state with ``slots / replica_shards`` local replicas over ``n /
    node_shards`` rows (`_mesh_rank_bytes`), ``dispatch_bytes`` their sum:
    what admission holds against the smallest budget of the mesh's ranks.
    Every rank computes the same numbers."""
    degree = np.asarray(degree)
    cost = modeled_request_cost(request, degree, slots)
    rb = int(slots) // int(replica_shards)
    staged, resident = _mesh_rank_bytes(request, degree, rb, int(replica_shards),
                                        int(node_shards), exchange, async_k)
    cost.update(resident_bytes=int(resident), staged_bytes=int(staged),
                dispatch_bytes=int(staged + resident), replica_shards=int(replica_shards),
                node_shards=int(node_shards), local_replicas=rb)
    return cost


@dataclasses.dataclass(frozen=True)
class SlotUnit:
    """One replica of one request: the scheduler's unit of work. ``seq``
    is the global arrival order — re-issued on requeue, which is why a
    resumed request lands in different slot indices."""

    request_id: str
    replica: int
    seq: int


@dataclasses.dataclass
class BatchPlan:
    """One dispatch: up to ``slots`` same-signature units. Slots beyond
    ``occupied`` are sentinel padding inside the campaign runners."""

    signature_key: str
    units: list
    slots: int

    @property
    def occupied(self) -> int:
        return len(self.units)

    @property
    def request_ids(self) -> list[str]:
        seen: dict = {}
        for u in self.units:
            seen.setdefault(u.request_id, None)
        return list(seen)


class SlotScheduler:
    """Per-signature FIFO unit queues + the slot packer. The server owns
    request state; the scheduler owns only pending units and the
    admission arithmetic."""

    def __init__(self, slots: int = 8):
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        self.slots = int(slots)
        self._queues: dict[str, deque] = {}
        self._seq = 0

    # -- admission ---------------------------------------------------------

    def admit(
        self,
        request: SimRequest,
        degree,
        hbm_budget_bytes: float | None = None,
        max_request_bytes: int | None = None,
        cost: dict | None = None,
    ) -> tuple[bool, dict, str | None]:
        """(admitted, cost, reason). A full dispatch holds the staged graph
        and ``slots`` replica slots, so the fit test is
        ``dispatch_bytes <= hbm_budget_bytes``; a budget of None or 0
        checks nothing (the server passes the card's free memory, 0 on the
        CPU). ``max_request_bytes`` optionally caps a single request's
        total modeled traffic (a service-level knob, off by default).
        ``cost`` replaces the single-device model (a mesh server passes
        `mesh_request_cost`, one rank's bytes)."""
        if cost is None:
            cost = modeled_request_cost(request, degree, self.slots)
        if hbm_budget_bytes and cost["dispatch_bytes"] > hbm_budget_bytes:
            held = (f"{cost['resident_bytes']} for {cost['local_replicas']} local replicas "
                    "a rank" if "local_replicas" in cost
                    else f"{cost['resident_bytes']} x {self.slots} slots")
            return False, cost, (
                f"modeled dispatch footprint {cost['dispatch_bytes']} bytes "
                f"(staged graph {cost['staged_bytes']} + {held}) exceeds the "
                f"{int(hbm_budget_bytes)}-byte HBM budget"
            )
        if max_request_bytes is not None and cost["request_bytes"] > max_request_bytes:
            return False, cost, (
                f"modeled request traffic {cost['request_bytes']} bytes "
                f"exceeds the per-request cap {max_request_bytes}"
            )
        return True, cost, None

    # -- queue surface -----------------------------------------------------

    def enqueue(self, request: SimRequest, replicas: "list[int] | None" = None) -> int:
        """Queue one unit per replica (or per entry of ``replicas`` — the
        resume path queues only the not-yet-done subset). Returns the
        number of units queued."""
        key = request.signature_key()
        q = self._queues.setdefault(key, deque())
        idxs = range(request.replicas) if replicas is None else replicas
        count = 0
        for r in idxs:
            q.append(SlotUnit(request.request_id, int(r), self._seq))
            self._seq += 1
            count += 1
        return count

    def remove(self, request_id: str) -> int:
        """Drop every pending unit of a request (the eviction half of
        preemption). Units already dispatched are the server's problem —
        dispatches are atomic at batch boundaries."""
        dropped = 0
        for key in list(self._queues):
            q = self._queues[key]
            kept = deque(u for u in q if u.request_id != request_id)
            dropped += len(q) - len(kept)
            if kept:
                self._queues[key] = kept
            else:
                del self._queues[key]
        return dropped

    def queue_depth(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def pending_requests(self) -> set:
        return {u.request_id for q in self._queues.values() for u in q}

    def next_plan(self) -> BatchPlan | None:
        """The next dispatch: the signature owning the globally oldest
        pending unit, packed FIFO up to ``slots`` units. None when
        idle."""
        best_key, best_seq = None, None
        for key, q in self._queues.items():
            if q and (best_seq is None or q[0].seq < best_seq):
                best_key, best_seq = key, q[0].seq
        if best_key is None:
            return None
        q = self._queues[best_key]
        units = [q.popleft() for _ in range(min(self.slots, len(q)))]
        if not q:
            del self._queues[best_key]
        return BatchPlan(signature_key=best_key, units=units, slots=self.slots)
