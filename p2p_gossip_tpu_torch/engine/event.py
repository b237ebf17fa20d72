"""Exact discrete-event gossip engine (Python) — the JAX package's
``engine/event.py``, ported line for line: the same events in the same
order give the same counters, snapshots, message records and log lines.
It runs on the host in both packages (numpy and heapq only); it is the
NS-3-semantics specification the tick engine is held to, not a device
path.

This is the NS-3 role in our framework: a message-level event-driven simulator
with the reference's exact application semantics (p2pnode.cc):

- a generation event inserts the share into the origin's seen-set
  (p2pnode.cc:120) and broadcasts to all peers (`GossipShareToPeers`,
  p2pnode.cc:127), counting one ``sent`` per peer;
- a message arrival at a node that has seen the share is dropped with NO
  counter change (p2pnode.cc:189);
- a first-time arrival increments ``received`` and ``forwarded`` together
  (p2pnode.cc:155-164) and re-broadcasts to ALL peers including the sender;
- events at tick >= horizon never fire (Simulator::Stop).

Time is integer ticks (one tick = the latency quantum), which is what makes
bit-exact parity with the synchronous tick engine (`engine.sync`) testable:
same topology + same schedule + same integer delays => identical counters.

A C++ implementation of the same loop lives in native/gossip_native.cc
(`runtime.native`); this Python version is the readable specification.
"""

from __future__ import annotations

import heapq

import numpy as np

from p2p_gossip_tpu_torch.models.generation import Schedule
from p2p_gossip_tpu_torch.models.topology import Graph
from p2p_gossip_tpu_torch.utils import logging as p2plog
from p2p_gossip_tpu_torch.utils.stats import NodeStats

log = p2plog.get_logger("Engine.Event")


def run_event_sim(
    graph: Graph,
    schedule: Schedule,
    horizon_ticks: int,
    ell_delays: np.ndarray | None = None,
    constant_delay: int = 1,
    coverage_slots: int | None = None,
    snapshot_ticks: list[int] | None = None,
    churn=None,
    loss=None,
    record_messages: bool = False,
    connect_tick: int = 0,
    fifo_links=None,
    on_tick=None,
) -> NodeStats:
    """Run the event-driven gossip simulation for ``horizon_ticks`` ticks.

    ``ell_delays`` (aligned with ``graph.ell()``) gives per-edge integer
    delays; otherwise every edge takes ``constant_delay`` ticks.

    ``churn`` is an optional `models.churn.ChurnModel`: a generation event
    whose origin is down is skipped outright, and a message arriving at a
    down node is lost (dropped, NOT marked seen — a later copy can still be
    delivered). Identical counters to the sync engine under the same model.

    ``loss`` is an optional `models.linkloss.LinkLossModel`: a message
    crossing link (u -> v) with arrival tick t is dropped in flight iff
    the model's counter-based coin fires for (u, v, t) — the sender's
    ``sent`` still counts. Same coins, hence identical counters, on the
    tick engine.

    Returns per-node counters; if ``coverage_slots`` is set, also records each
    listed share's first-arrival tick per node in ``stats.extra``.

    ``connect_tick`` models the reference's socket warm-up window
    (peers connect at t=5 s, p2pnetwork.cc:93-96, while generation can
    start earlier): before it, a broadcast finds no sockets — nothing is
    sent and no ``sent`` is charged (GossipShareToPeers skips missing
    sockets without counting, p2pnode.cc:131-135) — so shares generated
    pre-connect stay with their origin forever. 0 (default) =
    connected-from-t0, the rebuild's base semantics (SURVEY §1
    deviation 2).

    ``fifo_links`` is an optional `models.latency.FifoLinkModel`:
    messages on one directed link serialize through a FIFO queue (the
    reference's NS-3 DataRate behavior, p2pnetwork.cc:113 — SURVEY
    deviation #5) instead of each being charged an independent delay.
    ``ell_delays``/``constant_delay`` then carry pure propagation
    latency; serialization time lives in the model. All broadcasts of a
    tick are enqueued in ascending (node, share) — a canonical order
    shared with the C++ engine, which stays bit-identical under
    contention (see FifoLinkModel). With no contention this reproduces
    `serialization_delays`' closed form exactly.

    ``record_messages`` captures every transmitted message as
    ``stats.extra["messages"]`` — a list of (src, dst, share, tx_tick,
    rx_tick, outcome) with outcome in {"delivered", "duplicate", "down",
    "lost", "horizon"} — the per-packet record the reference gets from
    NetAnim's ``EnablePacketMetadata`` (p2pnetwork.cc:187), here exact
    rather than pcap-level. O(messages) memory: use at visualization
    scale, not at 1M nodes.

    ``on_tick(t, seen, received, sent)`` is an optional per-tick hook,
    called exactly once for every tick ``t`` in [0, horizon_ticks) —
    including quiet ticks — AFTER every event of tick ``t`` has been
    processed (and, under ``fifo_links``, after the tick's queue flush,
    so ``sent`` is fully charged). The arguments are live views of the
    engine state (``seen`` is the list of per-node share sets); don't
    mutate them: a digest of the host engine's state taken here lines up
    with the tick engine's per-tick digests.
    """
    n = graph.n
    indptr, indices = graph.indptr, graph.indices
    if ell_delays is not None:
        rows, pos = graph.csr_rows_pos()
        csr_delays = ell_delays[rows, pos].astype(np.int64)
    else:
        csr_delays = np.full(indices.shape[0], constant_delay, dtype=np.int64)

    generated = np.zeros(n, dtype=np.int64)
    received = np.zeros(n, dtype=np.int64)
    forwarded = np.zeros(n, dtype=np.int64)
    sent = np.zeros(n, dtype=np.int64)
    seen: list[set[int]] = [set() for _ in range(n)]
    arrival_ticks = (
        np.full((coverage_slots, n), -1, dtype=np.int64)
        if coverage_slots
        else None
    )

    events_processed = 0
    # Heap of (tick, seq, kind, node, share); kind 0 = generation, 1 = message.
    # seq keeps ordering deterministic; same-tick duplicates resolve the same
    # way regardless of order because dedup is order-independent within a tick
    # (all same-tick arrivals of a share are dropped after the first).
    heap: list[tuple[int, int, int, int, int]] = []
    seq = 0
    # Per-message records (record_messages): row = [src, dst, share, tx,
    # rx, outcome]; in-flight messages are found again at delivery by seq.
    messages: list[list] = []
    msg_by_seq: dict[int, int] = {}
    for s in range(schedule.num_shares):
        t = int(schedule.gen_ticks[s])
        if t < horizon_ticks:
            heap.append((t, seq, 0, int(schedule.origins[s]), s))
            seq += 1
    heapq.heapify(heap)

    if loss is not None:
        from p2p_gossip_tpu_torch.models.linkloss import drop_mask_np

        loss_threshold, loss_seed = loss.static_cfg

    # ser_micro == 0 is OFF, matching the C++ engine's `fifo_ser_micro >
    # 0` gate exactly — a zero-serialization queue is a no-op anyway
    # (delays are >= 1 tick), but parity must rest on the shared gate,
    # not on the no-op being accidental.
    fifo = fifo_links is not None and fifo_links.ser_micro > 0
    if fifo:
        from p2p_gossip_tpu_torch.models.latency import MICROTICKS

        ser_micro = fifo_links.ser_micro
        # Per-directed-link "busy until" in integer micro-ticks, indexed
        # by CSR entry (each directed entry IS one link-direction).
        busy = np.zeros(indices.shape[0], dtype=np.int64)
        pending: list[tuple[int, int]] = []  # (node, share) of this tick

    def flush_fifo(now: int) -> None:
        """Charge the tick's broadcasts through the link queues in the
        canonical (node, share) order and schedule the arrivals. Safe to
        run at tick end: all delays are >= 1 tick, so nothing flushed
        here can pop at ``now``."""
        nonlocal seq
        now_micro = now * MICROTICKS
        for node, share in sorted(pending):
            lo, hi = indptr[node], indptr[node + 1]
            sent[node] += hi - lo
            # One message per link-direction: the whole broadcast charges
            # each queue once, so the update vectorizes exactly.
            start = np.maximum(now_micro, busy[lo:hi])
            busy[lo:hi] = start + ser_micro
            t_arrs = (
                busy[lo:hi] + csr_delays[lo:hi] * MICROTICKS
                + MICROTICKS // 2
            ) // MICROTICKS
            np.maximum(t_arrs, now + 1, out=t_arrs)
            if loss is not None:
                dropped = drop_mask_np(
                    node, indices[lo:hi], t_arrs, loss_threshold, loss_seed,
                )
            for k, e in enumerate(range(lo, hi)):
                t_arr = int(t_arrs[k])
                dst = int(indices[e])
                # Same outcome precedence as the per-message path: a
                # dropped message was lost first even if also
                # past-horizon. Either way it OCCUPIED the link (the
                # transmission happened; busy is already charged).
                if loss is not None and dropped[k]:
                    if record_messages:
                        messages.append(
                            [node, dst, share, now, t_arr, "lost"]
                        )
                    continue
                if t_arr >= horizon_ticks:
                    if record_messages:
                        messages.append(
                            [node, dst, share, now, t_arr, "horizon"]
                        )
                    continue
                if record_messages:
                    msg_by_seq[seq] = len(messages)
                    messages.append(
                        [node, dst, share, now, t_arr, "delivered"]
                    )
                heapq.heappush(heap, (t_arr, seq, 1, dst, share))
                seq += 1
        pending.clear()

    def broadcast(node: int, share: int, now: int) -> None:
        nonlocal seq
        if now < connect_tick:
            # Warm-up window: no sockets yet — nothing sent, nothing
            # charged (p2pnode.cc:131-135), and (fifo) no queue occupied.
            return
        if fifo:
            # Defer to the tick-end flush: the canonical (node, share)
            # service order can only be established once the tick's full
            # broadcast set is known.
            pending.append((node, share))
            return
        lo, hi = indptr[node], indptr[node + 1]
        sent[node] += hi - lo
        if loss is not None:
            # One vectorized coin evaluation per broadcast, not per edge.
            dropped = drop_mask_np(
                node, indices[lo:hi], now + csr_delays[lo:hi],
                loss_threshold, loss_seed,
            )
        for k, e in enumerate(range(lo, hi)):
            t_arr = now + int(csr_delays[e])
            dst = int(indices[e])
            # Outcome precedence: "lost" before "horizon" — the loss coin
            # fires at send time, so a message that is both dropped and
            # past-horizon was lost first. Counters are unaffected either
            # way (both outcomes skip the heap push); this only fixes the
            # anim/packet-trace attribution.
            if loss is not None and dropped[k]:
                if record_messages:
                    messages.append([node, dst, share, now, t_arr, "lost"])
                continue
            if t_arr >= horizon_ticks:
                if record_messages:
                    messages.append([node, dst, share, now, t_arr, "horizon"])
                continue
            if record_messages:
                msg_by_seq[seq] = len(messages)
                messages.append([node, dst, share, now, t_arr, "delivered"])
            heapq.heappush(heap, (t_arr, seq, 1, dst, share))
            seq += 1

    # Periodic-stats snapshots (PrintPeriodicStats, p2pnetwork.cc:231):
    # totals captured the moment simulated time crosses each boundary.
    snapshots: list[dict] = []
    boundaries = sorted(snapshot_ticks) if snapshot_ticks else []
    bi = 0

    def take_snapshots(now: int) -> None:
        nonlocal bi
        while bi < len(boundaries) and boundaries[bi] <= now:
            snapshots.append(
                {
                    "tick": boundaries[bi],
                    "generated": int(generated.sum()),
                    "processed": int(generated.sum() + received.sum()),
                    "connections": int(graph.degree.sum()),
                }
            )
            bi += 1

    log.info(
        f"starting event simulation: {n} nodes, {graph.num_edges} links, "
        f"{schedule.num_shares} shares, horizon {horizon_ticks} ticks"
    )
    # Per-event tracing mirrors the reference's NS_LOG_INFO lines in
    # GenerateAndGossipShare / ReceiveShare (p2pnode.cc:121,161); guarded so a
    # silent run pays one compare per event.
    trace = log.enabled(p2plog.LOG_LOGIC)

    if churn is not None:
        c_start, c_end = churn.down_start, churn.down_end

        def is_up(node: int, t: int) -> bool:
            return not ((c_start[node] <= t) & (t < c_end[node])).any()

    # on_tick bookkeeping: cur_t is the first tick not yet finalized.
    cur_t = 0

    def finalize_ticks(upto: int) -> None:
        """Fire on_tick for every completed tick in [cur_t, upto) —
        quiet ticks included, so hook streams align with the sync
        kernels' one-digest-per-tick rings."""
        nonlocal cur_t
        if on_tick is None:
            cur_t = max(cur_t, upto)
            return
        while cur_t < upto:
            on_tick(cur_t, seen, received, sent)
            cur_t += 1

    t = 0
    while True:
        if fifo and pending and (not heap or heap[0][0] > t):
            # Tick boundary: every event of tick t has popped (ticks are
            # popped in nondecreasing order and flushed arrivals are all
            # >= t+1). Checked at the loop head — the body's `continue`
            # paths (duplicates, churn drops) must not skip it — and the
            # flush may refill an empty heap, so it also gates the exit.
            flush_fifo(t)
        if not heap:
            break
        # Every tick before the heap head is complete (pops are
        # nondecreasing and any fifo flush for tick t already ran).
        finalize_ticks(heap[0][0])
        t, ev_seq, kind, node, share = heapq.heappop(heap)
        take_snapshots(t)
        events_processed += 1
        if churn is not None and not is_up(node, t):
            if trace:
                log.logic(
                    f"Node {node} is down, "
                    + ("generation skipped" if kind == 0 else "share lost"),
                    sim_time=t,
                )
            if record_messages and kind == 1:
                messages[msg_by_seq[ev_seq]][5] = "down"
            continue
        if kind == 0:
            generated[node] += 1
            seen[node].add(share)
            if trace:
                log.debug(f"Node {node} generated share {share}", sim_time=t)
            if arrival_ticks is not None and share < arrival_ticks.shape[0]:
                arrival_ticks[share, node] = t
            broadcast(node, share, t)
        else:
            if share in seen[node]:
                if trace:
                    log.logic(
                        f"Node {node} dropped duplicate share {share}", sim_time=t
                    )
                if record_messages:
                    messages[msg_by_seq[ev_seq]][5] = "duplicate"
                continue
            seen[node].add(share)
            received[node] += 1
            forwarded[node] += 1
            if trace:
                log.debug(
                    f"Node {node} received new share {share}, forwarding",
                    sim_time=t,
                )
            if arrival_ticks is not None and share < arrival_ticks.shape[0]:
                arrival_ticks[share, node] = t
            broadcast(node, share, t)

    # Quiescence before the horizon: the remaining ticks are quiet but
    # still owed to the hook (constant-state digests).
    finalize_ticks(horizon_ticks)

    stats = NodeStats(
        generated=generated.astype(np.int64),
        received=received.astype(np.int64),
        forwarded=forwarded.astype(np.int64),
        sent=sent.astype(np.int64),
        processed=(generated + received).astype(np.int64),
        degree=graph.degree.astype(np.int64),
    )
    take_snapshots(horizon_ticks)
    log.info(f"event simulation done: {events_processed} events processed")
    stats.extra["events_processed"] = events_processed
    if snapshot_ticks is not None:
        # Present (possibly empty) whenever snapshots were requested — the
        # same key-presence convention as the sync and native engines.
        stats.extra["snapshots"] = snapshots
    if arrival_ticks is not None:
        stats.extra["arrival_ticks"] = arrival_ticks
    if record_messages:
        stats.extra["messages"] = [tuple(m) for m in messages]
    return stats


def run_event_partnered_sim(
    graph: Graph,
    schedule: Schedule,
    horizon_ticks: int,
    protocol: str = "pushpull",
    fanout: int = 2,
    seed: int = 0,
    churn=None,
    loss=None,
) -> NodeStats:
    """Host leg of the random-partner protocols: the numpy oracles
    (models/protocols.py) driven by the seeded picks computed on the host
    — no device, no native library, counters identical to every other
    engine for the same seed. One-tick-delay model only (the oracles'
    scope); per-edge delays need the device or native engines."""
    from p2p_gossip_tpu_torch.models.protocols import (
        pushk_oracle,
        pushpull_oracle,
        seeded_partners,
    )

    if protocol in ("pushpull", "pull"):
        picks = seeded_partners(graph, horizon_ticks, seed)
        return pushpull_oracle(
            graph, schedule, horizon_ticks, picks, churn=churn, loss=loss,
            mode=protocol,
        )
    if protocol == "pushk":
        if fanout < 1:
            raise ValueError(f"fanout must be >= 1, got {fanout}")
        picks = seeded_partners(graph, horizon_ticks, seed, fanout=fanout)
        return pushk_oracle(
            graph, schedule, horizon_ticks, picks, churn=churn, loss=loss
        )
    raise ValueError(f"unknown protocol {protocol!r}")
