"""Synchronous tick engine on PyTorch — the flood engine's main path.

The NS-3 event loop becomes a synchronous graph message-passing simulation:

- one **tick** delivers every in-flight message at once: a gather-OR over
  the ELL adjacency reading a ring of past frontiers (`ops.ell`, one
  ``gather_or`` kernel launch per degree bucket on the GPU). Beside the
  ring the engine keeps each slot's per-row sector occupancy (the
  ``sector_occupancy`` kernel, run on the slot the tick writes), so the
  gather reads only the sectors of a source row that hold bits;
- the per-node seen-set (p2pnode.h:38) is an (N x S/32) int32 bitmask;
- generation events (`GenerateAndGossipShare`, p2pnode.cc:106) are
  pre-sampled host-side and scattered into the frontier at their tick;
- counters (p2pnode.h:40-43) update from the ``popcount_rows`` kernel;
- a Python loop advances time until no message is in flight and no
  generation is pending (or the horizon). Its predicate is read on the
  host once per tick — one device sync per tick.

Share counts of any size run in fixed-size chunks (shares are independent,
counters add). Semantics are tick-exact against the JAX package's
``engine/sync.py``: same graph + schedule + integer delays give identical
per-node counters, executed-tick counts and coverage rows.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from p2p_gossip_tpu_torch.models.generation import Schedule
from p2p_gossip_tpu_torch.models.topology import Graph
from p2p_gossip_tpu_torch.ops import bitmask, kernels
from p2p_gossip_tpu_torch.ops.ell import (
    build_degree_buckets,
    detect_uniform_delay,
    propagate,
    propagate_bucketed,
    propagate_uniform,
)
from p2p_gossip_tpu_torch.utils.device import resolve_device
from p2p_gossip_tpu_torch.utils.stats import NodeStats

DEFAULT_CHUNK_SIZE = 4096

# Kept at the JAX package's value so chunking, and with it the executed
# tick count, matches the reference engine; not tuned for the GPU.
MIN_CHUNK_SHARES = 4096


@dataclasses.dataclass(frozen=True)
class DeviceGraph:
    """Graph + latency model staged onto a device in ELL layout."""

    n: int
    ell_idx: torch.Tensor    # (N, dmax) int32
    ell_delay: torch.Tensor  # (N, dmax) int32, >= 1
    ell_mask: torch.Tensor   # (N, dmax) bool
    degree: torch.Tensor     # (N,) int32
    ring_size: int           # D = max delay + 1
    uniform_delay: int | None = None  # set when every edge has this delay
    buckets: tuple | None = None  # ((rows, idx, mask, delay|None), ...)

    @property
    def device(self) -> torch.device:
        return self.degree.device

    @staticmethod
    def build(
        graph: Graph,
        ell_delays: np.ndarray | None = None,
        constant_delay: int = 1,
        *,
        bucketed: bool | None = None,
        device=None,
    ) -> "DeviceGraph":
        """Stage ``graph`` as the JAX package's ``DeviceGraph.build`` does:
        degree-bucketed ELL by default from 4096 nodes up (``bucketed=
        None``), full-width otherwise; uniform delays stage no per-edge
        delay array."""
        device = resolve_device(device)
        if bucketed is None:
            bucketed = graph.n >= 4096
        placeholder = np.ones((1, 1), dtype=np.int32)
        buckets = None
        if ell_delays is None and bucketed:
            # Bucket ELLs straight from CSR: the global ELL is never built.
            uniform = constant_delay
            dmax_delay = constant_delay
            buckets = build_degree_buckets(graph, None)
            ell_idx = ell_delays = placeholder
            ell_mask = placeholder.astype(bool)
        else:
            ell_idx, ell_mask = graph.ell()
            if ell_delays is None:
                ell_delays = np.full(ell_idx.shape, constant_delay, dtype=np.int32)
            dmax_delay = int(ell_delays.max()) if ell_delays.size else 1
            uniform = detect_uniform_delay(ell_delays, ell_mask)
            if bucketed:
                buckets = build_degree_buckets(
                    graph,
                    None if uniform is not None else ell_delays,
                    ell=(ell_idx, ell_mask),
                )
                ell_idx = ell_delays = placeholder
                ell_mask = placeholder.astype(bool)
            elif uniform is not None:
                ell_delays = placeholder
        return DeviceGraph.from_numpy(
            graph.n, ell_idx, ell_delays, ell_mask, graph.degree,
            dmax_delay + 1, uniform, buckets, device=device,
        )

    @staticmethod
    def from_numpy(
        n, ell_idx, ell_delay, ell_mask, degree, ring_size,
        uniform_delay=None, buckets=None, *, device,
    ) -> "DeviceGraph":
        """Move host arrays (numpy, or anything ``np.asarray`` takes) onto
        ``device`` with the engine's dtypes."""

        def host(a, dtype):
            # Contiguous and writable (arrays exported by JAX are read-only).
            return np.require(np.asarray(a), dtype, requirements=["C", "W"])

        def i32(a):
            return torch.as_tensor(host(a, np.int32), device=device)

        def mask(a):
            return torch.as_tensor(host(a, bool), device=device)

        staged = None
        if buckets is not None:
            staged = tuple(
                (i32(rows), i32(idx), mask(msk), None if dly is None else i32(dly))
                for rows, idx, msk, dly in buckets
            )
        return DeviceGraph(
            n=int(n),
            ell_idx=i32(ell_idx),
            ell_delay=i32(ell_delay),
            ell_mask=mask(ell_mask),
            degree=i32(degree),
            ring_size=int(ring_size),
            uniform_delay=None if uniform_delay is None else int(uniform_delay),
            buckets=staged,
        )

    def must_move_bytes_per_tick(self, w: int) -> int:
        """The least device-memory traffic of one tick at W words per row,
        each input read once and each output written once: the source
        rows the gather needs (one per distinct source of a valid edge, or
        per distinct (delay, source) pair with per-edge delays) with their
        occupancy words; the staged ELL (int32 index and bool mask, int32
        delay when per-edge, int32 bucket rows); ``seen`` read and
        written; the new frontier slot and its occupancy written; the
        int32 counters ``received`` and ``sent`` read and written and
        ``degree`` read. Intermediates of the unfused tick (arrivals,
        ~seen, the generation bits) are not counted. Over the card's
        memory rate this is the least time a tick can take."""
        if self.buckets is not None:
            parts = self.buckets
        else:
            parts = ((None, self.ell_idx, self.ell_mask, self.ell_delay),)
        per_edge = self.uniform_delay is None
        staged = row_bytes = 0
        keys = []
        for rows, idx, mask, delay in parts:
            staged += int(idx.numel())
            row_bytes += 0 if rows is None else 4 * int(rows.numel())
            key = idx.to(torch.int64)
            if per_edge:
                key = delay.to(torch.int64) * self.n + key
            keys.append(key[mask])
        src_rows = int(torch.unique(torch.cat(keys)).numel())
        gather = src_rows * (w + 1) * 4 + staged * (9 if per_edge else 5) + row_bytes
        return gather + self.n * (3 * w * 4 + 4 + 5 * 4)


def apply_tick_updates(
    seen, arrivals, gen_bits, gen_cnt, received, sent, degree, *,
    out=None, plain: bool = False,
):
    """The counter semantics of one tick (p2pnode.cc ReceiveShare /
    GenerateAndGossipShare): dedup against ``seen``, count first-time
    receives, and charge one send per peer per processed share.

    Updates ``seen``, ``received`` and ``sent`` in place (int32, wrapping
    exactly as the JAX engine's counters) and writes ``newly_out`` — the
    frontier this tick contributes to its delay-line slot — into ``out``
    when given. Returns (seen, newly_out, received, sent, newly_cnt)."""
    newly = arrivals & ~seen
    newly_cnt = bitmask.popcount_rows(newly, plain=plain)
    seen |= arrivals
    seen |= gen_bits
    newly_out = torch.bitwise_or(newly, gen_bits, out=out)
    received += newly_cnt
    sent += (newly_cnt + gen_cnt) * degree
    return seen, newly_out, received, sent, newly_cnt


def _gather(dg: DeviceGraph, hist: torch.Tensor, occ: torch.Tensor, t: int, plain: bool):
    if dg.buckets is not None:
        return propagate_bucketed(
            hist, t, dg.buckets, n_out=dg.n, ring_size=dg.ring_size,
            uniform_delay=dg.uniform_delay, occ=occ, plain=plain,
        )
    if dg.uniform_delay is not None:
        return propagate_uniform(
            hist, t, dg.ell_idx, dg.ell_mask, ring_size=dg.ring_size,
            uniform_delay=dg.uniform_delay, occ=occ, plain=plain,
        )
    return propagate(
        hist, t, dg.ell_idx, dg.ell_delay, dg.ell_mask,
        ring_size=dg.ring_size, occ=occ, plain=plain,
    )


def _tick(dg, t, seen, hist, occ, received, sent, origins, slots, gen_ticks, plain):
    """One synchronous tick at time ``t``: gather arrivals, scatter this
    tick's generations, update seen and the counters, and write the new
    frontier into hist slot ``t mod D`` and its sector occupancy into occ
    slot ``t mod D``. Returns that slot's frontier and a 0-d device tensor
    telling whether it holds any bit."""
    n, w = seen.shape
    arrivals = _gather(dg, hist, occ, t, plain)
    gen_active = gen_ticks == t
    gen_bits = bitmask.slot_scatter(n, w, origins, slots, gen_active)
    gen_cnt = torch.zeros((n,), dtype=torch.int32, device=seen.device)
    gen_cnt.index_add_(0, origins, gen_active.to(torch.int32))
    slot = hist[t % dg.ring_size]
    _, newly_out, _, _, newly_cnt = apply_tick_updates(
        seen, arrivals, gen_bits, gen_cnt, received, sent, dg.degree,
        out=slot, plain=plain,
    )
    kernels.sector_occupancy(slot, out=occ[t % dg.ring_size], plain=plain)
    # newly_out = newly | gen_bits holds a bit iff a node newly processed a
    # share or a generation fired — read from the two small count vectors
    # instead of another (N, W) pass.
    nonzero = (newly_cnt.sum() + gen_cnt.sum()) > 0
    return newly_out, nonzero


def _chunk_state(dg: DeviceGraph, w: int):
    """Zeroed chunk state: seen (N, W), the frontier ring hist (D, N, W)
    with its sector occupancy occ (D, N) (all clear, as the ring is
    zero), and the int32 counters received and sent (N,)."""
    dev = dg.device
    seen = torch.zeros((dg.n, w), dtype=torch.int32, device=dev)
    hist = torch.zeros((dg.ring_size, dg.n, w), dtype=torch.int32, device=dev)
    occ = torch.zeros((dg.ring_size, dg.n), dtype=torch.int32, device=dev)
    received = torch.zeros((dg.n,), dtype=torch.int32, device=dev)
    sent = torch.zeros((dg.n,), dtype=torch.int32, device=dev)
    return seen, hist, occ, received, sent


def _run_chunk_while(
    dg: DeviceGraph,
    origins: torch.Tensor,    # (S,) int64 on dg.device
    gen_ticks: torch.Tensor,  # (S,) int32 (>= horizon entries never fire)
    t_start: int,
    last_gen: int,
    *,
    chunk_size: int,
    horizon: int,
    plain: bool = False,
):
    """Run one share chunk to quiescence (or the horizon). Returns (seen,
    received, sent, ticks executed). The loop predicate — a message in
    flight in any hist slot, or a generation still pending — is the JAX
    engine's ``any(hist != 0) | t <= last_gen``, kept as one host flag per
    ring slot."""
    w = bitmask.num_words(chunk_size)
    slots = torch.arange(chunk_size, dtype=torch.int64, device=dg.device)
    seen, hist, occ, received, sent = _chunk_state(dg, w)
    in_flight = [False] * dg.ring_size
    t = t_start
    while t < horizon and (any(in_flight) or t <= last_gen):
        _, nonzero = _tick(
            dg, t, seen, hist, occ, received, sent, origins, slots, gen_ticks, plain
        )
        in_flight[t % dg.ring_size] = bool(nonzero)
        t += 1
    return seen, received, sent, t - t_start


def _run_chunk_coverage(
    dg: DeviceGraph,
    origins: torch.Tensor,
    gen_ticks: torch.Tensor,
    *,
    chunk_size: int,
    horizon: int,
    coverage_slots: int | None = None,
    plain: bool = False,
):
    """Coverage-recording run from t=0. Returns (seen, received, sent,
    coverage) with coverage (horizon, S) int32 node counts per tick; rows
    past quiescence hold the final value.

    Coverage accumulates incrementally: each (node, share) bit enters the
    tick's new frontier at most once, so per-tick coverage is a running
    sum of the frontier's per-slot counts (the ``coverage_per_slot``
    kernel over the first ``coverage_slots`` slots)."""
    w = bitmask.num_words(chunk_size)
    cov_slots = chunk_size if coverage_slots is None else coverage_slots
    cov_w = bitmask.num_words(cov_slots)
    slots = torch.arange(chunk_size, dtype=torch.int64, device=dg.device)
    g = gen_ticks.cpu().numpy()
    live = g[g < horizon]
    last_gen = int(live.max()) if live.size else 0
    seen, hist, occ, received, sent = _chunk_state(dg, w)
    cov_run = torch.zeros((cov_slots,), dtype=torch.int32, device=dg.device)
    cov_hist = torch.zeros((horizon, cov_slots), dtype=torch.int32, device=dg.device)
    in_flight = [False] * dg.ring_size
    t = 0
    while t < horizon and (any(in_flight) or t <= last_gen):
        newly_out, nonzero = _tick(
            dg, t, seen, hist, occ, received, sent, origins, slots, gen_ticks, plain
        )
        cov_run += bitmask.coverage_per_slot(
            newly_out[:, :cov_w], cov_slots, plain=plain
        )
        cov_hist[t] = cov_run
        in_flight[t % dg.ring_size] = bool(nonzero)
        t += 1
    cov_hist[t:] = cov_run
    return seen, received, sent, cov_hist


def _generated(schedule: Schedule, horizon: int) -> np.ndarray:
    live = schedule.gen_ticks < horizon
    return np.bincount(
        schedule.origins[live], minlength=schedule.n_nodes
    ).astype(np.int64)


def _stage(graph, ell_delays, constant_delay, device_graph, device):
    device = resolve_device(device)
    if device_graph is None:
        return DeviceGraph.build(graph, ell_delays, constant_delay, device=device)
    if device_graph.device != device:
        raise ValueError(
            f"device_graph lives on {device_graph.device}, not {device}"
        )
    return device_graph


def run_sync_sim(
    graph: Graph,
    schedule: Schedule,
    horizon_ticks: int,
    ell_delays: np.ndarray | None = None,
    constant_delay: int = 1,
    chunk_size: int = DEFAULT_CHUNK_SIZE,
    device_graph: DeviceGraph | None = None,
    *,
    device=None,
    plain: bool = False,
) -> NodeStats:
    """Run the full simulation on the synchronous engine: the counterpart
    of the JAX package's ``run_sync_sim``, identical per-node counters and
    ``stats.extra["ticks_executed"]``.

    ``device=None`` means CUDA and raises RuntimeError without it; pass
    ``device="cpu"`` for the CPU. ``plain=True`` runs the kernels' plain
    torch versions on any device (the comparison run for the kernels)."""
    dg = _stage(graph, ell_delays, constant_delay, device_graph, device)
    chunk_size = min(chunk_size, max(MIN_CHUNK_SHARES, schedule.num_shares))
    chunk_size = bitmask.num_words(chunk_size) * bitmask.WORD_BITS
    received = np.zeros(graph.n, dtype=np.int64)
    sent = np.zeros(graph.n, dtype=np.int64)
    ticks_executed = 0
    for chunk in schedule.chunk(chunk_size):
        live = chunk.gen_ticks < horizon_ticks
        if not live.any():
            continue
        origins, gen_ticks = chunk.padded(chunk_size, horizon_ticks)
        _, r, s, ticks = _run_chunk_while(
            dg,
            torch.as_tensor(origins.astype(np.int64), device=dg.device),
            torch.as_tensor(gen_ticks, device=dg.device),
            int(chunk.gen_ticks[live].min()),
            int(chunk.gen_ticks[live].max()),
            chunk_size=chunk_size, horizon=horizon_ticks, plain=plain,
        )
        received += r.cpu().numpy().astype(np.int64)
        sent += s.cpu().numpy().astype(np.int64)
        ticks_executed += ticks

    generated = _generated(schedule, horizon_ticks)
    stats = NodeStats(
        generated=generated,
        received=received,
        forwarded=received.copy(),
        sent=sent,
        processed=generated + received,
        degree=graph.degree.astype(np.int64),
    )
    stats.extra["ticks_executed"] = ticks_executed
    return stats


def run_flood_coverage(
    graph: Graph,
    origins,
    horizon_ticks: int,
    ell_delays: np.ndarray | None = None,
    constant_delay: int = 1,
    device_graph: DeviceGraph | None = None,
    chunk_size: int | None = None,
    *,
    device=None,
    plain: bool = False,
):
    """Flood coverage-time experiment: one share per origin, all at t=0.

    Returns (stats, coverage) where coverage is (horizon, num_origins)
    int32 node counts per tick — the time-to-99%-coverage curve.
    ``chunk_size=None`` pads the bitmask to MIN_CHUNK_SHARES, as the JAX
    engine does. ``device`` and ``plain`` as in `run_sync_sim`."""
    origins = np.asarray(origins, dtype=np.int32).reshape(-1)
    s = origins.shape[0]
    floor = MIN_CHUNK_SHARES if chunk_size is None else chunk_size
    chunk_size = bitmask.num_words(max(s, floor)) * bitmask.WORD_BITS
    dg = _stage(graph, ell_delays, constant_delay, device_graph, device)
    sched = Schedule(graph.n, origins, np.zeros(s, dtype=np.int32))
    o, g = sched.padded(chunk_size, horizon_ticks)
    _, r, snt, cov = _run_chunk_coverage(
        dg,
        torch.as_tensor(o.astype(np.int64), device=dg.device),
        torch.as_tensor(g, device=dg.device),
        chunk_size=chunk_size, horizon=horizon_ticks, coverage_slots=s,
        plain=plain,
    )
    generated = _generated(sched, horizon_ticks)
    received = r.cpu().numpy().astype(np.int64)
    stats = NodeStats(
        generated=generated,
        received=received,
        forwarded=received.copy(),
        sent=snt.cpu().numpy().astype(np.int64),
        processed=generated + received,
        degree=graph.degree.astype(np.int64),
    )
    coverage = cov.cpu().numpy()[:, :s]
    stats.extra["coverage"] = coverage
    return stats, coverage


def time_to_coverage(coverage: np.ndarray, n: int, fraction: float = 0.99):
    """First tick at which each share reaches ``fraction`` of nodes (-1 if
    never). coverage: (T, S)."""
    if coverage.shape[0] == 0:
        return np.full(coverage.shape[1], -1, dtype=np.int64)
    target = int(np.ceil(fraction * n))
    hit = coverage >= target
    return np.where(hit.any(axis=0), hit.argmax(axis=0), -1)
