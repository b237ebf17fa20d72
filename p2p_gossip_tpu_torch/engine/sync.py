"""Synchronous tick engine on PyTorch — the flood engine's main path.

The NS-3 event loop becomes a synchronous graph message-passing simulation:

- one **tick** delivers every in-flight message at once: a gather-OR over
  the ELL adjacency reading a ring of past frontiers (`ops.ell`, one
  ``gather_or`` kernel launch per degree bucket on the GPU). Beside the
  ring the engine keeps each slot's per-row sector occupancy (the
  ``sector_occupancy`` kernel, run on the slot the tick writes), so the
  gather reads only the sectors of a source row that hold bits;
- the per-node seen-set (p2pnode.h:38) is an (N x S/32) int32 bitmask;
- the gather is masked by the destinations' seen-sets (``gather_or``'s
  ``seen``): it returns ``arrivals & ~seen``, all the tick keeps of its
  arrivals, and reads no neighbour unit whose bits a destination has;
- generation events (`GenerateAndGossipShare`, p2pnode.cc:106) are
  pre-sampled host-side and ORed into seen and the frontier at their tick;
- the dedup against seen, the new frontier and the counters (p2pnode.h:40-43)
  are one ``tick_update`` kernel call a tick;
- a Python loop advances time until no message is in flight and no
  generation is pending (or the horizon). Its predicate is read on the
  host once per tick — one device sync per tick.

With telemetry's rings on (`telemetry.sink.rings_enabled`), each tick also
writes a metric row and a state digest (the ``tick_digest`` kernel) into
device rings, harvested once a chunk as the JAX package's ``ring`` and
``digest`` events; with them off the tick launches nothing extra.

Options, as in the JAX engine and all off by default (the tick then runs
exactly the option-free work): node churn (a per-tick up mask the gather
kernel applies to destinations, and skipped generations), link loss (the
coin computed edge by edge inside the gather kernel), the connect window,
periodic snapshots (device copies of ``received`` at the boundary ticks)
and checkpoint/resume between chunks (the JAX package's file format).

Share counts of any size run in fixed-size chunks (shares are independent,
counters add). A Monte-Carlo campaign (`batch.campaign`) runs B replicas
through the same tick at one common tick counter: their state is stacked
along the rows (``seen`` (B*N, W), the ring (D, B*N, W)), each kernel
launch covers all B (``gather_or`` hashes node ids with one loss seed a
replica), and a replica past its own quiescence has an empty frontier, so
its further ticks change nothing. With B = 1 the tick is the solo one. Semantics are tick-exact against the JAX package's
``engine/sync.py``: same graph + schedule + integer delays + option models
give identical per-node counters, executed-tick counts, snapshots and
coverage rows.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from p2p_gossip_tpu_torch.models import churn as churn_mod
from p2p_gossip_tpu_torch.models.churn import ChurnModel, effective_generated
from p2p_gossip_tpu_torch.models.generation import Schedule
from p2p_gossip_tpu_torch.models.linkloss import LinkLossModel
from p2p_gossip_tpu_torch.models.topology import Graph
from p2p_gossip_tpu_torch.ops import bitmask, kernels
from p2p_gossip_tpu_torch.ops.ell import (
    DEFAULT_DEGREE_BLOCK,
    bucket_rows_by_count,
    build_degree_buckets,
    detect_uniform_delay,
    propagate,
    propagate_bucketed,
    propagate_uniform,
)
from p2p_gossip_tpu_torch.telemetry import digest as tel_digest
from p2p_gossip_tpu_torch.telemetry import progress as tel_progress
from p2p_gossip_tpu_torch.telemetry import rings as tel_rings
from p2p_gossip_tpu_torch.telemetry import sink as tel_sink
from p2p_gossip_tpu_torch.telemetry.spans import span
from p2p_gossip_tpu_torch.utils import logging as p2plog
from p2p_gossip_tpu_torch.utils.checkpoint import (
    ChunkCheckpointer,
    checkpointed_chunks,
    fingerprint,
)
from p2p_gossip_tpu_torch.utils.device import resolve_device
from p2p_gossip_tpu_torch.utils.stats import NodeStats

log = p2plog.get_logger("Engine.Sync")

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
        with span("stage.buckets") as sp:  # the host's planning; the copy follows
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
            sp.set(buckets=0 if buckets is None else len(buckets))
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


def _staged_graph_bytes(degree: np.ndarray, block: int, uniform_delay: bool,
                        bucketed: bool | None = None) -> int:
    """Bytes of every tensor `DeviceGraph.build` stages for a graph of this
    degree array, counted from its own rules: the degree buckets of
    `ops.ell.build_degree_buckets` (int32 ``rows``, int32 ``idx``, bool
    ``mask`` and, with per-edge delays, int32 ``delay``, each bucket
    padded to its block-rounded max degree) from 4096 nodes up (or as
    ``bucketed`` says, `DeviceGraph.build`'s argument), else the
    full-width (N, dmax) ELL; the (1, 1) placeholders; ``degree``.
    ``uniform_delay`` means a run with no delay array (the buckets are cut
    from CSR at their full cap); per-edge delays cut the buckets from the
    (N, dmax) ELL, so no bucket is wider than dmax."""
    n = int(degree.shape[0])
    per_entry = 5 if uniform_delay else 9
    dmax = max(int(degree.max()) if n else 0, 1)
    if bucketed is None:
        bucketed = n >= 4096  # DeviceGraph.build's default staging
    if bucketed:
        total = 4 + 4 + 1  # placeholders: ell_idx, ell_delay, ell_mask
        for rows in bucket_rows_by_count(degree, block, 2048):  # min_rows default
            cap = max(-(-int(degree[rows].max()) // block) * block, block)
            if not uniform_delay:
                cap = min(cap, dmax)
            total += 4 * len(rows) + per_entry * len(rows) * cap
    else:
        total = n * dmax * per_entry + (4 if uniform_delay else 0)
    return total + 4 * n


def flood_resident_hbm_bytes(
    degree: np.ndarray,
    w: int,
    block: int = DEFAULT_DEGREE_BLOCK,
    ring_size: int = 2,
    uniform_delay: bool = True,
) -> int:
    """Modeled peak device memory of one flood chunk at W words per row:
    the fit check, computable from the host degree array before anything
    is staged. The JAX package's function of the same name models XLA's
    degree-blocked gather on a TPU; these are the port's own terms,
    counted from its code (``block`` is the degree quantum of the bucket
    planner, `ops.ell.DEFAULT_DEGREE_BLOCK`; the CUDA gather has no degree
    block). All bytes:

    - the staged graph (`_staged_graph_bytes`), resident for the run;
    - the chunk state (`_chunk_state`): ``seen`` (N, W) int32, the
      (D, N, W) frontier ring, its (D, N) int32 sector occupancy, the
      (N,) int32 ``received`` and ``sent``;
    - the tick's live temporaries at its peak, the `ops.kernels.
      tick_update` call: ``arrivals`` (`ops.ell`'s output), one (N, W)
      int32, and two (N,) int32 count vectors (the live generations and
      the newly counts). The kernel writes the rest in place. The plain
      torch passes (the CPU, ``plain=True``) hold three (N, W) planes
      more, the generation bits, ``~seen`` and ``newly``; the CPU has no
      budget to fit.

    Per-share and per-tick buffers (origins, slots, coverage rows) are a
    few MB and left out."""
    degree = np.asarray(degree, dtype=np.int64)
    n = int(degree.shape[0])
    row = w * 4
    staged = _staged_graph_bytes(degree, block, uniform_delay)
    state = (1 + ring_size) * n * row + ring_size * n * 4 + 2 * n * 4
    tick = n * row + 2 * n * 4
    return staged + state + tick


def auto_chunk_shares(
    degree: np.ndarray,
    shares: int,
    block: int,
    budget_bytes: float,
    ring_size: int = 2,
    uniform_delay: bool = True,
    min_chunk: int = 512,
) -> int | None:
    """Bitmask pad width (in shares) whose modeled resident footprint
    (`flood_resident_hbm_bytes`) fits ``budget_bytes``, or None when the
    engine's default pad (``max(shares, MIN_CHUNK_SHARES)``, what
    `run_flood_coverage` stages anyway) already fits or budgeting is off
    (``budget_bytes`` falsy): None leaves ``chunk_size`` at its default.
    Otherwise halves from the default pad as few times as it can, down to
    ``min_chunk``; a floor that still does not fit (the staged graph alone
    exceeds the budget) is returned with a RuntimeWarning. The value is a
    pad target and may exceed ``shares``. The JAX package's halving rule,
    floor, warning and None contract (`device_budget_bytes` gives the
    port's budget)."""
    if not budget_bytes:
        return None
    default_pad = max(32, shares, MIN_CHUNK_SHARES)
    chunk = default_pad
    while chunk > min_chunk:
        w = bitmask.num_words(chunk)
        if flood_resident_hbm_bytes(degree, w, block, ring_size, uniform_delay) <= budget_bytes:
            break
        chunk = max(min_chunk, chunk // 2)
    if chunk < default_pad:
        floor_model = flood_resident_hbm_bytes(
            degree, bitmask.num_words(chunk), block, ring_size, uniform_delay
        )
        if floor_model > budget_bytes:
            import warnings

            warnings.warn(
                f"auto_chunk_shares: budget {budget_bytes / 1e9:.1f} GB "
                f"cannot be met — pad {chunk} still models "
                f"{floor_model / 1e9:.1f} GB (fixed ELL terms dominate); "
                "returning the floor anyway",
                RuntimeWarning,
                stacklevel=2,
            )
    return None if chunk == default_pad else chunk


def device_budget_bytes(device=None) -> float:
    """The device-memory budget `auto_chunk_shares` sizes against:
    ``P2P_HBM_BUDGET_GB`` (in 1e9 bytes) when set, else the card's free
    memory now (`torch.cuda.mem_get_info`), so call it before staging.
    (The JAX package's 10 GB default was sized for a 16 GB TPU.) A CPU
    device has no budget: 0, budgeting off."""
    import os

    env = os.environ.get("P2P_HBM_BUDGET_GB")
    if env:
        return float(env) * 1e9
    device = resolve_device(device)
    if device.type != "cuda":
        return 0.0
    free, _total = torch.cuda.mem_get_info(device)
    return float(free)


class TickGenerations(NamedTuple):
    """A tick's generation events, the third argument of
    `apply_tick_updates`: event e puts share slot ``slots[e]`` into row
    ``rows[e]`` where ``active[e]`` ((S,) int64, int64 and bool on the
    state's device); ``frontier`` False (before ``connect_tick``) puts the
    bits into ``seen`` only."""

    rows: torch.Tensor
    slots: torch.Tensor
    active: torch.Tensor
    frontier: bool = True


def apply_tick_updates(
    seen, arrivals, gen_bits, gen_cnt, received, sent, degree, *,
    out=None, plain: bool = False,
):
    """The counter semantics of one tick (p2pnode.cc ReceiveShare /
    GenerateAndGossipShare): dedup against ``seen``, count first-time
    receives, and charge one send per peer per processed share.

    ``gen_bits`` is the tick's generation events, a `TickGenerations` (the
    events, not an (N, W) plane of their bits); ``gen_cnt`` (N,) int32 the
    live generations a row (zero before ``connect_tick``). Updates
    ``seen``, ``received`` and ``sent`` in place (int32, wrapping exactly
    as the JAX engine's counters) and writes ``newly_out`` — the frontier
    this tick contributes to its delay-line slot — into ``out`` when given:
    one `ops.kernels.tick_update` call, the kernel on the card, the torch
    passes on the CPU and with ``plain``. Returns (seen, newly_out,
    received, sent, newly_cnt)."""
    newly_out, newly_cnt = kernels.tick_update(
        seen, arrivals, gen_bits.rows, gen_bits.slots, gen_bits.active, gen_cnt, received,
        sent, degree, frontier=gen_bits.frontier, out=out, plain=plain,
    )
    return seen, newly_out, received, sent, newly_cnt


@dataclasses.dataclass(frozen=True)
class TickOptions:
    """The flood engine's options as one tick applies them (all off by
    default, and then the tick runs exactly the option-free work):
    ``churn`` the (N, K) int32 downtime intervals on the device
    (`models.churn.to_device`), ``loss`` the link-loss (threshold, seed)
    pair, ``connect_tick`` the reference's socket warm-up window.

    A campaign batch sets ``replicas`` B > 1 and ``degree``, the (B*N,)
    int32 degree of every stacked row; its churn intervals are then (B*N,
    K) and its loss seed may be a (B,) int32 tensor of per-replica seeds
    (`ops.kernels.gather_or`).

    ``gather_stats`` is the gather's (2,) int64 counter of neighbour units
    read and pruned (`ops.kernels.gather_or`'s ``stats``), which an entry
    allocates once a run with telemetry's span sink on (`_gather_stats`)
    and reads in its ``stats`` span; None launches the gather without
    counting."""

    churn: tuple | None = None
    loss: tuple | None = None
    connect_tick: int = 0
    replicas: int = 1
    degree: torch.Tensor | None = None
    gather_stats: torch.Tensor | None = None


NO_OPTIONS = TickOptions()


def _gather(dg: DeviceGraph, hist, occ, t: int, plain: bool, loss=None, up=None,
            replicas: int = 1, seen=None, stats=None):
    kw = dict(occ=occ, loss=loss, up=up, replicas=replicas, seen=seen, stats=stats,
              plain=plain)
    if dg.buckets is not None:
        return propagate_bucketed(
            hist, t, dg.buckets, n_out=dg.n, ring_size=dg.ring_size,
            uniform_delay=dg.uniform_delay, **kw,
        )
    if dg.uniform_delay is not None:
        return propagate_uniform(
            hist, t, dg.ell_idx, dg.ell_mask, ring_size=dg.ring_size,
            uniform_delay=dg.uniform_delay, **kw,
        )
    return propagate(
        hist, t, dg.ell_idx, dg.ell_delay, dg.ell_mask, ring_size=dg.ring_size, **kw,
    )


def _gather_stats(dg: DeviceGraph, plain: bool) -> torch.Tensor | None:
    """The gather's read/pruned counter for a run (`TickOptions.
    gather_stats`): a zeroed (2,) int64 tensor where the span sink is on,
    the device rings are off (their ticks gather unmasked) and the kernel
    runs (a card, not ``plain``); else None."""
    if (not tel_sink.enabled() or tel_sink.rings_enabled() or plain
            or dg.device.type != "cuda"):
        return None
    return torch.zeros((2,), dtype=torch.int64, device=dg.device)


def _record_gather_stats(sp, opts: TickOptions) -> None:
    """Put the run's gather counts on the entry's ``stats`` span (after
    the entry's sync: the read waits on nothing)."""
    if opts.gather_stats is not None:
        read, pruned = opts.gather_stats.tolist()
        sp.set(gather_units_read=read, gather_units_pruned=pruned)


def _tick(
    dg, t, seen, hist, occ, received, sent, origins, slots, gen_ticks, plain,
    opts: TickOptions = NO_OPTIONS, rings=None,
):
    """One synchronous tick at time ``t``: gather arrivals, OR in this
    tick's generations, update seen and the counters, and write the new
    frontier into hist slot ``t mod D`` and its sector occupancy into occ
    slot ``t mod D``. Returns that slot's frontier and a 0-d device tensor
    telling whether it holds any bit.

    Options (the JAX package's ``_tick_body``): under churn a down node's
    arrivals are zero (the gather kernel's ``up`` mask) and its generations
    are skipped; the loss coin drops edges inside the gather; before
    ``connect_tick`` generations enter their origin's seen-set but not the
    frontier and charge no sends (p2pnetwork.cc:93-96, p2pnode.cc:131-135).

    ``rings`` (telemetry on) is the chunk's (metric ring, digest ring):
    the tick writes row ``t`` of each (`telemetry.rings.flood_row` and
    the digest of the post-tick state, ``sent`` as its low word only); a
    campaign batch's rings hold one lane a replica (`telemetry.rings.
    chunk_rings` with ``replicas``), written by the same launches.
    The row's ``msgs_gathered`` is the post-loss, pre-churn gather, so
    under churn the gather runs without the up mask and the mask is
    applied after it (the same arrivals); ``loss_dropped`` needs a second,
    loss-free gather. Both extra costs are paid only with telemetry on.
    Without rings the gather takes ``seen`` and returns ``arrivals &
    ~seen``; the rings' rows count the raw wire, so their ticks gather
    unmasked. The update's result is the same either way: it keeps only
    ``arrivals & ~seen`` and ORs the arrivals into ``seen``.

    A campaign batch (``opts.replicas`` B > 1) stacks its replicas along
    the rows of every tensor here: ``origins`` are stacked rows r*N +
    origin, ``slots`` and ``gen_ticks`` the (B*S,) share slots and ticks."""
    with span("gather"):
        up = None if opts.churn is None else churn_mod.up_mask(*opts.churn, t)
        if rings is None:
            arrivals = _gather(dg, hist, occ, t, plain, opts.loss, up, opts.replicas,
                               seen, opts.gather_stats)
        else:
            wire = _gather(dg, hist, occ, t, plain, opts.loss, replicas=opts.replicas)
            lossless = None if opts.loss is None else _gather(
                dg, hist, occ, t, plain, replicas=opts.replicas)
            arrivals = wire if up is None else wire & -up.to(torch.int32)[:, None]
    with span("update"):
        gen_active = gen_ticks == t
        if up is not None:
            gen_active &= up[origins]
        live = t >= opts.connect_tick
        live_cnt = torch.zeros(received.shape, dtype=torch.int32, device=seen.device)
        if live:
            live_cnt.index_add_(0, origins, gen_active.to(torch.int32))
        slot = hist[t % dg.ring_size]
        degree = dg.degree if opts.degree is None else opts.degree
        _, newly_out, _, _, newly_cnt = apply_tick_updates(
            seen, arrivals, TickGenerations(origins, slots, gen_active, live), live_cnt,
            received, sent, degree, out=slot, plain=plain,
        )
        kernels.sector_occupancy(slot, out=occ[t % dg.ring_size], plain=plain)
        # newly_out = newly | the live generation bits holds a bit iff a node
        # newly processed a share or a live generation fired — read from the
        # two small count vectors instead of another (N, W) pass. Before
        # connect_tick the live count is zero: the slot holds no generation
        # bit then.
        nonzero = (newly_cnt.sum() + live_cnt.sum()) > 0
    if rings is not None:
        met, dig = rings
        tel_rings.flood_row(met, t, wire, newly_out, newly_cnt, degree, lossless,
                            plain=plain)
        tel_digest.write(dig, t, seen, received, sent, plain=plain)
    return newly_out, nonzero


def _chunk_state(dg: DeviceGraph, w: int, replicas: int = 1):
    """Zeroed chunk state: seen (N, W), the frontier ring hist (D, N, W)
    with its sector occupancy occ (D, N) (all clear, as the ring is
    zero), and the int32 counters received and sent (N,); N is B*N for
    ``replicas`` B stacked replicas."""
    dev, n = dg.device, replicas * dg.n
    seen = torch.zeros((n, w), dtype=torch.int32, device=dev)
    hist = torch.zeros((dg.ring_size, n, w), dtype=torch.int32, device=dev)
    occ = torch.zeros((dg.ring_size, n), dtype=torch.int32, device=dev)
    received = torch.zeros((n,), dtype=torch.int32, device=dev)
    sent = torch.zeros((n,), dtype=torch.int32, device=dev)
    return seen, hist, occ, received, sent


def _share_slots(chunk_size: int, replicas: int, device) -> torch.Tensor:
    """Each (stacked) generation event's share slot: (B*S,) int64."""
    slots = torch.arange(chunk_size, dtype=torch.int64, device=device)
    return slots if replicas == 1 else slots.repeat(replicas)


def _run_chunk_while(
    dg: DeviceGraph,
    origins: torch.Tensor,    # (S,) int64 on dg.device
    gen_ticks: torch.Tensor,  # (S,) int32 (>= horizon entries never fire)
    t_start: int,
    last_gen: int,
    *,
    chunk_size: int,
    horizon: int,
    opts: TickOptions = NO_OPTIONS,
    snap_ticks: list[int] | None = None,
    rings: tuple | None = None,
    plain: bool = False,
):
    """Run one share chunk to quiescence (or the horizon). Returns (seen,
    received, sent, snaps, ticks executed). The loop predicate — a message
    in flight in any hist slot, or a generation still pending — is the JAX
    engine's ``any(hist != 0) | t <= last_gen``, kept as one host flag per
    ring slot.

    With ``snap_ticks`` (sorted boundaries), ``snaps`` is (K, N) int32: row
    i holds ``received`` as the tick counter reaches boundary i (the totals
    over ticks strictly before it), or the final counts for a boundary at
    or after the exit tick. Device copies only, no host sync.

    ``rings`` (telemetry on): a fresh (metric ring, digest ring) pair from
    `telemetry.rings.chunk_rings`, whose rows [t_start, exit) the ticks write.

    A campaign batch (``opts.replicas`` B > 1, JAX ``_run_while_batch``)
    passes stacked (B*S,) ``origins`` (rows r*N + origin) and
    ``gen_ticks``, and the batch's first and last live generation ticks;
    the counters come back (B*N,) and the predicate holds for the batch."""
    w = bitmask.num_words(chunk_size)
    slots = _share_slots(chunk_size, opts.replicas, dg.device)
    seen, hist, occ, received, sent = _chunk_state(dg, w, opts.replicas)
    snap_ticks = snap_ticks or []
    snaps = torch.zeros((len(snap_ticks), seen.shape[0]), dtype=torch.int32,
                        device=dg.device)
    in_flight = [False] * dg.ring_size
    t = t_start
    while t < horizon and (any(in_flight) or t <= last_gen):
        with span("tick"):
            for i, b in enumerate(snap_ticks):
                if b == t:
                    snaps[i].copy_(received)
            _, nonzero = _tick(
                dg, t, seen, hist, occ, received, sent, origins, slots, gen_ticks,
                plain, opts, rings,
            )
            with span("sync"):
                in_flight[t % dg.ring_size] = bool(nonzero)
        t += 1
    for i, b in enumerate(snap_ticks):
        if b >= t:  # at or after quiescence: the (unchanging) final counts
            snaps[i].copy_(received)
    return seen, received, sent, snaps, t - t_start


def _run_chunk_coverage(
    dg: DeviceGraph,
    origins: torch.Tensor,
    gen_ticks: torch.Tensor,
    *,
    chunk_size: int,
    horizon: int,
    coverage_slots: int | None = None,
    opts: TickOptions = NO_OPTIONS,
    rings: tuple | None = None,
    plain: bool = False,
):
    """Coverage-recording run from t=0. Returns (seen, received, sent,
    coverage) with coverage (B, horizon, S) int32 node counts per tick (B
    = ``opts.replicas``, 1 for a solo run); rows past the exit tick hold
    the final value (a replica's coverage stops changing at its own
    quiescence). ``opts`` as in `_tick`, ``rings`` as in
    `_run_chunk_while`; a campaign batch stacks its inputs as there (JAX
    ``_run_coverage_batch``).

    Coverage accumulates incrementally: each (node, share) bit enters the
    tick's new frontier at most once, so per-tick coverage is a running
    sum of the frontier's per-slot counts (one ``coverage_per_slot``
    launch a tick for all B replicas, over the first ``coverage_slots``
    slots)."""
    w = bitmask.num_words(chunk_size)
    b = opts.replicas
    cov_slots = chunk_size if coverage_slots is None else coverage_slots
    cov_w = bitmask.num_words(cov_slots)
    slots = _share_slots(chunk_size, b, dg.device)
    g = gen_ticks.cpu().numpy()
    live = g[g < horizon]
    last_gen = int(live.max()) if live.size else 0
    seen, hist, occ, received, sent = _chunk_state(dg, w, b)
    cov_run = torch.zeros((b, cov_slots), dtype=torch.int32, device=dg.device)
    cov_hist = torch.zeros((b, horizon, cov_slots), dtype=torch.int32, device=dg.device)
    in_flight = [False] * dg.ring_size
    t = 0
    while t < horizon and (any(in_flight) or t <= last_gen):
        with span("tick"):
            newly_out, nonzero = _tick(
                dg, t, seen, hist, occ, received, sent, origins, slots, gen_ticks,
                plain, opts, rings,
            )
            cov_run += bitmask.coverage_per_slot(
                newly_out.view(b, dg.n, w)[:, :, :cov_w], cov_slots, plain=plain
            )
            cov_hist[:, t] = cov_run
            with span("sync"):
                in_flight[t % dg.ring_size] = bool(nonzero)
        t += 1
    cov_hist[:, t:] = cov_run[:, None]
    return seen, received, sent, cov_hist


def filter_snapshot_boundaries(snapshot_ticks, horizon_ticks) -> list[int]:
    """Boundaries past the horizon never fire on the event engine (its
    final flush is at horizon_ticks): drop them, as the JAX engine does."""
    if not snapshot_ticks:
        return []
    return sorted(b for b in snapshot_ticks if b <= horizon_ticks)


def assemble_snapshots(schedule, churn, boundaries, snap_received, connections):
    """The periodic-stats entries (PrintPeriodicStats, p2pnetwork.cc:231)
    from per-boundary received totals, in the JAX engine's dict form."""
    snapshots = []
    for i, b in enumerate(boundaries):
        gen_b = int(effective_generated(schedule, b, churn).sum())
        snapshots.append(
            {
                "tick": int(b),
                "generated": gen_b,
                "processed": gen_b + int(snap_received[i].sum()),
                "connections": int(connections),
            }
        )
    return snapshots


def _canonical_delays(dg: DeviceGraph) -> np.ndarray:
    """Per-edge delays in CSR order, independent of how they were staged
    (the JAX engine's checkpoint fingerprint input): bucketed and
    full-width stagings of the same delays fingerprint identically."""
    if dg.uniform_delay is not None:
        return np.asarray([dg.uniform_delay], dtype=np.int64)
    if dg.buckets is None:
        mask = dg.ell_mask.cpu().numpy()
        return dg.ell_delay.cpu().numpy()[mask]
    per_node: list = [None] * dg.n
    for rows, _idx, b_mask, b_delay in dg.buckets:
        mask_np = b_mask.cpu().numpy()
        delay_np = b_delay.cpu().numpy()
        for j, r in enumerate(rows.cpu().numpy()):
            per_node[r] = delay_np[j][mask_np[j]]
    return np.concatenate(per_node)


def _stage(graph, ell_delays, constant_delay, device_graph, device):
    device = resolve_device(device)
    if device_graph is None:
        return DeviceGraph.build(graph, ell_delays, constant_delay, device=device)
    if device_graph.device != device:
        raise ValueError(
            f"device_graph lives on {device_graph.device}, not {device}"
        )
    return device_graph


def _tick_options(dg, churn, loss, connect_tick=0, plain: bool = False) -> TickOptions:
    return TickOptions(
        churn=churn_mod.to_device(churn, dg.device),
        loss=None if loss is None else loss.static_cfg,
        connect_tick=int(connect_tick),
        gather_stats=_gather_stats(dg, plain),
    )


def run_sync_sim(
    graph: Graph,
    schedule: Schedule,
    horizon_ticks: int,
    ell_delays: np.ndarray | None = None,
    constant_delay: int = 1,
    chunk_size: int = DEFAULT_CHUNK_SIZE,
    device_graph: DeviceGraph | None = None,
    checkpoint_path: str | None = None,
    checkpoint_every: int = 1,
    stop_after_chunks: int | None = None,
    churn: ChurnModel | None = None,
    snapshot_ticks: list[int] | None = None,
    loss: LinkLossModel | None = None,
    connect_tick: int = 0,
    *,
    device=None,
    plain: bool = False,
) -> NodeStats:
    """Run the full simulation on the synchronous engine: the counterpart
    of the JAX package's ``run_sync_sim``, identical per-node counters,
    ``stats.extra["ticks_executed"]`` and snapshots.

    Options, as in the JAX engine:
    - ``checkpoint_path``: accumulated counters are written atomically
      every ``checkpoint_every`` chunks, and a run restarted with the same
      inputs resumes after the last completed chunk; a checkpoint of a
      different run is detected by fingerprint and ignored. The file is
      the JAX package's: either package resumes the other's.
      ``stop_after_chunks`` ends the call after that many chunks.
    - ``churn`` (`models.churn.ChurnModel`): a node inside a downtime
      interval loses its arrivals and skips its generations.
    - ``snapshot_ticks``: ``stats.extra["snapshots"]`` gets one entry per
      boundary with the totals over all ticks strictly before it
      (PrintPeriodicStats, p2pnetwork.cc:231); present (possibly empty)
      whenever snapshots were requested.
    - ``loss`` (`models.linkloss.LinkLossModel`): messages crossing a
      directed link during one of its erasure ticks are dropped in flight.
    - ``connect_tick``: the socket warm-up window; earlier generations are
      counted and marked seen at their origin but never broadcast.

    ``device=None`` means CUDA and raises RuntimeError without it; pass
    ``device="cpu"`` for the CPU. ``plain=True`` runs the kernels' plain
    torch versions on any device (the comparison run for the kernels)."""
    dg = _stage(graph, ell_delays, constant_delay, device_graph, device)
    with span("inputs", shares=schedule.num_shares):
        opts = _tick_options(dg, churn, loss, connect_tick, plain)
        chunk_size = min(chunk_size, max(MIN_CHUNK_SHARES, schedule.num_shares))
        chunk_size = bitmask.num_words(chunk_size) * bitmask.WORD_BITS
        boundaries = filter_snapshot_boundaries(snapshot_ticks, horizon_ticks)
        snap_received = np.zeros((len(boundaries), graph.n), dtype=np.int64)
        chunks = schedule.chunk(chunk_size)
    log.info(
        f"starting sync simulation: {graph.n} nodes, {graph.num_edges} links, "
        f"{schedule.num_shares} shares in chunks of {chunk_size}, horizon "
        f"{horizon_ticks} ticks, ring {dg.ring_size}"
        + (f", uniform delay {dg.uniform_delay}" if dg.uniform_delay else "")
    )
    received = np.zeros(graph.n, dtype=np.int64)
    sent = np.zeros(graph.n, dtype=np.int64)
    ticks_executed = 0

    checkpointer = None
    if checkpoint_path is not None:
        # The JAX engine's fingerprint, part for part (its sync.py:761-775),
        # over the effective delays in canonical CSR order.
        ckpt_fp = fingerprint(
            "sync_sim", graph.n, graph.edges(), schedule.origins,
            schedule.gen_ticks, horizon_ticks, chunk_size,
            _canonical_delays(dg), dg.uniform_delay, dg.ring_size,
            churn.down_start if churn is not None else None,
            churn.down_end if churn is not None else None,
            *([np.asarray(opts.loss, dtype=np.int64)] if opts.loss else []),
            *([np.asarray(boundaries, dtype=np.int64)] if boundaries else []),
            *(["connect", connect_tick] if connect_tick else []),
        )
        checkpointer = ChunkCheckpointer(
            checkpoint_path, ckpt_fp,
            {"received": received, "sent": sent, "snap_received": snap_received},
            checkpoint_every,
        )

    tel = tel_sink.rings_enabled()
    name = "engine.sync.run_sync_sim"
    for ci, chunk in checkpointed_chunks(chunks, checkpointer, stop_after_chunks):
        live = chunk.gen_ticks < horizon_ticks
        if not live.any():
            continue
        with span("inputs", shares=chunk.num_shares, chunk=ci):
            origins, gen_ticks = chunk.padded(chunk_size, horizon_ticks)
            first_t = int(chunk.gen_ticks[live].min())
            last_t = int(chunk.gen_ticks[live].max())
            origins = torch.as_tensor(origins.astype(np.int64), device=dg.device)
            gen_ticks = torch.as_tensor(gen_ticks, device=dg.device)
        if log.enabled(p2plog.LOG_DEBUG):
            log.debug(
                f"chunk {ci}: {int(live.sum())} live shares, gen ticks "
                f"[{first_t}, {last_t}]"
            )
        rings = tel_rings.chunk_rings(horizon_ticks, dg.device) if tel else None
        with span("dispatch", kernel="engine.sync._run_chunk_while", chunk=ci) as sp:
            _, r, s, snaps, ticks = _run_chunk_while(
                dg, origins, gen_ticks, first_t, last_t,
                chunk_size=chunk_size, horizon=horizon_ticks, opts=opts,
                snap_ticks=boundaries, rings=rings, plain=plain,
            )
            sp.set(ticks=ticks)
        with span("d2h", chunk=ci, bytes=r.nbytes + s.nbytes + snaps.nbytes):
            received += r.cpu().numpy().astype(np.int64)
            sent += s.cpu().numpy().astype(np.int64)
            snap_received += snaps.cpu().numpy().astype(np.int64)
            ticks_executed += ticks
        digest_head = None
        if tel:
            met, dig = rings
            tel_rings.emit_ring(name, met, t0=first_t, ticks=ticks, chunk=ci)
            dvals = dig.cpu().numpy()
            tel_digest.emit_digest(name, dvals, t0=first_t, ticks=ticks, chunk=ci)
            if ticks > 0:
                digest_head = int(dvals[first_t + ticks - 1])
        tel_progress.emit_progress(
            name, chunk=ci, chunks_total=len(chunks), ticks_done=ticks_executed,
            digest_head=digest_head,
        )

    with span("stats") as sp:
        _record_gather_stats(sp, opts)
        generated = effective_generated(schedule, horizon_ticks, churn)
        degree = graph.degree.astype(np.int64)
        stats = NodeStats(
            generated=generated,
            received=received,
            forwarded=received.copy(),
            sent=sent,
            processed=generated + received,
            degree=degree,
        )
        stats.extra["ticks_executed"] = ticks_executed
        if snapshot_ticks is not None:
            stats.extra["snapshots"] = assemble_snapshots(
                schedule, churn, boundaries, snap_received, degree.sum()
            )
    return stats


def run_flood_coverage(
    graph: Graph,
    origins,
    horizon_ticks: int,
    ell_delays: np.ndarray | None = None,
    constant_delay: int = 1,
    device_graph: DeviceGraph | None = None,
    churn: ChurnModel | None = None,
    loss: LinkLossModel | None = None,
    chunk_size: int | None = None,
    *,
    device=None,
    plain: bool = False,
):
    """Flood coverage-time experiment: one share per origin, all at t=0.

    Returns (stats, coverage) where coverage is (horizon, num_origins)
    int32 node counts per tick — the time-to-99%-coverage curve.
    ``chunk_size=None`` pads the bitmask to MIN_CHUNK_SHARES, as the JAX
    engine does. ``churn`` and ``loss`` as in `run_sync_sim`; ``device``
    and ``plain`` as there too."""
    origins = np.asarray(origins, dtype=np.int32).reshape(-1)
    s = origins.shape[0]
    floor = MIN_CHUNK_SHARES if chunk_size is None else chunk_size
    chunk_size = bitmask.num_words(max(s, floor)) * bitmask.WORD_BITS
    dg = _stage(graph, ell_delays, constant_delay, device_graph, device)
    with span("inputs", shares=s):
        sched = Schedule(graph.n, origins, np.zeros(s, dtype=np.int32))
        o, g = sched.padded(chunk_size, horizon_ticks)
        o = torch.as_tensor(o.astype(np.int64), device=dg.device)
        g = torch.as_tensor(g, device=dg.device)
        opts = _tick_options(dg, churn, loss, plain=plain)
    # The JAX engine logs here which coverage path a TPU run takes (its
    # Pallas kernel or XLA); the port's coverage always runs its CUDA
    # kernel on the card, so there is no such line.
    tel = tel_sink.rings_enabled()
    name = "engine.sync.run_flood_coverage"
    rings = tel_rings.chunk_rings(horizon_ticks, dg.device) if tel else None
    with span("dispatch", kernel="engine.sync._run_chunk_coverage"):
        _, r, snt, cov = _run_chunk_coverage(
            dg, o, g, chunk_size=chunk_size, horizon=horizon_ticks, coverage_slots=s,
            opts=opts, rings=rings, plain=plain,
        )
    digest_head = None
    if tel:
        met, dig = rings
        tel_rings.emit_ring(name, met, t0=0)
        # The full horizon, as the JAX package emits it: rows past
        # quiescence were never written and read as zero.
        dvals = dig.cpu().numpy()
        tel_digest.emit_digest(name, dvals, t0=0, ticks=int(dvals.shape[0]))
        nz = np.flatnonzero(dvals)
        digest_head = int(dvals[nz[-1]]) if nz.size else 0
    with span("d2h", bytes=r.nbytes + snt.nbytes + cov[0].nbytes):
        received = r.cpu().numpy()
        sent = snt.cpu().numpy()
        coverage = cov[0].cpu().numpy()[:, :s]
    with span("stats") as sp:
        _record_gather_stats(sp, opts)
        generated = effective_generated(sched, horizon_ticks, churn)
        received = received.astype(np.int64)
        stats = NodeStats(
            generated=generated,
            received=received,
            forwarded=received.copy(),
            sent=sent.astype(np.int64),
            processed=generated + received,
            degree=graph.degree.astype(np.int64),
        )
        tel_progress.emit_progress(
            name, chunk=0, chunks_total=1, ticks_done=int(coverage.shape[0]),
            coverage_pct=(
                float(coverage[-1].mean()) / dg.n * 100.0 if coverage.size else None
            ),
            digest_head=digest_head,
        )
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


# --- audit specs (staticcheck/: the op audit runs these tiny cases) ---------
# The JAX package's ``_audit_spec_chunk_while`` / ``_chunk_coverage``: ER(48,
# 0.2), 32 shares, horizon 16. The loops' one host read a tick is the
# in-flight flag, ``bool(nonzero)`` (`_run_chunk_while`, `_run_chunk_coverage`).

_SYNC = "p2p_gossip_tpu_torch/engine/sync.py"
_TELEMETRY_BODIES = ("p2p_gossip_tpu_torch/telemetry/rings.py:flood_row",
                     "p2p_gossip_tpu_torch/telemetry/digest.py:write")
_AUDIT_TICKS = 8  # the ticks the specs run: the flood of their four shares quiesces


def _tick_bodies(loop) -> tuple:
    """A tick loop's once-a-tick code: its loop, `_tick` and what it calls."""
    return (f"{_SYNC}:{loop.__name__}[loop]", f"{_SYNC}:_tick", f"{_SYNC}:_gather",
            f"{_SYNC}:apply_tick_updates")


def _audit_spec(kind: str, telemetry: bool = False, replicas: int = 1):
    """``kind`` "while" or "coverage"; ``replicas`` B > 1 stacks B copies of
    the case as a campaign batch (`batch.campaign`'s specs), with the loss
    coin on and one loss seed a replica (the JAX package's
    ``_audit_spec_batch``)."""
    from p2p_gossip_tpu_torch.staticcheck import specs
    from p2p_gossip_tpu_torch.staticcheck.registry import AuditSpec

    chunk, horizon = 32, 16
    dg, origins, gen_ticks, last_gen = specs.flood_inputs(chunk, horizon)
    opts = NO_OPTIONS
    if replicas > 1:
        origins = (origins[None, :] + torch.arange(replicas, device=dg.device)[:, None]
                   * dg.n).reshape(-1)
        gen_ticks = gen_ticks.repeat(replicas)
        seeds = specs.tensor(np.arange(replicas), np.int32)
        opts = TickOptions(loss=(1 << 20, seeds), replicas=replicas,
                           degree=dg.degree.repeat(replicas))
    kwargs = dict(chunk_size=chunk, horizon=horizon, opts=opts)
    if kind == "coverage":
        kwargs["coverage_slots"] = 4
        args = (dg, origins, gen_ticks)
        out = ("int32",) * 4  # seen, received, sent, coverage
        setup = 1  # gen_ticks.cpu(): the chunk's last generation tick, once
    else:
        args = (dg, origins, gen_ticks, 0, last_gen)
        out = ("int32",) * 4  # seen, received, sent, snaps
        setup = 0
    # JAX's `_run_while_batch` returns no snapshot rows.
    counterpart = (0, 1, 2, None if kind == "while" and replicas > 1 else 3)
    if telemetry:
        kwargs["rings"] = tel_rings.chunk_rings(horizon, dg.device,
                                                replicas if replicas > 1 else None)
    return AuditSpec(
        args=args, kwargs=kwargs, integer_only=True, bitmask_words=1,
        bitmask_outputs=(0,), out_dtypes=out, counterpart_outputs=counterpart,
        ticks=_AUDIT_TICKS, setup_reads=setup, off_kwargs=dict(kwargs, rings=None),
    )


from p2p_gossip_tpu_torch.staticcheck.registry import register_entry  # noqa: E402

for _kind, _fn, _jax in (("while", _run_chunk_while, "engine.sync._run_chunk_while"),
                         ("coverage", _run_chunk_coverage, "engine.sync._run_chunk_coverage")):
    _bodies = _tick_bodies(_fn)
    register_entry(f"engine.sync.{_fn.__name__}", _fn,
                   spec=lambda k=_kind: _audit_spec(k), counterpart=_jax,
                   host_reads_per_tick=1, tick_bodies=_bodies)
    register_entry(f"engine.sync.{_fn.__name__}[telemetry]", _fn,
                   spec=lambda k=_kind: _audit_spec(k, telemetry=True),
                   counterpart=f"{_jax}[telemetry]", host_reads_per_tick=1,
                   tick_bodies=_bodies + _TELEMETRY_BODIES)
