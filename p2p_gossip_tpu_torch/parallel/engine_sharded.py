"""The sharded flood engine: the JAX package's ``engine_sharded`` (a
``shard_map`` program over a (shares, nodes) device mesh) as an SPMD
program over ``torch.distributed``.

One process (rank) a GPU. Every rank of the mesh calls the same entry
point; each holds its node shard's rows (adjacency, seen bitmask,
counters) of its share shard's chunk, and every rank returns the global
`NodeStats` (and coverage). Counters SUM over the shares axis once a pass.

The history ring has two layouts (``ring_mode``):

- ``"replicated"``: each rank holds the full (ring, N, W) ring; a tick's
  local new frontier is all_gathered over the nodes group into the full
  ring slot, and the gathers read locally.
- ``"sharded"``: each rank holds only its rows' history; the read side is
  one all_gather of the (t - d) slice per distinct delay d
  (`ops.ell.split_ell_by_delay`).

On the sharded ring, ``exchange="delta"`` replaces the read-time slice
all_gathers by the sparse frontier-delta exchange (`parallel.exchange`):
a tick's changed words are packed per destination (the
``compress_deltas`` kernel), sent with one ``all_to_all_single`` of
indices and one of values, and rebuilt by the reader (the
``scatter_deltas`` kernel); an overflowed slot is read by the dense
all_gather. ``exchange="hub"`` adds an index-free all_gathered block of
high-fan-out rows. ``exchange="async"`` (and ``async-dense``,
``async-delta``, ``async-hub``) issues the gather of an older slot with
``async_op=True`` a tick before its first reader and waits on it at the
read: results are bitwise those of the synchronous engine with
cross-shard delays clamped to ``max(d, K)``
(`async_ticks.clamp_flood_delays`).

Every rank must enter every collective in the same order. Each branch
between collectives is taken on host values every rank shares: the
static plan, and one small vector a tick SUMmed over the whole mesh and
read on the host (the in-flight flag the single-device engine reads
anyway, plus each share shard's overflow flag and used entries under the
delta exchange). The loop's stop test is that mesh-wide flag, never a
rank's own.

Counters, coverage rows, snapshots and ``stats.extra['exchange']`` equal
the JAX sharded engine's and the single-device engine's, bit for bit, for
every mesh shape, ring mode and exchange.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from p2p_gossip_tpu_torch.engine.sync import (
    apply_tick_updates,
    assemble_snapshots,
    filter_snapshot_boundaries,
)
from p2p_gossip_tpu_torch.models import churn as churn_mod
from p2p_gossip_tpu_torch.models.churn import effective_generated
from p2p_gossip_tpu_torch.models.generation import Schedule
from p2p_gossip_tpu_torch.ops import bitmask, kernels
from p2p_gossip_tpu_torch.ops.ell import (
    DEFAULT_DEGREE_BLOCK,
    detect_uniform_delay,
    shard_buckets,
    split_ell_by_delay,
)
from p2p_gossip_tpu_torch.parallel import async_ticks
from p2p_gossip_tpu_torch.parallel import exchange as exch
from p2p_gossip_tpu_torch.parallel.mesh import all_gather_rows, pad_to_multiple
from p2p_gossip_tpu_torch.telemetry import digest as tel_digest
from p2p_gossip_tpu_torch.telemetry import progress as tel_progress
from p2p_gossip_tpu_torch.telemetry import rings as tel_rings
from p2p_gossip_tpu_torch.telemetry import sink as tel_sink
from p2p_gossip_tpu_torch.telemetry.spans import span
from p2p_gossip_tpu_torch.utils.checkpoint import (
    ChunkCheckpointer,
    checkpointed_chunks,
    fingerprint,
)
from p2p_gossip_tpu_torch.utils.stats import NodeStats

#: Per-rank ceiling for the replicated (ring, N, W) history under
#: ring_mode="auto": above it the sharded ring is chosen (the JAX
#: package's value; the resolved choice and its bytes are reported).
RING_REPLICATED_MAX_BYTES = 1 << 30

_U32 = 0xFFFFFFFF


# --- host-side staging (numpy; identical on every rank) ----------------------

def resolve_ring_mode(ring_mode, uniform, ring, n_padded, n_node_shards, w):
    """Resolve "auto" and return (mode, per-rank ring bytes): uniform
    delays take the sharded ring (same traffic, 1/shards the memory);
    per-edge delays stay replicated until the replicated ring passes
    RING_REPLICATED_MAX_BYTES."""
    if ring_mode not in ("auto", "replicated", "sharded"):
        raise ValueError(f"unknown ring_mode {ring_mode!r}")
    replicated_bytes = 4 * ring * n_padded * w
    if ring_mode == "auto":
        if uniform is not None or replicated_bytes > RING_REPLICATED_MAX_BYTES:
            ring_mode = "sharded"
        else:
            ring_mode = "replicated"
    bytes_per_chip = (
        replicated_bytes if ring_mode == "replicated"
        else 4 * ring * (n_padded // n_node_shards) * w
    )
    return ring_mode, bytes_per_chip


@dataclasses.dataclass
class _Plan:
    """Everything the ranks agree on before the first collective."""

    n_padded: int
    k: int                  # node shards
    s: int                  # share shards
    chunk: int              # shares a share shard carries in a pass
    w: int
    ring: int
    ring_mode: str
    group_delays: tuple     # one delay a gather group
    ring_extra: dict
    mode: str               # "dense" | "delta" | "hub"
    capacity: int
    exchange_extra: dict
    hub_count: int
    async_k: int
    offs: tuple
    off_index: tuple
    amounts: tuple

    @property
    def n_loc(self) -> int:
        return self.n_padded // self.k

    @property
    def delta(self) -> bool:
        return self.mode in ("delta", "hub")

    @property
    def sharded_ring(self) -> bool:
        return self.ring_mode == "sharded"

    @property
    def read_backs(self) -> tuple:
        """The delays whose slots a tick reads: the landed offsets plus the
        direct groups under async, else every group."""
        if self.offs:
            return self.offs + tuple(
                d for g, d in enumerate(self.group_delays) if self.off_index[g] < 0)
        return self.group_delays


@dataclasses.dataclass(eq=False)
class ShardedGraph:
    """One rank's host staging of a graph for the sharded engine: the
    rows padded to the node shards, the gather groups (one per delay
    value) cut into this shard's degree buckets, the shard's degrees, and
    the cut the delta exchange plans from (computed at first use, then
    kept, with the hub split and each device's copy of the staged arrays).
    `run_sharded_sim` and `run_sharded_flood_coverage` stage one per call
    unless given one (``sharded_graph=``), as the single-device engines
    take a ``device_graph``. Uniform delays are staged straight from CSR;
    per-edge delays through the (N, dmax) ELL, as the JAX package does."""

    graph: object
    k: int
    shard: int
    n_padded: int
    uniform: int | None
    ring: int               # max delay + 1, before async's effective ring
    delay_values: tuple | None
    groups: list            # ("direct", idx, mask) | ("buckets", [(rows, idx, mask)])
    bucket_counts: tuple
    degree: np.ndarray      # this shard's rows
    _cut: dict = dataclasses.field(default_factory=dict)
    _device: dict = dataclasses.field(default_factory=dict)

    @property
    def n_loc(self) -> int:
        return self.n_padded // self.k

    @property
    def group_delays(self) -> tuple:
        return (self.uniform,) if self.uniform is not None else self.delay_values

    def cut(self, aux_cache=None):
        """(need, need_counts) of `exchange.cached_flood_plan` for this
        graph and shard count (read through ``aux_cache`` when given, and
        then planned anew: the hub splits go with it)."""
        if aux_cache or "plan" not in self._cut:
            self._cut.clear()
            self._cut["plan"] = exch.cached_flood_plan(self.graph, self.n_padded, self.k,
                                                       aux_cache=aux_cache)
        return self._cut["plan"]

    def hub_split(self, w: int, delay_splits: int, hub_rows):
        """`exchange.plan_hub_split` of the cut (its search prices every
        hub size: kept a (W, splits, hub_rows))."""
        key = ("hub", w, delay_splits, hub_rows)
        if key not in self._cut:
            need, need_counts = self.cut()
            self._cut[key] = exch.plan_hub_split(need, need_counts, self.k, self.n_loc, w,
                                                 delay_splits, hub_rows=hub_rows)
        return self._cut[key]

    def on_device(self, device: torch.device):
        """The gather groups and this shard's degrees as int32 / bool
        tensors on ``device``, copied once and kept."""
        if device not in self._device:
            def i32(a):
                return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32), device=device)

            def b8(a):
                return torch.as_tensor(np.ascontiguousarray(a, dtype=bool), device=device)

            groups = [("direct", i32(g[1]), b8(g[2])) if g[0] == "direct" else
                      ("buckets", [(i32(r), i32(i), b8(m)) for r, i, m in g[1]])
                      for g in self.groups]
            self._device[device] = (groups, i32(self.degree))
        return self._device[device]


def stage_sharded_graph(graph, mesh, ell_delays=None, constant_delay: int = 1,
                        block: int | None = None, bucket_min_rows: int = 2048) -> ShardedGraph:
    """Stage ``graph`` (with ``ell_delays`` or the uniform
    ``constant_delay``) for this rank of ``mesh`` (the JAX package's
    ``_stage_sharded_inputs`` and ``_stage_ell_args``, cut to this
    shard). ``block`` is the bucket planner's degree quantum (default
    `ops.ell.DEFAULT_DEGREE_BLOCK`, the JAX package's off-TPU value)."""
    if mesh.coordinate is None:
        raise ValueError("this rank is not in the mesh")
    block = DEFAULT_DEGREE_BLOCK if block is None else block
    k, shard = mesh.n_node_shards, mesh.coordinate[1]
    degree = pad_to_multiple(graph.degree.astype(np.int32), k)
    n_padded = degree.shape[0]
    n_loc = n_padded // k
    width = graph.ell_width
    ell = None
    if ell_delays is None and graph.indices.size:
        uniform = int(constant_delay)
        ring = uniform + 1
        delay_values = None
        cnt = np.pad(graph.degree.astype(np.int64), (0, n_padded - graph.n))
        group_inputs = [(cnt, width, graph.ell_rows)]
    else:
        ell_idx, ell_mask = graph.ell()
        delays = (np.full(ell_idx.shape, constant_delay, dtype=np.int32)
                  if ell_delays is None else np.asarray(ell_delays))
        ring = (int(delays.max()) if delays.size else 1) + 1
        uniform = detect_uniform_delay(delays, ell_mask)
        ell = (pad_to_multiple(ell_idx, k), pad_to_multiple(ell_mask, k))
        delays = pad_to_multiple(delays, k, fill=1)

        def rows_of(i, m):
            return lambda r, c: (i[r, :c], m[r, :c])

        if uniform is not None:
            delay_values = None
            group_inputs = [(ell[1].sum(axis=1).astype(np.int64), width, rows_of(*ell))]
        else:
            splits = split_ell_by_delay(*ell[:1], delays, ell[1])
            delay_values = tuple(d for d, _, _ in splits)
            group_inputs = [(m.sum(axis=1).astype(np.int64), i.shape[1], rows_of(i, m))
                            for _, i, m in splits]
    groups, bucket_counts = [], []
    for cnt, gwidth, rows_fn in group_inputs:
        buckets = shard_buckets(cnt, gwidth, rows_fn, k, block=block,
                                min_rows=bucket_min_rows, shard=shard)
        bucketed = sum(r.shape[0] * i.shape[1] for r, i, _ in buckets) * k
        cap_full = max((i.shape[1] for _, i, _ in buckets), default=1)
        if bucketed > 0.75 * n_padded * min(cap_full, gwidth):
            # A uniform-degree group: the direct full-width pair (the JAX
            # package's rule; bucketing would save under 25%).
            cap = min(cap_full, gwidth)
            lo = shard * n_loc
            live = np.arange(lo, min(lo + n_loc, n_padded if ell is not None else graph.n))
            idx = np.zeros((n_loc, cap), dtype=np.int32)
            msk = np.zeros((n_loc, cap), dtype=bool)
            if live.size:
                idx[: live.size], msk[: live.size] = rows_fn(live, cap)
            groups.append(("direct", idx, msk))
            bucket_counts.append(0)
        else:
            groups.append(("buckets", buckets))
            bucket_counts.append(len(buckets))
    return ShardedGraph(
        graph=graph, k=k, shard=shard, n_padded=n_padded, uniform=uniform, ring=ring,
        delay_values=delay_values, groups=groups, bucket_counts=tuple(bucket_counts),
        degree=degree[shard * n_loc:(shard + 1) * n_loc],
    )


def _plan(sg: ShardedGraph, mesh, chunk_size, ring_mode, exchange, async_k, hub_rows,
          aux_cache):
    """The ring layout and the exchange plan of a call (the JAX package's
    ``_resolve_and_stage_ring``). Returns (plan, need, hub row ids): this
    shard's cut rows and its hub rows (local, and every shard's global
    ids), or None."""
    transport, k_async = async_ticks.parse_exchange(exchange, async_k)
    if k_async:
        ring_mode = "sharded"
    k, s, shard, n_padded, n_loc = sg.k, mesh.n_share_shards, sg.shard, sg.n_padded, sg.n_loc
    w = bitmask.num_words(chunk_size)
    ring = async_ticks.effective_ring(sg.ring, k_async)
    if transport in ("delta", "hub"):
        ring_mode = "sharded"  # the delta transport compresses sharded slots
    ring_mode, ring_bytes = resolve_ring_mode(ring_mode, sg.uniform, ring, n_padded, k, w)
    if transport == "auto":
        transport = "delta" if ring_mode == "sharded" and k > 1 else "dense"
    delay_splits = len(sg.delay_values) if sg.delay_values else 1
    ring_extra = {
        "mode": ring_mode, "bytes_per_chip": ring_bytes, "slots": ring,
        "delay_splits": delay_splits, "degree_buckets": sg.bucket_counts,
    }
    need = hub = None
    capacity = hub_count = 0
    if transport in ("delta", "hub"):
        need, need_counts = sg.cut(aux_cache)
        max_cut = int(need_counts.max()) if need_counts.size else 0
        hub_report = None
        if transport == "hub":
            hplan = sg.hub_split(w, delay_splits, hub_rows)
            hub_report = hplan["report"]
            need = hplan["need_tail"]
            capacity = hplan["capacity"]
            if hplan["hub_count"] > 0:
                hub_count = hplan["hub_count"]
                hub = (hplan["hub_local"][shard], hplan["hub_global"].reshape(-1))
        else:
            capacity = exch.delta_capacity(max(max_cut, 1), n_loc, w, delay_splits)
        exchange_extra = {
            "mode": transport,
            "capacity": capacity,
            "aggregated": exch.choose_aggregate(k, capacity),
            "max_cut_rows": max_cut,
            "modeled_dense_words_per_tick": exch.modeled_exchange_words_per_tick(
                "dense", n_shards=k, n_loc=n_loc, w=w, delay_splits=delay_splits),
            "modeled_delta_words_per_tick": (
                hub_report["modeled_delta_words_per_tick"] if hub_report is not None
                else exch.modeled_exchange_words_per_tick(
                    "delta", n_shards=k, n_loc=n_loc, w=w, capacity=capacity)
            ),
        }
        if hub_report is not None:
            exchange_extra.update({
                key: hub_report[key] for key in (
                    "hub_count", "hub_rows_forced", "crossover_h",
                    "modeled_hub_words_per_tick")
            })
        need = np.ascontiguousarray(need[shard * n_loc:(shard + 1) * n_loc])
    else:
        transport = "dense"
        mode = "dense" if ring_mode == "sharded" else "replicated"
        exchange_extra = {
            "mode": mode, "capacity": 0,
            "modeled_dense_words_per_tick": exch.modeled_exchange_words_per_tick(
                mode, n_shards=k, n_loc=n_loc, w=w, delay_splits=delay_splits),
        }
    if k_async:
        offs, off_index, amounts = async_ticks.group_offsets(sg.group_delays, k_async)
        exchange_extra.update(async_ticks.modeled_overlap_report(
            transport, sg.group_delays, k_async, k, n_loc, w, capacity,
            hub_count=hub_count))
    else:
        offs, off_index, amounts = (), (), ()
    plan = _Plan(
        n_padded=n_padded, k=k, s=s, chunk=chunk_size, w=w, ring=ring,
        ring_mode=ring_mode, group_delays=tuple(sg.group_delays),
        ring_extra=ring_extra, mode=transport,
        capacity=capacity, exchange_extra=exchange_extra, hub_count=hub_count,
        async_k=k_async, offs=offs, off_index=off_index, amounts=amounts,
    )
    return plan, need, hub


def _achieved_exchange_report(exchange_extra, counters, ticks, n_shards, n_loc, w,
                              capacity, hub_count=0):
    """The delta path's achieved traffic in ``stats.extra['exchange']``:
    used entries, overflow write ticks and dense fallback reads summed over
    passes and share shards, the achieved per-rank words a tick and the
    buffers' occupancy (the JAX package's report, key for key)."""
    k = n_shards
    extra = dict(exchange_extra)
    extra["achieved_used_entries"] = int(counters[0])
    extra["overflow_write_ticks"] = int(counters[1])
    extra["dense_fallback_reads"] = int(counters[2])
    extra["exchange_ticks"] = int(ticks)
    if ticks:
        extra["achieved_delta_words_per_tick"] = (
            (k - 1) * (2 * capacity + hub_count * w)
            + int(counters[2]) * (k - 1) * n_loc * w / ticks
        )
        extra["delta_occupancy"] = int(counters[0]) / (
            ticks * k * max(1, k - 1) * capacity
        )
    return extra


def _padded_churn(churn, n_padded: int, k: int, shard: int):
    """This shard's rows of the churn intervals (None when churn is off:
    every node up, the JAX package's vacuous zero intervals)."""
    if churn is None:
        return None
    n_loc = n_padded // k
    rows = slice(shard * n_loc, (shard + 1) * n_loc)
    return (pad_to_multiple(churn.down_start, k)[rows],
            pad_to_multiple(churn.down_end, k)[rows])


# --- the per-rank runner -------------------------------------------------------

class _Runner:
    """One rank's staged operands and its pass loop."""

    def __init__(self, plan: _Plan, mesh, sg: ShardedGraph, need, hub, churn, loss,
                 connect_tick: int, telemetry_on: bool, plain: bool):
        self.plan, self.mesh, self.plain = plan, mesh, plain
        self.dev = dev = mesh.device
        self.q, self.p = mesh.coordinate
        self.row_offset = self.p * plan.n_loc
        self.nodes = mesh.nodes_group
        self.shares = mesh.shares_group

        def i32(a):
            return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32), device=dev)

        self.groups, self.degree = sg.on_device(dev)
        self.need = None if need is None else torch.as_tensor(need, device=dev)
        self.hub = None if hub is None else (
            torch.as_tensor(hub[0].astype(np.int64), device=dev),
            torch.as_tensor(hub[1].astype(np.int64), device=dev))
        self.churn = None if churn is None else tuple(i32(c) for c in churn)
        self.loss = None if loss is None else loss.static_cfg
        self.connect_tick = int(connect_tick)
        self.tel = telemetry_on
        staged = [self.degree]
        for g in self.groups:
            staged += list(g[1:]) if g[0] == "direct" else [t for b in g[1] for t in b]
        staged += [t for t in (self.need, *(self.hub or ()), *(self.churn or ()))
                   if t is not None]
        self.staged_bytes = sum(t.numel() * t.element_size() for t in staged)
        # Groups reading one landed offset share its canvas.
        self.uses = {off: plan.off_index.count(i) for i, off in enumerate(plan.offs)}

    def resident_bytes(self, horizon: int, cov_slots: int | None = None) -> int:
        """Modeled peak device memory of this rank over a call (the per-rank
        form of `engine.sync.flood_resident_hbm_bytes`), counted from the
        code: the staged operands (``staged_bytes``); the pass state —
        ``seen``, the ring (local rows, or all rows when replicated, then
        with its occupancy ring), the counters, the delta rings and hub
        ring, the coverage rows; and the tick's peak in
        `apply_tick_updates`: four (n_loc, W) temporaries (arrivals, the
        generation bits, ~seen, newly) and, when gathers read a sharded
        ring, the read canvas (n_padded, W) with its occupancy, or the
        landed canvases under async (two an offset on the dense
        transport: this tick's and the next's in flight)."""
        p = self.plan
        row = p.w * 4
        rows = p.n_padded if not p.sharded_ring else p.n_loc
        state = (p.ring * rows + p.n_loc) * row + 2 * p.n_loc * 4
        if not p.sharded_ring:
            state += p.ring * rows * 4
        if p.delta:
            state += 2 * p.ring * p.k * p.capacity * 4 + p.ring * p.k * p.hub_count * row
        if cov_slots:
            state += (p.s + 1) * horizon * cov_slots * 4
        tick = 4 * p.n_loc * row
        if len(self.groups) > 1:
            tick += p.n_loc * row
        if not p.sharded_ring and p.k > 1:
            tick += p.n_loc * row
        if p.sharded_ring:
            canvases = len(p.offs) * (1 if p.delta else 2) if p.offs else 1
            tick += canvases * p.n_padded * row + p.n_padded * 4
        return self.staged_bytes + state + tick

    # -- collectives ----------------------------------------------------------

    def _gather_rows(self, local: torch.Tensor, async_op: bool = False):
        """all_gather of a (n_loc, ...) local slice over the nodes group into
        a fresh (n_padded, ...) tensor (and the work handle when async)."""
        out = torch.empty((self.plan.n_padded,) + tuple(local.shape[1:]),
                          dtype=local.dtype, device=self.dev)
        work = all_gather_rows(out, local, self.nodes, async_op=async_op)
        return (out, work) if async_op else out

    # -- the read side ----------------------------------------------------------

    def _rebuild(self, st, slot: int) -> torch.Tensor:
        """A slot's remote rows from its received delta buffers (and hub
        block); own rows zero."""
        p = self.plan
        canvas = kernels.scatter_deltas(st["didx"][slot], st["dval"][slot], p.n_loc, p.w,
                                        p.n_padded, plain=self.plain)
        if self.hub is not None:
            exch.overlay_hub(canvas, self.hub[1], st["hub"][slot])
        return canvas

    def _overlay_own(self, canvas, st, slot: int) -> torch.Tensor:
        canvas[self.row_offset:self.row_offset + self.plan.n_loc] = st["hist"][slot]
        return canvas

    def _landed(self, st, off: int) -> torch.Tensor:
        """The landed canvas of offset ``off`` this tick: slot (t - off)'s
        remote rows, from the all_gather issued a tick ago (waited on
        here), or rebuilt from its delta buffers; zeros on a pass's first
        tick (the ring is zero then). Resolved once a tick."""
        kind, value = st["landed"].get(off, ("zero", None))
        if kind == "dense":
            value[1].wait()
            value = value[0]
        elif kind == "delta":
            value = self._rebuild(st, value)
        elif kind == "zero":
            value = torch.zeros((self.plan.n_padded, self.plan.w), dtype=torch.int32,
                                device=self.dev)
        st["landed"][off] = ("canvas", value)
        return value

    def _read(self, st, t: int, g: int):
        """The global (t - d) frontier slice group ``g`` reads, as (ring,
        occ, slot index) for `kernels.gather_or`, and for a landed read
        with added staleness, whether the landed canvas holds a remote bit
        (else None)."""
        p = self.plan
        d = p.group_delays[g]
        slot = (t - d) % p.ring
        if not p.sharded_ring:
            return st["hist"], st["occ"], slot, None
        pending = None
        if p.offs and p.off_index[g] >= 0:
            # Remote rows from slot t - max(d, K), own rows timely (t - d).
            off = p.offs[p.off_index[g]]
            base = self._landed(st, off)
            if self.tel and p.amounts[g] > 0:
                lo, hi = self.row_offset, self.row_offset + p.n_loc
                pending = (base[:lo] != 0).any() | (base[hi:] != 0).any()
            canvas = self._overlay_own(base.clone() if self.uses[off] > 1 else base, st, slot)
        elif p.delta and not st["flags"][self.q][slot]:
            canvas = self._overlay_own(self._rebuild(st, slot), st, slot)
        else:
            canvas = self._gather_rows(st["hist"][slot])
        occ = kernels.sector_occupancy(canvas, plain=self.plain)
        return canvas[None], occ[None], 0, pending

    def _prefetch(self, st, t: int) -> dict:
        """Tick t+1's landed slices, issued at the top of tick t from the
        pre-write ring: a dense slot's all_gather goes out now with
        ``async_op=True`` (slot t+1-off was written at tick t+1-off <= t-1
        and is not this tick's write slot); a delta slot's buffers already
        arrived at its write, and it is rebuilt at the read."""
        p = self.plan
        landed = {}
        for off in p.offs:
            slot = (t + 1 - off) % p.ring
            if p.delta and not st["flags"][self.q][slot]:
                landed[off] = ("delta", slot)
            else:
                landed[off] = ("dense", self._gather_rows(st["hist"][slot], async_op=True))
        return landed

    def _gather(self, src, occ, slot, t, g, out, loss, up):
        """Group g's gather-OR of ``src`` into ``out`` (n_loc, W)."""
        kind = self.groups[g][0]
        kw = dict(uniform_slot=slot, occ=occ, loss=loss, up=up, out=out,
                  id_offset=self.row_offset, plain=self.plain)
        if kind == "direct":
            _, idx, msk = self.groups[g]
            kernels.gather_or(src, t, idx, msk, **kw)
            return out
        out.zero_()
        for rows, idx, msk in self.groups[g][1]:
            kernels.gather_or(src, t, idx, msk, rows=rows, **kw)
        return out

    # -- one pass ----------------------------------------------------------------

    def run_pass(self, origins, gen_ticks, t_start, last_gen, horizon, snap_ticks,
                 cov_slots=None):
        """Run one pass (this rank's share shard's ``origins``/``gen_ticks``,
        (chunk,) int32 numpy) from ``t_start`` to quiescence or the
        horizon. Returns a dict of host values, identical on every rank:
        the global counters, the tick count, the exchange counters and,
        when recorded, every share shard's coverage rows and rings."""
        p, dev, plain = self.plan, self.dev, self.plain
        n_loc, w, ring = p.n_loc, p.w, p.ring
        rows = p.n_padded if not p.sharded_ring else n_loc
        st = {
            "hist": torch.zeros((ring, rows, w), dtype=torch.int32, device=dev),
            "flags": [[False] * ring for _ in range(p.s)],
            "landed": {},
        }
        if not p.sharded_ring:
            st["occ"] = torch.zeros((ring, rows), dtype=torch.int32, device=dev)
        if p.delta:
            st["didx"] = torch.full((ring, p.k, p.capacity), -1, dtype=torch.int32, device=dev)
            st["dval"] = torch.zeros((ring, p.k, p.capacity), dtype=torch.int32, device=dev)
            if self.hub is not None:
                st["hub"] = torch.zeros((ring, p.k * p.hub_count, w), dtype=torch.int32,
                                        device=dev)
        seen = torch.zeros((n_loc, w), dtype=torch.int32, device=dev)
        received = torch.zeros((n_loc,), dtype=torch.int32, device=dev)
        sent = torch.zeros((n_loc,), dtype=torch.int32, device=dev)
        snaps = torch.zeros((len(snap_ticks), n_loc), dtype=torch.int32, device=dev)
        local = origins.astype(np.int64) - self.row_offset
        in_shard = (local >= 0) & (local < n_loc)
        local_rows = torch.as_tensor(np.where(in_shard, local, 0), device=dev)
        in_shard = torch.as_tensor(in_shard, device=dev)
        gen_ticks = torch.as_tensor(gen_ticks, device=dev)
        slots = torch.arange(p.chunk, dtype=torch.int64, device=dev)
        record = cov_slots is not None
        if record:
            cov_w = bitmask.num_words(cov_slots)
            cov_run = torch.zeros((cov_slots,), dtype=torch.int32, device=dev)
            cov_hist = torch.zeros((horizon, cov_slots), dtype=torch.int32, device=dev)
        rings = tel_rings.chunk_rings(horizon, dev) if self.tel else None
        newly_buf = (torch.empty((n_loc, w), dtype=torch.int32, device=dev)
                     if not p.sharded_ring and p.k > 1 else None)
        vec = torch.zeros((1 + 2 * p.s,), dtype=torch.int64, device=dev)
        used = ovf_ticks = fallbacks = 0
        in_flight = [False] * ring
        t = t_start
        while t < horizon and (any(in_flight) or t <= last_gen):
            fb = [sum(st["flags"][q][(t - d) % ring] for d in p.read_backs)
                  for q in range(p.s)] if p.delta else None
            landed_next = self._prefetch(st, t) if p.offs else None
            for i, b in enumerate(snap_ticks):
                if b == t:
                    snaps[i].copy_(received)
            up = None if self.churn is None else churn_mod.up_mask(*self.churn, t)
            arrivals = torch.empty((n_loc, w), dtype=torch.int32, device=dev)
            part = torch.empty_like(arrivals) if len(self.groups) > 1 else None
            if self.tel:
                wire = arrivals
                lossless = (torch.empty_like(arrivals) if self.loss is not None else None)
                part_nl = (torch.empty_like(arrivals)
                           if self.loss is not None and part is not None else None)
                stale = folds = torch.zeros((), dtype=torch.int64, device=dev)
            for g in range(len(self.groups)):
                src, occ, slot, pending = self._read(st, t, g)
                gather_up = None if self.tel else up
                out = arrivals if g == 0 else part
                self._gather(src, occ, slot, t, g, out, self.loss, gather_up)
                if g:
                    arrivals |= part
                if self.tel and self.loss is not None:
                    out_nl = lossless if g == 0 else part_nl
                    self._gather(src, occ, slot, t, g, out_nl, None, None)
                    if g:
                        lossless |= part_nl
                if pending is not None:
                    stale = stale + p.amounts[g] * pending.to(torch.int64)
                    folds = folds + pending.to(torch.int64)
            if self.tel and up is not None:
                wire = arrivals.clone()
                arrivals &= -up.to(torch.int32)[:, None]
            gen_active = (gen_ticks == t) & in_shard
            if up is not None:
                gen_active &= up[local_rows]
            gen_bits = bitmask.slot_scatter(n_loc, w, local_rows, slots, gen_active)
            gen_cnt = torch.zeros((n_loc,), dtype=torch.int32, device=dev)
            gen_cnt.index_add_(0, local_rows, gen_active.to(torch.int32))
            pre_connect = t < self.connect_tick
            live_bits, live_cnt = gen_bits, gen_cnt
            if pre_connect:
                live_bits, live_cnt = torch.zeros_like(gen_bits), torch.zeros_like(gen_cnt)
            slot_w = t % ring
            out = newly_buf if newly_buf is not None else st["hist"][slot_w]
            _, newly_out, _, _, newly_cnt = apply_tick_updates(
                seen, arrivals, live_bits, live_cnt, received, sent, self.degree,
                out=out, plain=plain,
            )
            if pre_connect:
                seen |= gen_bits
            if not p.sharded_ring:
                if newly_buf is not None:
                    all_gather_rows(st["hist"][slot_w], newly_out, self.nodes)
                kernels.sector_occupancy(st["hist"][slot_w], out=st["occ"][slot_w],
                                         plain=plain)
            vec.zero_()
            vec[0] = (newly_cnt.sum() + live_cnt.sum()) > 0
            if p.delta:
                cidx, cval, counts = kernels.compress_deltas(newly_out, self.need,
                                                             p.capacity, plain=plain)
                dist.all_to_all_single(st["didx"][slot_w].view(-1), cidx.view(-1),
                                       group=self.nodes)
                dist.all_to_all_single(st["dval"][slot_w].view(-1), cval.view(-1),
                                       group=self.nodes)
                if self.hub is not None:
                    all_gather_rows(st["hub"][slot_w], newly_out[self.hub[0]], self.nodes)
                vec[1 + self.q] = (counts > p.capacity).any()
                vec[1 + p.s + self.q] = counts.clamp(max=p.capacity).sum()
            if record:
                cov = bitmask.coverage_per_slot(newly_out[:, :cov_w], cov_slots, plain=plain)
                dist.all_reduce(cov, group=self.nodes)
                cov_run += cov
                cov_hist[t] = cov_run
            if self.tel:
                self._telemetry_row(rings, t, wire, newly_out, newly_cnt, lossless, fb,
                                    stale, folds, seen, received, sent)
            dist.all_reduce(vec, group=self.mesh.group)
            host = vec.tolist()  # the tick's one host read, mesh-uniform
            in_flight[slot_w] = host[0] > 0
            if p.delta:
                for q in range(p.s):
                    st["flags"][q][slot_w] = host[1 + q] > 0
                used += sum(host[1 + p.s:])
                ovf_ticks += sum(1 for q in range(p.s) if host[1 + q] > 0)
                fallbacks += sum(fb)
            if landed_next is not None:
                st["landed"] = landed_next
            t += 1
        for kind, value in st["landed"].values():
            if kind == "dense":  # a prefetch no tick reads: done before its buffer goes
                value[1].wait()
        for i, b in enumerate(snap_ticks):
            if b >= t:
                snaps[i].copy_(received)
        if record:
            cov_hist[t:] = cov_run
        # Global counters on every rank: own rows into a zero canvas, one
        # SUM over the mesh (disjoint over nodes, added over shares; int32
        # wraps as the JAX psum does).
        counters = torch.zeros((2 + len(snap_ticks), p.n_padded), dtype=torch.int32,
                               device=dev)
        own = slice(self.row_offset, self.row_offset + n_loc)
        counters[0, own] = received
        counters[1, own] = sent
        counters[2:, own] = snaps
        dist.all_reduce(counters, group=self.mesh.group)
        out = {
            "counters": counters.cpu().numpy(), "ticks": t - t_start,
            "exchange": (used, ovf_ticks, fallbacks, p.s * (t - t_start)),
        }
        if record:
            out["coverage"] = self._gather_shares(cov_hist)
        if self.tel:
            out["rings"] = tuple(self._gather_shares(r) for r in rings)
        return out

    def _gather_shares(self, local: torch.Tensor) -> np.ndarray:
        """Every share shard's ``local`` tensor, stacked on the host."""
        out = torch.empty((self.plan.s * local.shape[0],) + tuple(local.shape[1:]),
                          dtype=local.dtype, device=self.dev)
        all_gather_rows(out, local, self.shares)
        return out.view((self.plan.s,) + tuple(local.shape)).cpu().numpy()

    def _telemetry_row(self, rings, t, wire, newly_out, received_delta, lossless, fb,
                       stale, folds, seen, received, sent):
        """Row t of the metric ring, SUMmed over the nodes group (uint32
        wrap), and the digest of the post-tick state over the node shards
        (`telemetry.digest.tick_digest_sharded`)."""
        p = self.plan
        met, dig = rings
        tel_rings.flood_row(met, t, wire, newly_out, received_delta, self.degree, lossless,
                            plain=self.plain)
        k1 = p.k - 1
        if p.delta:
            words = k1 * (2 * p.capacity + p.hub_count * p.w) + fb[self.q] * k1 * p.n_loc * p.w
        elif p.sharded_ring:
            reads = (len(p.offs) + sum(1 for i in p.off_index if i < 0)
                     if p.async_k else len(p.group_delays))
            words = reads * k1 * p.n_loc * p.w
        else:
            words = k1 * p.n_loc * p.w
        met[t, 6] = words & _U32
        met[t, 7] = stale
        met[t, 8] = folds
        dist.all_reduce(met[t], group=self.nodes)
        met[t] &= _U32
        dig[t] = tel_digest.tick_digest_sharded(
            seen, received, sent, id_offset=self.row_offset, group=self.nodes,
            plain=self.plain)


def _agree(mesh, flag: bool) -> bool:
    """True when any rank of the mesh says so (telemetry must be on or
    off on every rank alike: its rows add collectives)."""
    v = torch.tensor([int(flag)], dtype=torch.int64, device=mesh.device)
    dist.all_reduce(v, group=mesh.group)
    return bool(v.item())


def _setup(graph, mesh, ell_delays, constant_delay, chunk_size, ring_mode, exchange,
           async_k, hub_rows, aux_cache, block, bucket_min_rows, churn, loss,
           connect_tick, plain, sharded_graph):
    if sharded_graph is None:
        sharded_graph = stage_sharded_graph(graph, mesh, ell_delays, constant_delay, block,
                                            bucket_min_rows)
    elif (sharded_graph.graph is not graph or sharded_graph.k != mesh.n_node_shards
          or mesh.coordinate is None or sharded_graph.shard != mesh.coordinate[1]):
        raise ValueError("sharded_graph was staged for another graph, mesh or rank")
    plan, need, hub = _plan(sharded_graph, mesh, chunk_size, ring_mode, exchange, async_k,
                            hub_rows, aux_cache)
    tel = _agree(mesh, tel_sink.rings_enabled())
    runner = _Runner(plan, mesh, sharded_graph, need, hub,
                     _padded_churn(churn, plan.n_padded, plan.k, sharded_graph.shard), loss,
                     connect_tick, tel, plain)
    return plan, runner


def _exchange_report(plan: _Plan, counters) -> dict:
    if not plan.delta:
        return plan.exchange_extra
    used, ovf, fallbacks, ticks = counters
    return _achieved_exchange_report(plan.exchange_extra, (used, ovf, fallbacks), ticks,
                                     plan.k, plan.n_loc, plan.w, plan.capacity,
                                     hub_count=plan.hub_count)


def _emit_rings(name, rings, t0, s, **prov):
    """One ring and one digest event a share shard (the JAX package's
    per-shard events); returns the first shard's last digest."""
    mets, digs = rings
    head = None
    for k in range(s):
        tel_rings.emit_ring(name, mets[k], t0=t0, shard=k, **prov)
        nz = np.flatnonzero(digs[k])
        ticks = int(nz[-1]) + 1 - t0 if nz.size else 0
        tel_digest.emit_digest(name, digs[k], t0=t0, ticks=ticks, shard=k, **prov)
        if k == 0 and nz.size:
            head = int(digs[0][nz[-1]]) & _U32
    return head


def run_sharded_sim(
    graph,
    schedule: Schedule,
    horizon_ticks: int,
    mesh,
    ell_delays: np.ndarray | None = None,
    constant_delay: int = 1,
    chunk_size: int = 4096,
    block: int | None = None,
    churn=None,
    snapshot_ticks: list[int] | None = None,
    loss=None,
    checkpoint_path: str | None = None,
    checkpoint_every: int = 1,
    stop_after_chunks: int | None = None,
    ring_mode: str = "auto",
    connect_tick: int = 0,
    bucket_min_rows: int = 2048,
    exchange: str = "dense",
    async_k: int = 2,
    hub_rows: int | None = None,
    aux_cache: tuple | None = None,
    *,
    sharded_graph: ShardedGraph | None = None,
    plain: bool = False,
) -> NodeStats:
    """The counterpart of `engine.sync.run_sync_sim` on a (shares, nodes)
    mesh (`parallel.mesh.make_mesh`), called by every rank of the mesh:
    the JAX package's ``run_sharded_sim``, argument for argument, and the
    same per-node counters, snapshots and ``stats.extra['ring']`` /
    ``['exchange']``. ``chunk_size`` is per share shard (a pass carries
    shares x chunk shares). ``block`` is the degree quantum of the bucket
    planner (default `ops.ell.DEFAULT_DEGREE_BLOCK`, the JAX package's
    off-TPU value). ``ring_mode``, ``exchange``, ``async_k``, ``hub_rows``
    and ``aux_cache`` as in the module docstring and
    `parallel.exchange`. A checkpoint is written by the mesh's first rank
    in the JAX sharded engine's format (same fingerprint: either package
    resumes the other's); every rank reads it. ``sharded_graph`` (from
    `stage_sharded_graph`) skips the host staging. ``stats.extra
    ['ticks_executed']`` counts the passes' ticks and ``['resident_bytes']``
    is this rank's modeled peak device memory (`_Runner.resident_bytes`).
    ``plain=True`` runs the kernels' plain versions."""
    chunk_size = bitmask.num_words(chunk_size) * bitmask.WORD_BITS
    plan, runner = _setup(graph, mesh, ell_delays, constant_delay, chunk_size,
                          ring_mode, exchange, async_k, hub_rows, aux_cache, block,
                          bucket_min_rows, churn, loss, connect_tick, plain, sharded_graph)
    s = plan.s
    pass_size = s * chunk_size
    boundaries = filter_snapshot_boundaries(snapshot_ticks, horizon_ticks)
    received = np.zeros(plan.n_padded, dtype=np.int64)
    sent = np.zeros(plan.n_padded, dtype=np.int64)
    snap_received = np.zeros((len(boundaries), plan.n_padded), dtype=np.int64)
    checkpointer = None
    if checkpoint_path is not None:
        # The JAX sharded engine's fingerprint, part for part.
        ckpt_fp = fingerprint(
            "sharded_sim", graph.n, graph.edges(), schedule.origins,
            schedule.gen_ticks, horizon_ticks, chunk_size, s, plan.k,
            ell_delays if ell_delays is not None else constant_delay,
            churn.down_start if churn is not None else None,
            churn.down_end if churn is not None else None,
            np.asarray(loss.static_cfg, dtype=np.int64) if loss is not None else None,
            *([np.asarray(boundaries, dtype=np.int64)] if boundaries else []),
            *(["connect", connect_tick] if connect_tick else []),
            *(["async", plan.async_k] if plan.async_k else []),
        )
        cls = ChunkCheckpointer if mesh.is_first else _ReadOnlyCheckpointer
        checkpointer = cls(checkpoint_path, ckpt_fp,
                           {"received": received, "sent": sent,
                            "snap_received": snap_received}, checkpoint_every)
    name = "parallel.engine_sharded.run_sharded_sim"
    exch_totals = [0, 0, 0, 0]
    ticks_executed = 0
    chunks = schedule.chunk(pass_size)
    for ci, chunk in checkpointed_chunks(chunks, checkpointer, stop_after_chunks):
        live = chunk.gen_ticks < horizon_ticks
        if not live.any():
            continue
        origins, gen_ticks = chunk.padded(pass_size, horizon_ticks)
        t_start = int(chunk.gen_ticks[live].min())
        last_gen = int(chunk.gen_ticks[live].max())
        mine = slice(runner.q * chunk_size, (runner.q + 1) * chunk_size)
        with span("dispatch", kernel="parallel.engine_sharded.flood_runner", chunk=ci):
            out = runner.run_pass(origins[mine], gen_ticks[mine], t_start, last_gen,
                                  horizon_ticks, boundaries)
        with span("d2h", chunk=ci):
            c = out["counters"].astype(np.int64)
            received += c[0]
            sent += c[1]
            snap_received += c[2:]
        ticks_executed += out["ticks"]
        exch_totals = [a + b for a, b in zip(exch_totals, out["exchange"])]
        if mesh.is_first:
            head = (_emit_rings(name, out["rings"], t_start, s, chunk=ci)
                    if "rings" in out else None)
            tel_progress.emit_progress(name, chunk=ci, chunks_total=len(chunks),
                                       digest_head=head)
    generated = effective_generated(schedule, horizon_ticks, churn)
    received, sent = received[: graph.n], sent[: graph.n]
    stats = NodeStats(
        generated=generated, received=received, forwarded=received.copy(), sent=sent,
        processed=generated + received, degree=graph.degree.astype(np.int64),
    )
    stats.extra["ring"] = plan.ring_extra
    stats.extra["exchange"] = _exchange_report(plan, exch_totals)
    stats.extra["ticks_executed"] = ticks_executed
    stats.extra["resident_bytes"] = runner.resident_bytes(horizon_ticks)
    if snapshot_ticks is not None:
        stats.extra["snapshots"] = assemble_snapshots(
            schedule, churn, boundaries, snap_received[:, : graph.n],
            stats.degree.sum(),
        )
    return stats


class _ReadOnlyCheckpointer(ChunkCheckpointer):
    """A rank other than the mesh's first: resumes from the checkpoint as
    every rank must (the same chunks are skipped everywhere) and never
    writes it."""

    def save(self, next_chunk: int) -> None:
        pass


def run_sharded_flood_coverage(
    graph,
    origins,
    horizon_ticks: int,
    mesh,
    ell_delays: np.ndarray | None = None,
    constant_delay: int = 1,
    chunk_size: int = 4096,
    block: int | None = None,
    churn=None,
    loss=None,
    ring_mode: str = "auto",
    bucket_min_rows: int = 2048,
    exchange: str = "dense",
    async_k: int = 2,
    hub_rows: int | None = None,
    aux_cache: tuple | None = None,
    *,
    sharded_graph: ShardedGraph | None = None,
    plain: bool = False,
):
    """The flood coverage experiment on the mesh (the JAX package's
    ``run_sharded_flood_coverage``), called by every rank: one share an
    origin at t = 0, in one pass of shares x chunk shares. Returns (stats,
    (horizon, num_origins) per-tick node counts), equal to
    `engine.sync.run_flood_coverage`'s for every mesh shape; options as in
    `run_sharded_sim`."""
    origins = np.asarray(origins, dtype=np.int32).reshape(-1)
    n_shares = origins.shape[0]
    s = mesh.n_share_shards
    per_shard = -(-n_shares // s)
    chunk_size = bitmask.num_words(max(per_shard, chunk_size)) * bitmask.WORD_BITS
    cov_slots = bitmask.num_words(min(n_shares, chunk_size)) * bitmask.WORD_BITS
    sched = Schedule(graph.n, origins, np.zeros(n_shares, dtype=np.int32))
    plan, runner = _setup(graph, mesh, ell_delays, constant_delay, chunk_size,
                          ring_mode, exchange, async_k, hub_rows, aux_cache, block,
                          bucket_min_rows, churn, loss, 0, plain, sharded_graph)
    pass_size = s * chunk_size
    o, g_ticks = sched.padded(pass_size, horizon_ticks)
    mine = slice(runner.q * chunk_size, (runner.q + 1) * chunk_size)
    with span("dispatch", kernel="parallel.engine_sharded.flood_runner"):
        out = runner.run_pass(o[mine], g_ticks[mine], 0, 0, horizon_ticks, [],
                              cov_slots=cov_slots)
    name = "parallel.engine_sharded.run_sharded_flood_coverage"
    head = None
    if mesh.is_first and "rings" in out:
        head = _emit_rings(name, out["rings"], 0, s)
    generated = effective_generated(sched, horizon_ticks, churn)
    c = out["counters"].astype(np.int64)
    received = c[0][: graph.n]
    stats = NodeStats(
        generated=generated, received=received, forwarded=received.copy(),
        sent=c[1][: graph.n], processed=generated + received,
        degree=graph.degree.astype(np.int64),
    )
    cov = out["coverage"]
    parts = [cov[k][:, : min(max(n_shares - k * chunk_size, 0), chunk_size)]
             for k in range(s)]
    coverage = np.concatenate(parts, axis=1)
    if mesh.is_first:
        tel_progress.emit_progress(
            name, chunk=0, chunks_total=1, ticks_done=int(coverage.shape[0]),
            coverage_pct=(float(coverage[-1].mean()) / graph.n * 100.0
                          if coverage.size else None),
            digest_head=head,
        )
    stats.extra["coverage"] = coverage
    stats.extra["ring"] = plan.ring_extra
    stats.extra["exchange"] = _exchange_report(plan, out["exchange"])
    stats.extra["ticks_executed"] = out["ticks"]
    stats.extra["resident_bytes"] = runner.resident_bytes(horizon_ticks, cov_slots)
    return stats, coverage
