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

Campaign mode (the JAX package's ``replica_axis``; `batch.campaign_sharded`
drives it): on a (replicas, nodes) mesh a rank runs rb local replicas at
once, stacked along the rows of every state tensor, with one overflow
flag and one set of exchange counters a replica in the same mesh vector.
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
from p2p_gossip_tpu_torch.parallel.mesh import SHARES_AXIS, all_gather_rows, pad_to_multiple
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

def replica_major(gathered: torch.Tensor, k: int, rb: int) -> torch.Tensor:
    """An all_gather over k node shards of rb stacked replicas' rows lands
    rank-major, (k, rb, n_loc, ...); return it replica-major, (rb, k *
    n_loc, ...) flattened, replica b's global slice at rows b * n_padded (a
    copy when rb > 1 and k > 1; the same tensor otherwise)."""
    if rb == 1 or k == 1:
        return gathered
    rest = tuple(gathered.shape[1:])
    return (gathered.view((k, rb, -1) + rest).transpose(0, 1)
            .reshape((gathered.shape[0],) + rest))


def gather_first(local: torch.Tensor, s: int, group) -> np.ndarray:
    """Every first-axis shard's ``local`` tensor (all_gathered over the
    first axis' ``group`` of ``s`` ranks), stacked on the host."""
    out = torch.empty((s * local.shape[0],) + tuple(local.shape[1:]), dtype=local.dtype,
                      device=local.device)
    all_gather_rows(out, local.contiguous(), group)
    return out.view((s,) + tuple(local.shape)).cpu().numpy()


class _Runner:
    """One rank's staged operands and its pass loop.

    ``replicas`` > 0 is campaign mode (the JAX package's ``replica_axis`` /
    ``local_replicas``): the mesh's first axis carries replica shards, and
    this rank runs ``replicas`` rb local replicas of its node shard at
    once, their state stacked along the rows (``seen`` (rb*n_loc, W), the
    ring (ring, rb*rows, W), the counters (rb*n_loc,)), each with its own
    schedule, churn rows and loss seed (given per pass). Every launch
    covers the local batch; each replica keeps its own delta flags and
    exchange counters. 0 is the one-run engine (rb = 1)."""

    def __init__(self, plan: _Plan, mesh, sg: ShardedGraph, need, hub, churn, loss,
                 connect_tick: int, telemetry_on: bool, plain: bool, replicas: int = 0):
        self.plan, self.mesh, self.plain = plan, mesh, plain
        self.dev = dev = mesh.device
        self.q, self.p = mesh.coordinate
        self.row_offset = self.p * plan.n_loc
        self.nodes = mesh.nodes_group
        self.first = mesh.first_group
        self.campaign = replicas > 0
        self.rb = rb = max(1, replicas)

        def i32(a):
            return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32), device=dev)

        self.groups, self.degree = sg.on_device(dev)
        self.degree_rb = self.degree.repeat(rb) if rb > 1 else self.degree
        self.need = None if need is None else torch.as_tensor(need, device=dev)
        self.hub = None if hub is None else (
            torch.as_tensor(hub[0].astype(np.int64), device=dev),
            torch.as_tensor(hub[1].astype(np.int64), device=dev))
        self.churn = None if churn is None else tuple(i32(c) for c in churn)
        self.loss = None if loss is None else (
            loss if isinstance(loss, tuple) else loss.static_cfg)
        self.connect_tick = int(connect_tick)
        self.tel = telemetry_on
        staged = [self.degree]
        for g in self.groups:
            staged += list(g[1:]) if g[0] == "direct" else [t for b in g[1] for t in b]
        staged += [t for t in (self.need, *(self.hub or ()), *(self.churn or ()))
                   if t is not None]
        self.staged_bytes = sum(t.numel() * t.element_size() for t in staged)
        if rb > 1:
            self.staged_bytes += self.degree_rb.numel() * 4
        self.pass_bytes = 0  # a campaign pass's own operands (churn rows), the largest
        # Groups reading one landed offset share its canvas.
        self.uses = {off: plan.off_index.count(i) for i, off in enumerate(plan.offs)}

    def resident_bytes(self, horizon: int, cov_slots: int | None = None) -> int:
        """Modeled peak device memory of this rank over a call (the per-rank
        form of `engine.sync.flood_resident_hbm_bytes`), counted from the
        code: the staged operands (``staged_bytes``, and a campaign pass's
        churn rows); the pass state — ``seen``, the ring (local rows, or all
        rows when replicated, then with its occupancy ring), the counters,
        the delta rings and hub ring, the coverage rows — each rb times in
        campaign mode; and the tick's peak in `apply_tick_updates`: four
        (rb*n_loc, W) temporaries (arrivals, the generation bits, ~seen,
        newly) and, when gathers read a sharded ring, the read canvas
        (rb*n_padded, W) with its occupancy, or the landed canvases under
        async (two an offset on the dense transport: this tick's and the
        next's in flight). With rb > 1 on several node shards an all_gather
        lands rank-major and is copied replica-major: one canvas more."""
        p, rb = self.plan, self.rb
        row = p.w * 4
        rows = p.n_padded if not p.sharded_ring else p.n_loc
        state = rb * ((p.ring * rows + p.n_loc) * row + 2 * p.n_loc * 4)
        if not p.sharded_ring:
            state += rb * p.ring * rows * 4
        if p.delta:
            state += rb * (2 * p.ring * p.k * p.capacity * 4 + p.ring * p.k * p.hub_count * row)
        if cov_slots:
            state += rb * (p.s + 1) * horizon * cov_slots * 4
        loc, glob = rb * p.n_loc * row, rb * p.n_padded * row
        tick = 4 * loc
        if len(self.groups) > 1:
            tick += loc
        transpose = rb > 1 and p.k > 1
        if not p.sharded_ring and p.k > 1:
            tick += loc + (glob if transpose else 0)
        if p.sharded_ring:
            canvases = len(p.offs) * (1 if p.delta else 2) if p.offs else 1
            tick += canvases * glob + rb * p.n_padded * 4 + (glob if transpose else 0)
        return self.staged_bytes + self.pass_bytes + state + tick

    # -- collectives ----------------------------------------------------------

    def _gather_rows(self, local: torch.Tensor, async_op: bool = False):
        """all_gather of a (rb*n_loc, ...) local slice over the nodes group
        into a fresh (rb*n_padded, ...) replica-major tensor; async, the
        rank-major buffer and the work handle (`replica_major` after the
        wait)."""
        out = torch.empty((self.plan.k * local.shape[0],) + tuple(local.shape[1:]),
                          dtype=local.dtype, device=self.dev)
        work = all_gather_rows(out, local, self.nodes, async_op=async_op)
        return (out, work) if async_op else replica_major(out, self.plan.k, self.rb)

    # -- the read side ----------------------------------------------------------

    def _rebuild(self, st, slot: int) -> torch.Tensor:
        """A slot's remote rows from its received delta buffers (and hub
        block), (rb*n_padded, W); own rows zero."""
        p = self.plan
        canvas = kernels.scatter_deltas(st["didx"][slot], st["dval"][slot], p.n_loc, p.w,
                                        p.n_padded, replicas=self.rb, plain=self.plain)
        if self.hub is not None:
            exch.overlay_hub(canvas, self.hub[1], st["hub"][slot], replicas=self.rb)
        return canvas.view(self.rb * p.n_padded, p.w)

    def _overlay_own(self, canvas, st, slot: int) -> torch.Tensor:
        p = self.plan
        lo = self.row_offset
        canvas.view(self.rb, p.n_padded, p.w)[:, lo:lo + p.n_loc] = (
            st["hist"][slot].view(self.rb, p.n_loc, p.w))
        return canvas

    def _landed(self, st, off: int) -> torch.Tensor:
        """The landed canvas of offset ``off`` this tick: slot (t - off)'s
        remote rows, from the all_gather issued a tick ago (waited on
        here), or rebuilt from its delta buffers; zeros on a pass's first
        tick (the ring is zero then). Resolved once a tick."""
        kind, value = st["landed"].get(off, ("zero", None))
        if kind == "dense":
            value[1].wait()
            value = replica_major(value[0], self.plan.k, self.rb)
        elif kind == "delta":
            value = self._rebuild(st, value)
        elif kind == "zero":
            value = torch.zeros((self.rb * self.plan.n_padded, self.plan.w),
                                dtype=torch.int32, device=self.dev)
        st["landed"][off] = ("canvas", value)
        return value

    def _flagged(self, st, slot: int) -> bool:
        """Any local replica's overflow flag on ``slot``: the dense read then
        serves the whole local batch (its values equal the rebuild's for
        every row a gather reads)."""
        return any(f[slot] for f in st["flags"][self.q])

    def _read(self, st, t: int, g: int):
        """The global (t - d) frontier slice group ``g`` reads, as (ring,
        occ, slot index) for `kernels.gather_or`, and for a landed read
        with added staleness, whether each local replica's landed canvas
        holds a remote bit ((rb,) bool; else None)."""
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
                v = base.view(self.rb, p.n_padded, p.w)
                pending = ((v[:, :lo] != 0).flatten(1).any(1)
                           | (v[:, hi:] != 0).flatten(1).any(1))
            canvas = self._overlay_own(base.clone() if self.uses[off] > 1 else base, st, slot)
        elif p.delta and not self._flagged(st, slot):
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
            if p.delta and not self._flagged(st, slot):
                landed[off] = ("delta", slot)
            else:
                landed[off] = ("dense", self._gather_rows(st["hist"][slot], async_op=True))
        return landed

    def _gather(self, src, occ, slot, t, g, out, loss, up):
        """Group g's gather-OR of ``src`` into ``out`` (rb*n_loc, W)."""
        kind = self.groups[g][0]
        kw = dict(uniform_slot=slot, occ=occ, loss=loss, up=up, out=out, replicas=self.rb,
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
                 cov_slots=None, churn=None, loss_seeds=None):
        """Run one pass (this rank's share shard's ``origins``/``gen_ticks``,
        (chunk,) int32 numpy; in campaign mode its local replicas' (rb,
        chunk), with their ``churn`` (rb*n_loc, K) int32 device rows and
        ``loss_seeds`` (rb,) int32 device tensor) from ``t_start`` to
        quiescence of every run on the mesh, or the horizon. Returns a dict
        of host values, identical on every rank: the global counters, the
        tick count, the exchange counters (and ``exchange_per``, one
        (used, overflow ticks, fallbacks, ticks) row a replica of the
        first axis) and, when recorded, every first-axis shard's coverage
        rows and rings."""
        p, dev, plain, rb = self.plan, self.dev, self.plain, self.rb
        n_loc, w, ring = p.n_loc, p.w, p.ring
        rows = p.n_padded if not p.sharded_ring else n_loc
        churn = self.churn if churn is None else churn
        loss = self.loss
        if loss is not None and loss_seeds is not None:
            loss = (loss[0], loss_seeds)
        if churn is not None and self.campaign:
            self.pass_bytes = max(self.pass_bytes,
                                  sum(c.numel() * c.element_size() for c in churn))
        st = {
            "hist": torch.zeros((ring, rb * rows, w), dtype=torch.int32, device=dev),
            # Each (first-axis shard, local replica)'s overflow flag a slot.
            "flags": [[[False] * ring for _ in range(rb)] for _ in range(p.s)],
            "landed": {},
        }
        if not p.sharded_ring:
            st["occ"] = torch.zeros((ring, rb * rows), dtype=torch.int32, device=dev)
        if p.delta:
            # Received buffers as the all_to_all leaves them: (source, replica).
            st["didx"] = torch.full((ring, p.k, rb, p.capacity), -1, dtype=torch.int32,
                                    device=dev)
            st["dval"] = torch.zeros((ring, p.k, rb, p.capacity), dtype=torch.int32,
                                     device=dev)
            if self.hub is not None:
                st["hub"] = torch.zeros((ring, p.k, rb, p.hub_count, w), dtype=torch.int32,
                                        device=dev)
        seen = torch.zeros((rb * n_loc, w), dtype=torch.int32, device=dev)
        received = torch.zeros((rb * n_loc,), dtype=torch.int32, device=dev)
        sent = torch.zeros((rb * n_loc,), dtype=torch.int32, device=dev)
        snaps = torch.zeros((len(snap_ticks), rb * n_loc), dtype=torch.int32, device=dev)
        origins = np.asarray(origins).reshape(rb, -1)
        local = origins.astype(np.int64) - self.row_offset
        in_shard = (local >= 0) & (local < n_loc)
        stacked = np.where(in_shard, local, 0) + np.arange(rb)[:, None] * n_loc
        local_rows = torch.as_tensor(stacked.reshape(-1), device=dev)
        in_shard = torch.as_tensor(in_shard.reshape(-1), device=dev)
        gen_ticks = torch.as_tensor(np.ascontiguousarray(np.asarray(gen_ticks).reshape(-1)),
                                    device=dev)
        slots = torch.arange(p.chunk, dtype=torch.int64, device=dev).repeat(rb)
        record = cov_slots is not None
        if record:
            cov_w = bitmask.num_words(cov_slots)
            cov_run = torch.zeros((rb, cov_slots), dtype=torch.int32, device=dev)
            cov_hist = torch.zeros((rb, horizon, cov_slots), dtype=torch.int32, device=dev)
        rings = (tel_rings.chunk_rings(horizon, dev, rb if self.campaign else None)
                 if self.tel else None)
        newly_buf = (torch.empty((rb * n_loc, w), dtype=torch.int32, device=dev)
                     if not p.sharded_ring and p.k > 1 else None)
        n_flags = p.s * rb
        vec = torch.zeros((1 + 2 * n_flags,), dtype=torch.int64, device=dev)
        mine = slice(1 + self.q * rb, 1 + (self.q + 1) * rb)
        mine_used = slice(1 + n_flags + self.q * rb, 1 + n_flags + (self.q + 1) * rb)
        used, ovf_ticks, fallbacks = ([0] * n_flags for _ in range(3))
        in_flight = [False] * ring
        t = t_start
        while t < horizon and (any(in_flight) or t <= last_gen):
            fb = [[sum(st["flags"][q][b][(t - d) % ring] for d in p.read_backs)
                   for b in range(rb)] for q in range(p.s)] if p.delta else None
            landed_next = self._prefetch(st, t) if p.offs else None
            for i, b in enumerate(snap_ticks):
                if b == t:
                    snaps[i].copy_(received)
            up = None if churn is None else churn_mod.up_mask(*churn, t)
            arrivals = torch.empty((rb * n_loc, w), dtype=torch.int32, device=dev)
            part = torch.empty_like(arrivals) if len(self.groups) > 1 else None
            if self.tel:
                wire = arrivals
                lossless = (torch.empty_like(arrivals) if loss is not None else None)
                part_nl = (torch.empty_like(arrivals)
                           if loss is not None and part is not None else None)
                stale = folds = torch.zeros((rb,), dtype=torch.int64, device=dev)
            for g in range(len(self.groups)):
                src, occ, slot, pending = self._read(st, t, g)
                gather_up = None if self.tel else up
                out = arrivals if g == 0 else part
                self._gather(src, occ, slot, t, g, out, loss, gather_up)
                if g:
                    arrivals |= part
                if self.tel and loss is not None:
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
            gen_bits = bitmask.slot_scatter(rb * n_loc, w, local_rows, slots, gen_active)
            gen_cnt = torch.zeros((rb * n_loc,), dtype=torch.int32, device=dev)
            gen_cnt.index_add_(0, local_rows, gen_active.to(torch.int32))
            pre_connect = t < self.connect_tick
            live_bits, live_cnt = gen_bits, gen_cnt
            if pre_connect:
                live_bits, live_cnt = torch.zeros_like(gen_bits), torch.zeros_like(gen_cnt)
            slot_w = t % ring
            out = newly_buf if newly_buf is not None else st["hist"][slot_w]
            _, newly_out, _, _, newly_cnt = apply_tick_updates(
                seen, arrivals, live_bits, live_cnt, received, sent, self.degree_rb,
                out=out, plain=plain,
            )
            if pre_connect:
                seen |= gen_bits
            if not p.sharded_ring:
                if newly_buf is not None:
                    if rb == 1:
                        all_gather_rows(st["hist"][slot_w], newly_out, self.nodes)
                    else:
                        st["hist"][slot_w].copy_(self._gather_rows(newly_out))
                kernels.sector_occupancy(st["hist"][slot_w], out=st["occ"][slot_w],
                                         plain=plain)
            vec.zero_()
            vec[0] = (newly_cnt.sum() + live_cnt.sum()) > 0
            if p.delta:
                cidx, cval, counts = kernels.compress_deltas(newly_out, self.need, p.capacity,
                                                             replicas=rb, plain=plain)
                # Destination-major for the all_to_all: (k, rb, capacity).
                dist.all_to_all_single(st["didx"][slot_w].view(-1),
                                       cidx.transpose(0, 1).contiguous().view(-1),
                                       group=self.nodes)
                dist.all_to_all_single(st["dval"][slot_w].view(-1),
                                       cval.transpose(0, 1).contiguous().view(-1),
                                       group=self.nodes)
                if self.hub is not None:
                    block = newly_out.view(rb, n_loc, w)[:, self.hub[0]].contiguous()
                    all_gather_rows(st["hub"][slot_w].view(-1, w), block.view(-1, w),
                                    self.nodes)
                vec[mine] = (counts > p.capacity).any(dim=1)
                vec[mine_used] = counts.clamp(max=p.capacity).sum(dim=1)
            if record:
                cov = bitmask.coverage_per_slot(newly_out.view(rb, n_loc, w)[:, :, :cov_w],
                                                cov_slots, plain=plain)
                dist.all_reduce(cov, group=self.nodes)
                cov_run += cov
                cov_hist[:, t] = cov_run
            if self.tel:
                self._telemetry_row(rings, t, wire, newly_out, newly_cnt, lossless, fb,
                                    stale, folds, seen, received, sent)
            dist.all_reduce(vec, group=self.mesh.group)
            host = vec.tolist()  # the tick's one host read, mesh-uniform
            in_flight[slot_w] = host[0] > 0
            if p.delta:
                for i in range(n_flags):
                    flag = host[1 + i] > 0
                    st["flags"][i // rb][i % rb][slot_w] = flag
                    used[i] += host[1 + n_flags + i]
                    ovf_ticks[i] += int(flag)
                    fallbacks[i] += fb[i // rb][i % rb]
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
            cov_hist[:, t:] = cov_run[:, None]
        # Global counters on every rank: own rows into a zero canvas, one
        # SUM over the mesh (disjoint over nodes; added over share shards,
        # or each replica shard at its own place; int32 wraps as the JAX
        # psum does).
        places = p.s if self.campaign else 1
        counters = torch.zeros((places, rb, 2 + len(snap_ticks), p.n_padded),
                               dtype=torch.int32, device=dev)
        own = slice(self.row_offset, self.row_offset + n_loc)
        here = counters[self.q if self.campaign else 0]
        here[:, 0, own] = received.view(rb, n_loc)
        here[:, 1, own] = sent.view(rb, n_loc)
        here[:, 2:, own] = snaps.view(len(snap_ticks), rb, n_loc).transpose(0, 1)
        dist.all_reduce(counters, group=self.mesh.group)
        ticks = t - t_start
        per = np.array([used, ovf_ticks, fallbacks, [ticks] * n_flags],
                       dtype=np.int64).T.reshape(n_flags, 4)
        out = {
            "counters": (counters.view(places * rb, 2 + len(snap_ticks), p.n_padded)
                         .cpu().numpy()),
            "ticks": ticks,
            "exchange": (sum(used), sum(ovf_ticks), sum(fallbacks), p.s * ticks),
            "exchange_per": per,
        }
        if not self.campaign:
            out["counters"] = out["counters"][0]
        if record:
            cov = gather_first(cov_hist, p.s, self.first)  # (s, rb, horizon, S)
            out["coverage"] = cov.reshape((-1,) + cov.shape[2:]) if self.campaign else cov[:, 0]
        if self.tel:
            out["rings"] = tuple(gather_first(r, p.s, self.first) for r in rings)
            if self.campaign:
                out["rings"] = tuple(r.reshape((-1,) + r.shape[2:]) for r in out["rings"])
        return out

    def _telemetry_row(self, rings, t, wire, newly_out, received_delta, lossless, fb,
                       stale, folds, seen, received, sent):
        """Row t of the metric ring (each local replica's), SUMmed over the
        nodes group (uint32 wrap), and the digest of the post-tick state
        over the node shards (`telemetry.digest.tick_digest_sharded`)."""
        p, rb = self.plan, self.rb
        met, dig = rings
        tel_rings.flood_row(met, t, wire, newly_out, received_delta, self.degree_rb, lossless,
                            plain=self.plain)
        k1 = p.k - 1
        if p.delta:
            fbs = torch.tensor(fb[self.q], dtype=torch.int64, device=self.dev)
            words = k1 * (2 * p.capacity + p.hub_count * p.w) + fbs * (k1 * p.n_loc * p.w)
        elif p.sharded_ring:
            reads = (len(p.offs) + sum(1 for i in p.off_index if i < 0)
                     if p.async_k else len(p.group_delays))
            words = reads * k1 * p.n_loc * p.w
        else:
            words = k1 * p.n_loc * p.w
        mets = met if met.dim() == 3 else met[None]
        mets[:, t, 6] = words & _U32
        mets[:, t, 7] = stale
        mets[:, t, 8] = folds
        row = mets[:, t].contiguous()
        dist.all_reduce(row, group=self.nodes)
        mets[:, t] = row & _U32
        value = tel_digest.tick_digest_sharded(
            seen, received, sent, id_offset=self.row_offset, group=self.nodes,
            replicas=rb if self.campaign else None, plain=self.plain)
        if self.campaign:
            dig[:, t] = value
        else:
            dig[t] = value


def _agree(mesh, flag: bool) -> bool:
    """True when any rank of the mesh says so (telemetry must be on or
    off on every rank alike: its rows add collectives)."""
    v = torch.tensor([int(flag)], dtype=torch.int64, device=mesh.device)
    dist.all_reduce(v, group=mesh.group)
    return bool(v.item())


def _setup(graph, mesh, ell_delays, constant_delay, chunk_size, ring_mode, exchange,
           async_k, hub_rows, aux_cache, block, bucket_min_rows, churn, loss,
           connect_tick, plain, sharded_graph):
    if mesh.first_axis != SHARES_AXIS:
        raise ValueError("the sharded engine runs on a (shares, nodes) mesh; a (replicas, "
                         "nodes) mesh is batch.campaign_sharded's")
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


# --- audit specs (staticcheck/: the op audit runs these tiny cases) ---------
# The JAX package's ``_audit_spec_flood_runner``: ER(16, 0.3), a 32-share
# pass, horizon 16, two shares at node 0 on tick 0, on a mesh of every rank
# of the world along the nodes axis (a (replicas, nodes) mesh and 2 local
# replicas for the campaign forms). A rank runs the pass it would in
# `run_sharded_sim`: the tick's one host read is the mesh vector
# (`_Runner.run_pass`'s ``vec.tolist()``); a telemetry row on delta also
# stages its fallback counts (`_Runner._telemetry_row`). A call stages the
# pass's rows, liveness and ticks once (three host constants) and reads the
# summed counters back once (and each ring, telemetry on).

_SHARDED = "p2p_gossip_tpu_torch/parallel/engine_sharded.py"
_FLOOD_BODIES = tuple(f"{_SHARDED}:_Runner.{m}" for m in (
    "run_pass[loop]", "_read", "_gather", "_landed", "_rebuild", "_overlay_own", "_prefetch",
    "_flagged", "_gather_rows"))


def _audit_spec(exchange: str = "dense", telemetry: bool = False, campaign: bool = False):
    from p2p_gossip_tpu_torch.staticcheck import op_audit, specs
    from p2p_gossip_tpu_torch.staticcheck.registry import AuditSpec

    graph = specs.sharded_graph()
    mesh = op_audit.audit_mesh("replicas" if campaign else "shares")
    chunk, horizon, rb = 32, 16, (2 if campaign else 1)
    sg = stage_sharded_graph(graph, mesh)
    plan, need, hub = _plan(sg, mesh, chunk, "auto", exchange, 2,
                            8 if exchange.endswith("hub") else None, None)
    runner = _Runner(plan, mesh, sg, need, hub, None, None, 0, telemetry, False,
                     replicas=rb if campaign else 0)
    origins = np.zeros((rb, chunk), dtype=np.int32)
    gen_ticks = np.full((rb, chunk), horizon, dtype=np.int32)
    gen_ticks[:, :2] = 0
    out = ("int32", "int64") + (("int64", "int32") if telemetry else ())
    return AuditSpec(
        fn=runner.run_pass, args=(origins, gen_ticks, 0, 0, horizon, []),
        integer_only=True, bitmask_words=bitmask.num_words(chunk),
        # the summed counters, the exchange counters a replica; the rings
        out_dtypes=out, counterpart_outputs=(0, None) + ((None, None) if telemetry else ()),
        ticks=lambda result: result["ticks"], setup_reads=1 + (2 if telemetry else 0), h2d=3,
    )


from p2p_gossip_tpu_torch.staticcheck.registry import register_entry  # noqa: E402

for _tag, _kw in (("", {}), ("[telemetry]", dict(telemetry=True)),
                  ("[delta]", dict(exchange="delta")), ("[hub]", dict(exchange="hub")),
                  ("[async]", dict(exchange="async")),
                  ("[async-delta]", dict(exchange="async-delta")),
                  ("[async-hub]", dict(exchange="async-hub")),
                  ("[campaign]", dict(campaign=True)),
                  ("[campaign-delta]", dict(campaign=True, exchange="delta")),
                  ("[campaign-hub]", dict(campaign=True, exchange="hub"))):
    _tel = bool(_kw.get("telemetry"))
    register_entry(f"parallel.engine_sharded._Runner.run_pass{_tag}",
                   spec=lambda kw=_kw: _audit_spec(**kw),
                   counterpart=f"parallel.engine_sharded.flood_runner{_tag}",
                   host_reads_per_tick=2 if _tel else 1, sharded=True,
                   tick_bodies=_FLOOD_BODIES + ((f"{_SHARDED}:_Runner._telemetry_row",)
                                                if _tel else ()))
