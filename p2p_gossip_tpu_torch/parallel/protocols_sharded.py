"""The random-partner protocols on a (shares, nodes) mesh: the JAX
package's ``parallel/protocols_sharded.py`` (push-pull, pull and fanout
push as one ``shard_map`` program) as an SPMD program over
``torch.distributed``, called by every rank of the mesh.

Each rank holds its node shard's rows (ELL neighbours and per-edge delays,
``seen``, counters) for its share shard's chunk; churn intervals stay whole
on every rank, because a partner's up-check reads any node. Partner picks,
loss coins and up-checks hash GLOBAL node ids (``shard * n_loc`` + local
row), so every shard makes the single-device run's exchanges and the
counters are bitwise `models.protocols`'s. A round:

- **partner picks** (`models.partnersel`) and each pick's edge delay d;
- **the pull side** (push-pull, pull), the partner's row of round t - d:
  a local read of the replicated ring; on the sharded ring one all_gather
  of the (t - d) slice per distinct delay; under ``exchange="delta"`` /
  ``"hub"`` per-delay mirrors of those slices, advanced every round by
  `kernels.compress_deltas`, an all_gather of the (idx, val) buffers and
  `kernels.scatter_deltas` (the hub rows ride a plain all_gathered block,
  `exchange.overlay_hub`), reset from a dense all_gather after an
  overflow; under ``"async"`` on the dense transport the ``landed``
  slices, gathered with ``async_op=True`` at the end of the round before;
- **the push side** (push-pull, fanout push): `kernels.scatter_or` of the
  node's own (t - d) rows into a global-width (n_padded, W) buffer, one
  ``all_to_all_single`` over the nodes group, and `kernels.or_fold` of the
  received (k, n_loc, W) stack into this shard's rows
  (`_reduce_scatter_or`). Pull mode credits each responder instead: an
  int64 ``index_add_`` all_reduced over the nodes group;
- the generations, the counters, the ring write (all_gathered into the
  replicated ring), the coverage row (all_reduced) and, with telemetry's
  rings on, the metric row (SUMmed) and the digest (XORed) over the nodes
  group.

What differs from the JAX design:

- The round is a method of `_Runner`, which holds the pass's state, not a
  compiled closure; its branches are Python ``if``s on the plan, which
  every rank shares.
- JAX chooses between the sparse mirror advance and its dense reset with
  a ``lax.cond`` on the slot's psum'd overflow flag. Here that flag and
  the round's used entries ride ONE int64 vector all_reduced over the
  nodes group and read on the host once a round (delta and hub only; the
  other exchanges read nothing on the host a round), so every rank of the
  group takes the same branch. A protocol runs every round of the
  horizon: there is no stop test.
- ``sent`` is one int64 a node (JAX: a uint32 (lo, hi) pair), SUMmed over
  the mesh on the device at a pass's end; ``received`` stays int32 and
  wraps as JAX's does.
- Campaign mode (JAX's ``replica_axis``, `batch.campaign_sharded`): a
  rank runs its replica shard's local replicas stacked along the rows,
  every launch and collective covering the batch (`_Runner`).

Counters, coverage rows, ``stats.extra['ring']`` / ``['exchange']``,
checkpoints (JAX's fingerprint: either package resumes the other's) and
telemetry events equal the JAX package's for every mesh shape, ring mode
and exchange.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from p2p_gossip_tpu_torch.engine.sync import MIN_CHUNK_SHARES
from p2p_gossip_tpu_torch.models import churn as churn_mod
from p2p_gossip_tpu_torch.models.churn import effective_generated
from p2p_gossip_tpu_torch.models.generation import Schedule
from p2p_gossip_tpu_torch.models.linkloss import drop_mask_torch
from p2p_gossip_tpu_torch.models.partnersel import pick_from_key, pick_key
from p2p_gossip_tpu_torch.models.protocols import _check_pull_credit_bound
from p2p_gossip_tpu_torch.models.topology import Graph
from p2p_gossip_tpu_torch.ops import bitmask, kernels
from p2p_gossip_tpu_torch.parallel import async_ticks
from p2p_gossip_tpu_torch.parallel import exchange as exch
from p2p_gossip_tpu_torch.parallel.engine_sharded import (
    _achieved_exchange_report,
    _agree,
    _ReadOnlyCheckpointer,
    gather_first,
    replica_major,
    resolve_ring_mode,
)
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

PROTOCOLS = ("pushpull", "pull", "pushk")
_U32 = 0xFFFFFFFF


def _reduce_scatter_or(pushed: torch.Tensor, group, out: torch.Tensor,
                       plain: bool = False) -> torch.Tensor:
    """(n_padded, W) per-rank push buffers -> the (n_loc, W) OR of every
    rank's pushes into THIS rank's rows, written into ``out``:
    ``all_to_all_single`` over the nodes ``group`` sends destination shard
    j's slice to its owner, and `kernels.or_fold` folds the received (k,
    n_loc, W) stack (NCCL and gloo have no OR reduction)."""
    n_loc, w = out.shape
    recv = torch.empty_like(pushed)
    dist.all_to_all_single(recv, pushed, group=group)
    return kernels.or_fold(recv.view(-1, n_loc, w), out=out, plain=plain)


def _resolve_partnered_exchange(
    exchange: str,
    protocol: str,
    ring_mode: str,
    ell_delays: np.ndarray,
    ring: int,
    n_padded: int,
    n_node_shards: int,
    w: int,
    degree: np.ndarray,
    k_async: int = 0,
    stale_values: tuple = (),
    stale_amounts: tuple = (),
    hub_rows: int | None = None,
) -> tuple:
    """The JAX package's exchange and ring resolution for the partnered
    protocols: pick the ring layout, resolve "auto", plan the delta
    capacity (and under ``exchange="hub"`` the degree split,
    `exchange.plan_partnered_hub_split`), and assemble the
    ``stats.extra['exchange']`` skeleton, key for key.

    Returns ``(ring_mode, ring_bytes, delay_values, exchange, capacity,
    hub_plan, delta_on, exchange_extra, async_staleness)``; ``hub_plan``
    is None or the split's dict when it keeps hub rows."""
    if exchange not in ("dense", "delta", "auto", "hub"):
        raise ValueError(f"unknown exchange mode {exchange!r}")
    anti = protocol in ("pushpull", "pull")
    if exchange in ("delta", "hub") and anti:
        # The sparse paths compress the sharded ring's read exchange.
        ring_mode = "sharded"
    distinct = tuple(int(v) for v in np.unique(ell_delays))
    if ring_mode == "auto" and protocol == "pushk":
        # Fanout push reads only its own rows' history: the sharded ring
        # drops the exchange all_gather outright.
        ring_mode = "sharded"
    ring_mode, ring_bytes = resolve_ring_mode(
        ring_mode, distinct[0] if len(distinct) == 1 else None,
        ring, n_padded, n_node_shards, w,
    )
    delay_values = distinct if ring_mode == "sharded" and anti else None
    if exchange == "auto":
        exchange = "delta" if anti and ring_mode == "sharded" and n_node_shards > 1 else "dense"
    delta_on = exchange in ("delta", "hub") and anti and ring_mode == "sharded"
    n_loc = n_padded // n_node_shards
    hub_plan = hub_report = None
    if exchange == "hub" and delta_on:
        hplan = exch.plan_partnered_hub_split(
            degree, n_node_shards, n_loc, w, delay_splits=len(delay_values),
            hub_rows=hub_rows,
        )
        capacity = hplan["capacity"]
        hub_report = hplan["report"]
        if hplan["hub_count"] > 0:
            hub_plan = hplan  # hub_count == 0 is plain delta on the full cut
    elif delta_on:
        # Every local row may change: global-random partners leave no
        # static cut to restrict the anti-entropy delta.
        capacity = exch.delta_capacity(n_loc, n_loc, w, len(delay_values))
    else:
        capacity = 0
    dense_kind = ("dense" if anti else "none") if ring_mode == "sharded" else "replicated"
    exchange_extra = {
        "mode": ("hub" if hub_plan else "delta") if delta_on else dense_kind,
        "capacity": capacity,
        "modeled_dense_words_per_tick": exch.modeled_exchange_words_per_tick(
            dense_kind, n_shards=n_node_shards, n_loc=n_loc, w=w,
            delay_splits=len(delay_values) if delay_values else 1,
        ),
    }
    if delta_on:
        # A single destination: the delta rides an all_gather.
        exchange_extra["aggregated"] = exch.choose_aggregate(1, capacity)
        exchange_extra["modeled_delta_words_per_tick"] = exch.modeled_exchange_words_per_tick(
            "delta", n_shards=n_node_shards, n_loc=n_loc, w=w, capacity=capacity)
    if hub_report is not None:
        exchange_extra.update({key: hub_report[key] for key in (
            "hub_count", "hub_rows_forced", "crossover_h", "modeled_hub_words_per_tick",
            "modeled_delta_words_per_tick")})
    if k_async:
        exchange_extra.update(async_ticks.modeled_overlap_report(
            ("hub" if hub_plan else "delta") if delta_on else "dense",
            delay_values, k_async, n_node_shards, n_loc, w, capacity,
            hub_count=hub_plan["hub_count"] if hub_plan else 0,
        ))
        # group_offsets sees only clamped delays (amounts all 0 there);
        # the real added lateness is the pre-clamp bookkeeping.
        exchange_extra["staleness_amounts"] = list(stale_amounts)
    amounts_by_value = dict(zip(stale_values, stale_amounts))
    async_staleness = (tuple(amounts_by_value.get(v, 0) for v in delay_values)
                       if k_async else ())
    return (ring_mode, ring_bytes, delay_values, exchange, capacity, hub_plan, delta_on,
            exchange_extra, async_staleness)


@dataclasses.dataclass
class _Plan:
    """Everything the ranks agree on before the first collective."""

    protocol: str
    picks: int              # partners a node picks a round
    n_padded: int
    k: int                  # node shards
    s: int                  # share shards
    chunk: int              # shares a share shard carries in a pass
    w: int
    ring: int
    ring_mode: str
    delay_values: tuple | None  # the sharded anti-entropy ring's read groups
    delta: bool
    capacity: int
    hub_count: int
    async_k: int
    staleness: tuple        # pre-clamp lateness, one amount a delay value
    transport: str = "dense"  # the resolved exchange argument (the fingerprints')

    @property
    def n_loc(self) -> int:
        return self.n_padded // self.k

    @property
    def anti(self) -> bool:
        return self.protocol != "pushk"

    @property
    def sharded_ring(self) -> bool:
        return self.ring_mode == "sharded"

    @property
    def landed(self) -> bool:
        """The async landed slices replace the read-time gathers (the
        delta mirrors already are such a double buffer)."""
        return self.async_k > 0 and not self.delta


class _Runner:
    """One rank's staged operands and its pass loop.

    ``replicas`` > 0 is campaign mode (the JAX package's ``replica_axis`` /
    ``local_replicas``): the mesh's first axis carries replica shards and
    this rank runs ``replicas`` rb local replicas of its node shard at
    once, stacked along the rows (``seen`` (rb*n_loc, W), the ring (ring,
    rb*rows, W), replica-major), each with its own partner-pick seed, loss
    seed and churn intervals (`set_replicas`, once a batch). Every launch
    covers the local batch; each replica keeps its own delta flags and
    exchange counters. 0 is the one-run protocols (rb = 1)."""

    def __init__(self, plan: _Plan, mesh, ell_idx, delays, degree, hub_plan, churn, loss,
                 seed: int, telemetry_on: bool, plain: bool, replicas: int = 0):
        p = self.plan = plan
        self.mesh, self.plain, self.tel = mesh, plain, telemetry_on
        self.dev = dev = mesh.device
        self.q, shard = mesh.coordinate
        self.row_offset = lo = shard * p.n_loc
        mine = slice(lo, lo + p.n_loc)
        self.nodes, self.first = mesh.nodes_group, mesh.first_group
        self.campaign = replicas > 0
        self.rb = rb = max(1, replicas)

        def on_dev(a, dtype):
            return torch.as_tensor(np.ascontiguousarray(a, dtype=dtype), device=dev)

        self.ell_idx = on_dev(ell_idx[mine], np.int32)      # global partner ids
        self.ell_delay = on_dev(delays[mine], np.int32)
        self.degree = on_dev(degree[mine], np.int64)
        self.live = self.degree > 0                          # padding rows never exchange
        self.rows = torch.arange(p.n_loc, dtype=torch.int64, device=dev)
        self.node_ids = self.rows + lo
        self.churn = None if churn is None else (
            on_dev(pad_to_multiple(churn.down_start, p.k), np.int32),
            on_dev(pad_to_multiple(churn.down_end, p.k), np.int32))
        self.loss = loss.static_cfg if loss is not None and loss.threshold > 0 else None
        self.key = None
        if not self.campaign:
            self._set_key(seed)
        self.need = self.hub = None
        if p.delta:
            need = (np.ones((p.n_padded, 1), dtype=bool) if hub_plan is None
                    else hub_plan["need_tail"])
            self.need = on_dev(need[mine], bool)
        if hub_plan is not None:
            self.hub = (on_dev(hub_plan["hub_local"][shard], np.int64),
                        on_dev(hub_plan["hub_global"].reshape(-1), np.int64))
        staged = [self.ell_idx, self.ell_delay, self.degree, self.live, self.rows,
                  self.node_ids, self.key, *(self.churn or ()), *(self.hub or ())]
        if self.need is not None:
            staged.append(self.need)
        self.stacked = None
        if rb > 1:
            # The local replicas' stacked rows: degree, liveness, global node
            # ids, and each row's replica offset into replica-major rows.
            self.stacked = dict(
                degree=self.degree.repeat(rb), live=self.live.repeat(rb),
                node_ids=self.node_ids.repeat(rb),
                base=torch.arange(rb, dtype=torch.int64, device=dev).repeat_interleave(
                    p.n_loc) * p.n_padded,
                rows=torch.arange(rb * p.n_loc, dtype=torch.int64, device=dev))
            staged += list(self.stacked.values())
        self.staged_bytes = sum(t.numel() * t.element_size() for t in staged if t is not None)
        if self.campaign:
            # Set per batch (`set_replicas`): the (rb*n_loc, picks) int64 keys
            # and the loss coins' row seeds.
            self.staged_bytes += rb * p.n_loc * (p.picks + 1) * 8
        self.batch_bytes = 0

    def _set_key(self, seeds):
        """The partner-pick keys, (rb*n_loc, picks): one seed for the run,
        or a (rb,) int64 tensor of the local replicas' seeds (uint32)."""
        p = self.plan
        picks = torch.arange(p.picks, dtype=torch.int64, device=self.dev)
        ids = self.node_ids.repeat(self.rb) if self.rb > 1 else self.node_ids
        if isinstance(seeds, torch.Tensor):
            seeds = seeds.repeat_interleave(p.n_loc)[:, None]
        self.key = pick_key(ids[:, None], picks[None, :], seeds)

    def set_replicas(self, seeds, churn, loss_seeds):
        """A campaign batch's local replicas: their pick ``seeds`` and
        ``loss_seeds`` ((rb,) uint32 numpy, the latter None without loss)
        and ``churn`` intervals (rb, n_padded, K) int32 numpy, or None."""
        p, dev = self.plan, self.dev
        self._set_key(torch.as_tensor(np.asarray(seeds, dtype=np.int64), device=dev))
        self.churn = None
        if churn is not None:
            self.churn = tuple(
                torch.as_tensor(np.ascontiguousarray(c.reshape(-1, c.shape[-1]), dtype=np.int32),
                                device=dev) for c in churn)
        if self.loss is not None:
            ls = torch.as_tensor(np.asarray(loss_seeds, dtype=np.int64), device=dev)
            self.loss = (self.loss[0], ls.repeat_interleave(p.n_loc))
        self.batch_bytes = max(self.batch_bytes, sum(
            t.numel() * t.element_size() for t in (*(self.churn or ()),)))

    def resident_bytes(self, horizon: int, record_coverage: bool = False) -> int:
        """Modeled peak device memory of this rank over a call (telemetry
        off), counted from the code: the staged operands (``staged_bytes``,
        a campaign batch's churn rows) and the pass state — ``seen``, the
        ring (this shard's rows, or all rows when replicated), the
        counters, the delta state (per-delay mirrors, the received (idx,
        val) rings, the hub ring, the rebuild canvas) or the async landed
        slices, the coverage rows, each rb times in campaign mode — plus
        the largest of the round's transient peaks, each the (rb*n_loc, W)
        or (rb*n_padded, W) tensors alive at one point of the round:

        - the read: the own (t - d) rows, and the pulled rows as they are
          assembled (on the sharded ring the old and the new pulled rows,
          one slice's selected rows and, on the dense transport, that
          gathered slice, with its replica-major copy when rb > 1 on
          several node shards);
        - the push: the own and pulled rows, the global-width push buffer,
          the received (k, rb*n_loc, W) stack and the folded rows;
        - the update: the arrivals, the generation bits and ``~seen``;
        - the delta exchange: the new rows, the changed words and ``~`` of
          the previous slot, then the two (rb, capacity) buffers;
        - the async prefetch: the new rows and the next round's landed
          slices in flight beside this round's."""
        p, rb = self.plan, self.rb
        row = p.w * 4
        loc, glob = rb * p.n_loc * row, rb * p.n_padded * row
        groups = len(p.delay_values) if p.delay_values else 1
        rows = p.n_loc if p.sharded_ring else p.n_padded
        state = rb * p.ring * rows * row + loc + rb * p.n_loc * (4 + 8)
        if p.delta:
            state += (groups + 1) * glob + rb * 2 * p.ring * p.k * p.capacity * 4
            state += rb * p.ring * p.k * p.hub_count * row
        elif p.landed:
            state += groups * glob
        if record_coverage:
            state += rb * (1 + p.s) * horizon * p.chunk * 4
        transpose = glob if rb > 1 and p.k > 1 else 0
        own = 0 if p.protocol == "pull" else p.picks * loc
        pulled = loc if p.anti else 0
        read = pulled
        if p.anti and p.sharded_ring:
            read = 3 * loc + (0 if p.delta or p.landed else glob + transpose)
        peaks = [own + read, 3 * loc + (rb * p.n_padded * 8 if p.protocol == "pull" else 0)]
        if p.protocol != "pull":
            peaks.append(own + pulled + 2 * glob + loc)
        if p.delta:
            peaks.append(2 * loc + max(loc, 2 * rb * p.capacity * 4))
        if p.landed:
            peaks.append(loc + groups * glob + transpose)
        if not p.sharded_ring and p.k > 1:
            peaks.append(loc + 2 * glob if rb > 1 else loc)
        return self.staged_bytes + self.batch_bytes + state + max(peaks)

    # -- collectives ----------------------------------------------------------

    def _gather_rows(self, local: torch.Tensor, async_op: bool = False):
        """all_gather of a (rb*n_loc, W) slice over the nodes group into a
        fresh (rb*n_padded, W) replica-major tensor; async, the rank-major
        buffer and the work handle (`replica_major` after the wait)."""
        out = torch.empty((self.plan.k * local.shape[0], self.plan.w), dtype=local.dtype,
                          device=self.dev)
        work = all_gather_rows(out, local, self.nodes, async_op=async_op)
        return (out, work) if async_op else replica_major(out, self.plan.k, self.rb)

    # -- the round's parts ------------------------------------------------------

    def _pull(self, st, t: int, partners, delay, slot):
        """The partners' (t - d) rows, (rb*n_loc, W), a fresh tensor;
        ``partners`` are replica-major global rows. Under async with
        telemetry on, also adds each replica's late views' staleness (a
        remote row holding any bit) into ``st['stale']``."""
        p, rb = self.plan, self.rb
        if not p.sharded_ring:
            return st["flat"][slot * (rb * p.n_padded) + partners]
        remote = torch.zeros((rb * p.n_loc, p.w), dtype=torch.int32, device=self.dev)
        lo, hi = self.row_offset, self.row_offset + p.n_loc
        for j, dv in enumerate(p.delay_values):
            if p.delta:
                view = st["mirrors"][j]
            elif p.landed:
                view, work = st["landed"][j]
                if work is not None:
                    work.wait()
                    view = replica_major(view, p.k, rb)
                    st["landed"][j] = (view, None)
            else:
                view = self._gather_rows(st["hist"][(t - dv) % p.ring])
            if self.tel and p.async_k and p.staleness[j] > 0:
                v = view.view(rb, p.n_padded, p.w)
                pending = ((v[:, :lo] != 0).flatten(1).any(1)
                           | (v[:, hi:] != 0).flatten(1).any(1)).to(torch.int64)
                st["stale"] = st["stale"] + p.staleness[j] * pending
                st["folds"] = st["folds"] + pending
            remote = torch.where((delay == dv)[:, None], view[partners], remote)
            del view  # before the next slice's gather
        return remote

    def _push(self, dst, src_rows, ok):
        """The pushes of ``src_rows`` (M, W) to replica-major global rows
        ``dst`` (M,) where ``ok``: one `kernels.scatter_or` into the
        (rb*n_padded, W) push buffer laid out destination-shard-major
        ((k, rb, n_loc) rows), then `_reduce_scatter_or` into this shard's
        (rb*n_loc, W)."""
        p, rb = self.plan, self.rb
        if rb > 1:
            b, g = dst // p.n_padded, dst % p.n_padded
            dst = (g // p.n_loc) * (rb * p.n_loc) + b * p.n_loc + g % p.n_loc
        offsets, entries = kernels.scatter_or_plan(dst, None, ok, rb * p.n_padded,
                                                   src_rows.shape[0])
        pushed = torch.empty((rb * p.n_padded, p.w), dtype=torch.int32, device=self.dev)
        kernels.scatter_or(src_rows, offsets, entries, out=pushed, plain=self.plain)
        out = torch.empty((rb * p.n_loc, p.w), dtype=torch.int32, device=self.dev)
        return _reduce_scatter_or(pushed, self.nodes, out, self.plain)

    def _advance(self, st, t: int, d_words):
        """The delta exchange of round t's changed words ``d_words`` and the
        mirrors' advance to the slices round t + 1 reads (u = t + 1 - d):
        a slot flagged in any local replica resets from a dense all_gather
        (the ring slot IS the cumulative slice, so the reset equals every
        replica's advance), any other ORs in its rebuilt deltas (an
        unwritten slot holds -1 indices: a no-op, as the all-zero
        pre-history). Returns each local replica's dense fallback reads
        (its own flags), a list."""
        p, plain, rb = self.plan, self.plain, self.rb
        slot_w = t % p.ring
        cidx, cval, counts = kernels.compress_deltas(d_words, self.need, p.capacity,
                                                     replicas=rb, plain=plain)
        for ring_, buf in ((st["didx"], cidx), (st["dval"], cval)):
            all_gather_rows(ring_[slot_w].view(-1, p.capacity), buf.view(rb, p.capacity),
                            self.nodes)
        if self.hub is not None:
            block = d_words.view(rb, p.n_loc, p.w)[:, self.hub[0]].contiguous()
            all_gather_rows(st["hub"][slot_w].view(-1, p.w), block.view(-1, p.w), self.nodes)
        vec = torch.cat([(counts > p.capacity).any(dim=1).to(torch.int64),
                         counts.clamp(max=p.capacity).sum(dim=1, dtype=torch.int64)])
        dist.all_reduce(vec, group=self.nodes)
        host = vec.tolist()  # the round's one host read, uniform over the group
        flags = [v > 0 for v in host[:rb]]
        st["flags"][slot_w] = flags
        fallbacks = [0] * rb
        for j, dv in enumerate(p.delay_values):
            slot_u = (t + 1 - dv) % p.ring
            if any(st["flags"][slot_u]):
                st["mirrors"][j].copy_(self._gather_rows(st["hist"][slot_u]))
                for b in range(rb):
                    fallbacks[b] += int(st["flags"][slot_u][b])
                continue
            canvas = kernels.scatter_deltas(st["didx"][slot_u], st["dval"][slot_u], p.n_loc,
                                            p.w, p.n_padded, out=st["canvas"], replicas=rb,
                                            plain=plain)
            if self.hub is not None:
                exch.overlay_hub(canvas, self.hub[1], st["hub"][slot_u], replicas=rb)
            st["mirrors"][j] |= canvas.view(rb * p.n_padded, p.w)
        for b in range(rb):
            st["counters"][b][0] += host[rb + b]
            st["counters"][b][1] += int(flags[b])
            st["counters"][b][2] += fallbacks[b]
        return fallbacks

    # -- one pass ----------------------------------------------------------------

    def run_pass(self, origins, gen_ticks, horizon: int, record_coverage: bool) -> dict:
        """``horizon`` rounds of one pass (this rank's share shard's
        ``origins``/``gen_ticks``, (chunk,) int32 numpy; in campaign mode
        its local replicas' (rb, chunk)). Returns host values, identical on
        every rank: the global counters, the exchange counters (and
        ``exchange_per``, one (used, overflow rounds, fallbacks, rounds) row
        a replica of the first axis) and, when recorded, every first-axis
        shard's coverage rows and rings."""
        p, dev, rb = self.plan, self.dev, self.rb
        n_loc, w, ring = p.n_loc, p.w, p.ring
        rows = n_loc if p.sharded_ring else p.n_padded
        hist = torch.zeros((ring, rb * rows, w), dtype=torch.int32, device=dev)
        origins = np.asarray(origins).reshape(rb, -1)
        gen_ticks = np.asarray(gen_ticks).reshape(rb, -1)
        local = origins.astype(np.int64) - self.row_offset
        in_shard = (local >= 0) & (local < n_loc)
        stacked = np.where(in_shard, local, 0) + np.arange(rb)[:, None] * n_loc
        base = np.arange(rb)[:, None] * p.n_padded
        st = {
            "hist": hist, "flat": hist.view(ring * rb * rows, w),
            "counters": [[0, 0, 0] for _ in range(rb)],
            "stale": 0, "folds": 0,
            "seen": torch.zeros((rb * n_loc, w), dtype=torch.int32, device=dev),
            "received": torch.zeros((rb * n_loc,), dtype=torch.int32, device=dev),
            "sent": torch.zeros((rb * n_loc,), dtype=torch.int64, device=dev),
            "ticks": torch.arange(horizon, dtype=torch.int64, device=dev),
            # The generations: this shard's rounds with one, and each share's
            # stacked local row, replica-major origin, liveness and tick.
            "gen_rounds": set(np.unique(gen_ticks[in_shard]).tolist()),
            "gen": tuple(torch.as_tensor(np.ascontiguousarray(a).reshape(-1), device=dev)
                         for a in (stacked, origins.astype(np.int64) + base, in_shard,
                                   gen_ticks)),
            "slots": torch.arange(p.chunk, dtype=torch.int64, device=dev).repeat(rb),
            "cov": (torch.zeros((rb, horizon, p.chunk), dtype=torch.int32, device=dev)
                    if record_coverage else None),
            "rings": (tel_rings.chunk_rings(horizon, dev, rb if self.campaign else None)
                      if self.tel else None),
        }
        groups = len(p.delay_values) if p.delay_values else 1
        if p.delta:
            st["mirrors"] = torch.zeros((groups, rb * p.n_padded, w), dtype=torch.int32,
                                        device=dev)
            st["didx"] = torch.full((ring, p.k, rb, p.capacity), -1, dtype=torch.int32,
                                    device=dev)
            st["dval"] = torch.zeros((ring, p.k, rb, p.capacity), dtype=torch.int32,
                                     device=dev)
            st["canvas"] = torch.empty((rb, p.n_padded, w), dtype=torch.int32, device=dev)
            st["flags"] = [[False] * rb for _ in range(ring)]
            if self.hub is not None:
                st["hub"] = torch.zeros((ring, p.k, rb, p.hub_count, w), dtype=torch.int32,
                                        device=dev)
        if p.landed:  # round 0 reads pre-history: zero slices
            st["landed"] = [(torch.zeros((rb * p.n_padded, w), dtype=torch.int32, device=dev),
                             None) for _ in range(groups)]
        for t in range(horizon):
            self._round(st, t)  # its temporaries go when it returns
        for _, work in st.get("landed", ()):
            if work is not None:  # the prefetch past the horizon: done before its buffer goes
                work.wait()
        return self._finish(st, horizon)

    def _round(self, st, t: int) -> None:
        """Round t of a pass: picks, the pull and the push, the counters,
        the generations, the ring write, the exchange and the rows."""
        p, dev, plain, rb = self.plan, self.dev, self.plain, self.rb
        n_loc, w, ring = p.n_loc, p.w, p.ring
        anti, lo = p.anti, self.row_offset
        seen, hist = st["seen"], st["hist"]
        tt = st["ticks"][t]  # a device scalar: no host copy a round
        sk = self.stacked
        degree, node_ids, live = ((self.degree, self.node_ids, self.live) if sk is None
                                  else (sk["degree"], sk["node_ids"], sk["live"]))
        if anti:
            kidx = pick_from_key(self.key[:, 0], tt, degree)[:, None]
        else:
            kidx = pick_from_key(self.key, tt, degree[:, None])
        if sk is None:
            gpart = self.ell_idx.gather(1, kidx).to(torch.int64)  # global partner ids
            delay = self.ell_delay.gather(1, kidx)
        else:  # replica b's row r reads ELL row r
            at = (sk["rows"] % n_loc)[:, None] * self.ell_idx.shape[1] + kidx
            gpart = self.ell_idx.view(-1)[at].to(torch.int64)
            delay = self.ell_delay.view(-1)[at]
        if anti:
            gpart, delay = gpart[:, 0], delay[:, 0]
        base = None if sk is None else (sk["base"] if anti else sk["base"][:, None])

        def stacked_rows(ids):  # global ids -> replica-major rows
            return ids if base is None else ids + base

        partners = stacked_rows(gpart)
        slot = torch.remainder(tt - delay, ring)
        my_old = None  # the own (t - d) rows the round pushes
        if p.protocol != "pull":
            rows = n_loc if p.sharded_ring else p.n_padded
            if p.sharded_ring:
                own = self.rows if sk is None else sk["rows"]
            else:
                own = node_ids if sk is None else node_ids + sk["base"]
            my_old = st["flat"][slot * (rb * rows) + (own if anti else own[:, None])]
        remote = self._pull(st, t, partners, delay, slot) if anti else None

        self_ids = node_ids if anti else node_ids[:, None]
        attempted = (live if anti else live[:, None]).expand(gpart.shape)
        up = None if self.churn is None else churn_mod.up_mask(*self.churn, t)
        if up is not None:
            attempted = attempted & up[stacked_rows(self_ids)] & up[partners]
        pull_ok = push_ok = attempted
        if self.loss is not None:
            thr, lseed = self.loss
            if isinstance(lseed, torch.Tensor) and not anti:
                lseed = lseed[:, None]
            push_ok = attempted & ~drop_mask_torch(self_ids, gpart, tt, thr, lseed)
            if anti:
                pull_ok = attempted & ~drop_mask_torch(gpart, node_ids, tt, thr, lseed)
        dropped = 0
        rep = rb if self.campaign else None
        if anti:
            pc_remote = bitmask.popcount_rows(remote, plain=plain)  # before the coin
            remote.masked_fill_(~pull_ok[:, None], 0)
            if self.tel and self.loss is not None:
                dropped = tel_rings.u32sum(torch.where(attempted & ~pull_ok, pc_remote, 0), rep)
            if p.protocol == "pull":
                # Each attempted pull credits its (possibly remote) responder
                # with the row it served, lost or not.
                credit = torch.zeros((rb * p.n_padded,), dtype=torch.int64, device=dev)
                credit.index_add_(0, partners,
                                  torch.where(attempted, pc_remote, 0).to(torch.int64))
                dist.all_reduce(credit, group=self.nodes)
                sent_add = credit.view(rb, p.n_padded)[:, lo:lo + n_loc].reshape(-1)
                arrivals = remote
            else:
                arrivals = self._push(partners, my_old, push_ok)
                arrivals |= remote
                my_cnt = bitmask.popcount_rows(my_old, plain=plain)
                sent_add = torch.where(attempted, my_cnt, 0)
                if self.tel and self.loss is not None:
                    pushed_lost = tel_rings.u32sum(torch.where(attempted & ~push_ok, my_cnt, 0),
                                                   rep)
                    dropped = (dropped + pushed_lost) & _U32  # a uint32 add, as in JAX
            del remote
        else:
            src_rows = my_old.reshape(-1, w)
            arrivals = self._push(partners.reshape(-1), src_rows, push_ok.reshape(-1))
            pick_cnt = bitmask.popcount_rows(src_rows, plain=plain).view(partners.shape)
            # JAX sums a node's picks in int32 and adds the sum as uint32.
            sent_add = torch.where(attempted, pick_cnt, 0).sum(dim=1, dtype=torch.int64) & _U32
            if self.tel and self.loss is not None:
                dropped = tel_rings.u32sum(torch.where(attempted & ~push_ok, pick_cnt, 0), rep)
        del my_old
        st["sent"] += sent_add

        gen_bits = None
        if t in st["gen_rounds"]:
            gen_rows, gen_origins, gen_live, gen_ticks = st["gen"]
            gen_active = (gen_ticks == t) & gen_live
            if up is not None:
                gen_active &= up[gen_origins]
            gen_bits = bitmask.slot_scatter(rb * n_loc, w, gen_rows, st["slots"], gen_active)
        gathered = tel_rings.total_bits(arrivals, rep, plain=plain) if self.tel else None
        newly = arrivals.bitwise_and_(~seen)  # incoming (anti) / newly (fanout push)
        newly_cnt = bitmask.popcount_rows(newly, plain=plain)
        st["received"] += newly_cnt
        newbits = None
        if self.tel:
            newbits = newly if gen_bits is None else newly | (gen_bits & ~seen)
        if gen_bits is not None:
            newly |= gen_bits
            del gen_bits
        seen |= newly
        exchange = seen if anti else newly  # the ring holds seen, or the frontier

        slot_w = t % ring
        fallbacks = [0] * rb
        if p.delta:
            # This round's change against the previous slot, read before the
            # write (ring >= 2 slots).
            d_words = exchange & ~hist[(t - 1) % ring]
        if p.sharded_ring:
            hist[slot_w].copy_(exchange)
        elif rb == 1:
            all_gather_rows(hist[slot_w], exchange, self.nodes)
        else:
            hist[slot_w].copy_(self._gather_rows(exchange))
        if p.delta:
            fallbacks = self._advance(st, t, d_words)
        if p.landed:
            # Round t + 1's slices, issued now from the written ring (slot
            # t + 1 - d is final for every d >= 1).
            st["landed"] = [self._gather_rows(hist[(t + 1 - dv) % ring], async_op=True)
                            for dv in p.delay_values]
        if st["cov"] is not None:
            cov = bitmask.coverage_per_slot(seen.view(rb, n_loc, w), p.chunk, plain=plain)
            dist.all_reduce(cov, group=self.nodes)
            st["cov"][:, t] = cov
        if self.tel:
            self._telemetry_row(st, t, newbits, newly_cnt, gathered, sent_add, dropped,
                                fallbacks)
            st["stale"] = st["folds"] = 0

    def _finish(self, st, horizon: int) -> dict:
        """The pass's counters SUMmed over the mesh (own rows into a zero
        int64 canvas: disjoint over nodes; added over share shards, or each
        replica shard at its own place), the exchange counters, and every
        first-axis shard's coverage rows and rings."""
        p, dev, rb = self.plan, self.dev, self.rb
        places = p.s if self.campaign else 1
        counters = torch.zeros((places, rb, 2, p.n_padded), dtype=torch.int64, device=dev)
        own = slice(self.row_offset, self.row_offset + p.n_loc)
        here = counters[self.q if self.campaign else 0]
        here[:, 0, own] = st["received"].view(rb, p.n_loc)  # int32, as JAX's host sum
        here[:, 1, own] = st["sent"].view(rb, p.n_loc)
        dist.all_reduce(counters, group=self.mesh.group)
        rounds = horizon if p.delta else 0
        per = torch.zeros((p.s, rb, 4), dtype=torch.int64, device=dev)
        per[self.q] = torch.tensor([c + [rounds] for c in st["counters"]], dtype=torch.int64,
                                   device=dev)
        dist.all_reduce(per, group=self.first)
        per = per.view(p.s * rb, 4).cpu().numpy()
        counters = counters.view(places * rb, 2, p.n_padded).cpu().numpy()
        out = {"counters": counters if self.campaign else counters[0],
               "exchange": tuple(int(v) for v in per.sum(axis=0)), "exchange_per": per}
        if st["cov"] is not None:
            cov = gather_first(st["cov"], p.s, self.first)
            out["coverage"] = cov.reshape((-1,) + cov.shape[2:]) if self.campaign else cov[:, 0]
        if st["rings"] is not None:
            out["rings"] = tuple(gather_first(r, p.s, self.first) for r in st["rings"])
            if self.campaign:
                out["rings"] = tuple(r.reshape((-1,) + r.shape[2:]) for r in out["rings"])
        return out

    def _telemetry_row(self, st, t, newbits, newly_cnt, gathered, sent_add, dropped,
                       fallbacks):
        """Row t of the metric ring (each local replica's), SUMmed over the
        nodes group (uint32 wrap), and the digest of the post-round state
        XORed over it (the JAX package's sharded protocol rows, column for
        column)."""
        p, rb = self.plan, self.rb
        rep = rb if self.campaign else None
        met, dig = st["rings"]
        pc_new = bitmask.popcount_rows(newbits, plain=self.plain)
        tel_rings.row(
            met, t,
            frontier_bits=tel_rings.u32sum(pc_new, rep),
            frontier_nodes=tel_rings.u32sum(pc_new > 0, rep),
            newly_infected=tel_rings.u32sum(newly_cnt, rep),
            msgs_gathered=gathered,
            or_work=tel_rings.u32sum(sent_add, rep),
            loss_dropped=dropped,
        )
        k1 = p.k - 1
        if p.delta:
            fbs = torch.tensor(fallbacks, dtype=torch.int64, device=self.dev)
            words = k1 * (2 * p.capacity + p.hub_count * p.w) + fbs * (k1 * p.n_loc * p.w)
        elif p.sharded_ring:
            words = (len(p.delay_values) if p.anti else 0) * k1 * p.n_loc * p.w
        else:
            words = k1 * p.n_loc * p.w
        mets = met if met.dim() == 3 else met[None]
        mets[:, t, 6] = words & _U32
        mets[:, t, 7] = st["stale"]
        mets[:, t, 8] = st["folds"]
        row = mets[:, t].contiguous()
        dist.all_reduce(row, group=self.nodes)
        mets[:, t] = row & _U32
        sent_lo, sent_hi = tel_digest.split_u64(st["sent"])
        value = tel_digest.tick_digest_sharded(
            st["seen"], st["received"], sent_lo, sent_hi=sent_hi, id_offset=self.row_offset,
            group=self.nodes, replicas=rep, plain=self.plain)
        if self.campaign:
            dig[:, t] = value
        else:
            dig[t] = value


def stage_partnered(graph: Graph, mesh, protocol: str, fanout: int, ell_delays,
                    constant_delay: int, chunk: int, ring_mode: str, exchange: str,
                    async_k: int, hub_rows: int | None):
    """The host staging and plan of a sharded protocol run (or campaign)
    on ``mesh`` with a ``chunk``-share pass (the JAX package's staging,
    shared by `run_sharded_partnered_sim` and the sharded campaigns):
    partner picks index the real per-edge delays, padding rows fill with
    delay 1 (degree 0: they never exchange); async clamps the delays
    first. Returns ``(plan, (ell_idx, delays, degree, hub_plan),
    ring_extra, exchange_extra)``."""
    if protocol == "pushk" and fanout < 1:
        raise ValueError(f"fanout must be >= 1, got {fanout}")
    transport, k_async = async_ticks.parse_exchange(exchange, async_k)
    if k_async:
        if protocol == "pushk":
            raise ValueError(
                "async exchange needs an anti-entropy protocol (pushpull/pull): fanout "
                "push exchanges same-round digests — there is nothing to overlap"
            )
        ring_mode = "sharded"
    if mesh.coordinate is None:
        raise ValueError("this rank is not in the mesh")
    k, s = mesh.n_node_shards, mesh.n_share_shards
    w = bitmask.num_words(chunk)
    ell_idx, _ = graph.ell()
    if ell_delays is None:
        ell_delays = np.full(ell_idx.shape, constant_delay, dtype=np.int32)
    ring = (int(ell_delays.max()) if ell_delays.size else 1) + 1
    ell_idx = pad_to_multiple(ell_idx, k)
    delays = pad_to_multiple(ell_delays, k, fill=1)
    degree = pad_to_multiple(graph.degree.astype(np.int32), k)
    n_padded = degree.shape[0]
    stale_values = stale_amounts = ()
    if k_async:
        # Before everything downstream — the distinct delays, the ring, the
        # fingerprint — so the synchronous run on the clamped delays is the
        # bitwise reference.
        stale_values, stale_amounts = async_ticks.protocol_staleness_amounts(delays, k_async)
        delays = async_ticks.clamp_partner_delays(delays, k_async)
        ring = async_ticks.effective_ring(ring, k_async)
    # The distinct delays come from the padded array: a superset of the
    # live ones, the same on every rank (each rank issues the same gathers).
    (ring_mode, ring_bytes, delay_values, transport, capacity, hub_plan, delta_on,
     exchange_extra, staleness) = _resolve_partnered_exchange(
        transport, protocol, ring_mode, delays, ring, n_padded, k, w, degree, k_async,
        stale_values, stale_amounts, hub_rows,
    )
    plan = _Plan(
        protocol=protocol, picks=fanout if protocol == "pushk" else 1, n_padded=n_padded,
        k=k, s=s, chunk=chunk, w=w, ring=ring, ring_mode=ring_mode,
        delay_values=delay_values, delta=delta_on, capacity=capacity,
        hub_count=hub_plan["hub_count"] if hub_plan else 0, async_k=k_async,
        staleness=staleness, transport=transport,
    )
    ring_extra = {
        "mode": ring_mode, "bytes_per_chip": ring_bytes, "slots": ring,
        "delay_splits": len(delay_values) if delay_values else 1,
    }
    return plan, (ell_idx, delays, degree, hub_plan), ring_extra, exchange_extra


def run_sharded_partnered_sim(
    graph: Graph,
    schedule: Schedule,
    horizon_ticks: int,
    mesh,
    protocol: str = "pushpull",
    fanout: int = 2,
    ell_delays: np.ndarray | None = None,
    constant_delay: int = 1,
    chunk_size: int = 4096,
    seed: int = 0,
    churn=None,
    loss=None,
    record_coverage: bool = False,
    checkpoint_path: str | None = None,
    checkpoint_every: int = 1,
    stop_after_chunks: int | None = None,
    ring_mode: str = "auto",
    exchange: str = "dense",
    async_k: int = 2,
    hub_rows: int | None = None,
    *,
    plain: bool = False,
):
    """The counterpart of `models.protocols.run_pushpull_sim` (``protocol``
    "pushpull" or "pull") and `run_pushk_sim` ("pushk", ``fanout`` picks)
    on a (shares, nodes) mesh (`parallel.mesh.make_mesh`), called by every
    rank of the mesh on the mesh's device: the JAX package's
    ``run_sharded_partnered_sim``, argument for argument, and the same
    per-node counters for any mesh shape, under churn and link loss.

    ``chunk_size`` is per share shard. With ``record_coverage`` returns
    (stats, the (horizon, num_shares) per-round coverage rows), else stats.
    ``checkpoint_path`` / ``checkpoint_every`` / ``stop_after_chunks``: a
    pass-boundary checkpoint written by the mesh's first rank in the JAX
    format (same fingerprint, mesh shape included), read by every rank; not
    with ``record_coverage``.

    ``ring_mode`` "replicated", "sharded" or "auto" (sharded for fanout
    push, and for anti-entropy under one delay or past
    `engine_sharded.RING_REPLICATED_MAX_BYTES`). ``exchange`` "dense",
    "delta", "hub" (``hub_rows`` pins the split), "auto" (delta when the
    anti-entropy ring is sharded over more than one node shard), or
    "async" / "async-dense" / "async-delta" with ``async_k`` K: every
    partner-read delay clamped to ``max(d, K)`` before staging
    (`async_ticks.clamp_partner_delays`; the synchronous run on those
    delays is the parity reference) and the reads' gathers issued a round
    ahead; fanout push with an async exchange raises ValueError, as in
    JAX. ``stats.extra['ring']`` and ``['exchange']`` are JAX's;
    ``['resident_bytes']`` is this rank's modeled peak device memory
    (`_Runner.resident_bytes`). ``plain=True`` runs the kernels' plain
    versions."""
    if protocol not in PROTOCOLS:
        raise ValueError(f"unknown protocol {protocol!r}")
    if protocol == "pull":
        _check_pull_credit_bound(graph, chunk_size, schedule)
    if mesh.first_axis != SHARES_AXIS:
        raise ValueError("the sharded protocols run on a (shares, nodes) mesh; a (replicas, "
                         "nodes) mesh is batch.campaign_sharded's")
    chunk_size = min(chunk_size, max(MIN_CHUNK_SHARES, schedule.num_shares))
    chunk_size = bitmask.num_words(chunk_size) * bitmask.WORD_BITS
    plan, (ell_idx, delays, degree, hub_plan), ring_extra, exchange_extra = stage_partnered(
        graph, mesh, protocol, fanout, ell_delays, constant_delay, chunk_size, ring_mode,
        exchange, async_k, hub_rows)
    k, s, w, n_padded, picks = plan.k, plan.s, plan.w, plan.n_padded, plan.picks
    received = np.zeros(n_padded, dtype=np.int64)
    sent = np.zeros(n_padded, dtype=np.int64)
    checkpointer = None
    if checkpoint_path is not None:
        if record_coverage:
            raise ValueError(
                "checkpointing is not combinable with record_coverage (a resumed run "
                "would be missing the skipped chunks' coverage)"
            )
        ckpt_fp = fingerprint(  # the JAX package's parts, in its order
            "sharded_partnered_sim", protocol, picks, graph.n, graph.edges(),
            schedule.origins, schedule.gen_ticks, horizon_ticks, chunk_size, s, k, delays,
            int(seed) & _U32,
            churn.down_start if churn is not None else None,
            churn.down_end if churn is not None else None,
            np.asarray(loss.static_cfg, dtype=np.int64) if loss is not None else None,
        )
        cls = ChunkCheckpointer if mesh.is_first else _ReadOnlyCheckpointer
        checkpointer = cls(checkpoint_path, ckpt_fp, {"received": received, "sent": sent},
                           checkpoint_every)
    tel = _agree(mesh, tel_sink.rings_enabled())
    runner = _Runner(plan, mesh, ell_idx, delays, degree, hub_plan, churn, loss,
                     int(seed) & _U32, tel, plain)

    name = f"parallel.protocols_sharded.{protocol}_runner"
    pass_size = s * chunk_size
    exch_totals = np.zeros(4, dtype=np.int64)  # used, overflow ticks, fallbacks, ticks
    cov_chunks = []
    chunks = schedule.chunk(pass_size) or [schedule]
    for ci, chunk in checkpointed_chunks(chunks, checkpointer, stop_after_chunks):
        origins, gen_ticks = chunk.padded(pass_size, horizon_ticks)
        mine = slice(runner.q * chunk_size, (runner.q + 1) * chunk_size)
        with span("dispatch", kernel=name, chunk=ci):
            out = runner.run_pass(origins[mine], gen_ticks[mine], horizon_ticks,
                                  record_coverage)
        received += out["counters"][0]
        sent += out["counters"][1]
        exch_totals += out["exchange"]
        if record_coverage:
            # Shard q's slots are the pass's [q * chunk, (q + 1) * chunk).
            cov = out["coverage"]
            cov_chunks.append(np.concatenate(
                [cov[q][:, :min(max(chunk.num_shares - q * chunk_size, 0), chunk_size)]
                 for q in range(s)], axis=1))
        if mesh.is_first:
            head = None
            if tel:
                mets, digs = out["rings"]
                for q in range(s):
                    tel_rings.emit_ring(name, mets[q], t0=0, ticks=horizon_ticks, chunk=ci,
                                        shard=q)
                    tel_digest.emit_digest(name, digs[q], t0=0, ticks=horizon_ticks,
                                           chunk=ci, shard=q)
                head = int(digs[0][-1]) & _U32
            tel_progress.emit_progress(name, chunk=ci, chunks_total=len(chunks),
                                       ticks_done=horizon_ticks * (ci + 1), digest_head=head)

    generated = effective_generated(schedule, horizon_ticks, churn)
    received, sent = received[: graph.n], sent[: graph.n]
    stats = NodeStats(
        generated=generated, received=received, forwarded=received.copy(), sent=sent,
        processed=generated + received, degree=graph.degree.astype(np.int64),
    )
    stats.extra["ring"] = ring_extra
    if plan.delta:
        used, ovf, fallbacks, ticks = (int(v) for v in exch_totals)
        exchange_extra = _achieved_exchange_report(
            exchange_extra, (used, ovf, fallbacks), ticks, k, plan.n_loc, w, plan.capacity,
            hub_count=plan.hub_count)
    stats.extra["exchange"] = exchange_extra
    stats.extra["resident_bytes"] = runner.resident_bytes(horizon_ticks, record_coverage)
    if record_coverage:
        return stats, np.concatenate(cov_chunks, axis=1)
    return stats


# --- audit specs (staticcheck/: the op audit runs these tiny cases) ---------
# The JAX package's ``_audit_spec_partnered_runner``: ER(16, 0.3), a 32-share
# pass of 8 rounds, two shares at node 0 on round 0, the loss coin on, seed
# 42, fanout 2 for fanout push; the replicated ring on dense, the sharded
# one on the campaign form (2 local replicas on a (replicas, nodes) mesh).
# Delta and hub read one mesh vector a round (`_Runner._advance`), the
# others none; a telemetry row on delta stages its fallback counts. A call
# stages its generations (four host constants) and the exchange counters
# (one), and reads the counters and exchange counters back once (and each
# ring, telemetry on).

_PARTNERED = "p2p_gossip_tpu_torch/parallel/protocols_sharded.py"
_ROUND_BODIES = tuple(f"{_PARTNERED}:_Runner.{m}" for m in (
    "_round", "_pull", "_push", "_advance", "_gather_rows"))
_AUDIT_ROUNDS = 8


def _audit_spec(protocol: str, exchange: str = "dense", telemetry: bool = False,
                campaign: bool = False):
    from p2p_gossip_tpu_torch.models.linkloss import LinkLossModel
    from p2p_gossip_tpu_torch.staticcheck import op_audit, specs
    from p2p_gossip_tpu_torch.staticcheck.registry import AuditSpec

    graph = specs.sharded_graph()
    mesh = op_audit.audit_mesh("replicas" if campaign else "shares")
    chunk, horizon, rb = 32, _AUDIT_ROUNDS, (2 if campaign else 1)
    ring_mode = "sharded" if campaign else ("replicated" if exchange == "dense" else "auto")
    plan, (ell_idx, delays, degree, hub_plan), _, _ = stage_partnered(
        graph, mesh, protocol, 2, None, 1, chunk, ring_mode, exchange, 2,
        2 if exchange == "hub" else None)
    loss = LinkLossModel(2.0 ** -12, seed=7)
    runner = _Runner(plan, mesh, ell_idx, delays, degree, hub_plan, None, loss, 42, telemetry,
                     False, replicas=rb if campaign else 0)
    if campaign:
        runner.set_replicas(np.arange(rb) + 42, None, np.arange(rb) + 7)
    origins = np.zeros((rb, chunk), dtype=np.int32)
    gen_ticks = np.full((rb, chunk), horizon, dtype=np.int32)
    gen_ticks[:, :2] = 0
    out = ("int64", "int64") + (("int64", "int32") if telemetry else ())
    return AuditSpec(
        fn=runner.run_pass, args=(origins, gen_ticks, horizon, False),
        integer_only=True, bitmask_words=bitmask.num_words(chunk),
        # the summed counters (received, sent), the exchange counters; the rings
        out_dtypes=out, counterpart_outputs=(0, None) + ((None, None) if telemetry else ()),
        ticks=horizon, setup_reads=2 + (2 if telemetry else 0), h2d=5,
    )


from p2p_gossip_tpu_torch.staticcheck.registry import register_entry  # noqa: E402

for _tag, _jax, _kw in (
        ("[pushpull]", "pushpull_runner", dict(protocol="pushpull")),
        ("[pushpull][telemetry]", "pushpull_runner[telemetry]",
         dict(protocol="pushpull", telemetry=True)),
        ("[pushk]", "pushk_runner", dict(protocol="pushk")),
        ("[pushk][telemetry]", "pushk_runner[telemetry]",
         dict(protocol="pushk", telemetry=True)),
        ("[pushpull-delta]", "pushpull_runner[delta]", dict(protocol="pushpull",
                                                            exchange="delta")),
        ("[pushpull-hub]", "pushpull_runner[hub]", dict(protocol="pushpull", exchange="hub")),
        ("[pushpull-async]", "pushpull_runner[async]", dict(protocol="pushpull",
                                                            exchange="async")),
        ("[pushpull-campaign]", "pushpull_runner[campaign]", dict(protocol="pushpull",
                                                                  campaign=True))):
    _tel = bool(_kw.get("telemetry"))
    register_entry(f"parallel.protocols_sharded._Runner.run_pass{_tag}",
                   spec=lambda kw=_kw: _audit_spec(**kw),
                   counterpart=f"parallel.protocols_sharded.{_jax}",
                   host_reads_per_tick=2 if _tel else 1, sharded=True,
                   tick_bodies=_ROUND_BODIES + ((f"{_PARTNERED}:_Runner._telemetry_row",)
                                                if _tel else ()))
