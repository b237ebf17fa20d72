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
- Campaign mode (JAX's ``replica_axis``) is not here.

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
    resolve_ring_mode,
)
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
    """One rank's staged operands and its pass loop."""

    def __init__(self, plan: _Plan, mesh, ell_idx, delays, degree, hub_plan, churn, loss,
                 seed: int, telemetry_on: bool, plain: bool):
        p = self.plan = plan
        self.mesh, self.plain, self.tel = mesh, plain, telemetry_on
        self.dev = dev = mesh.device
        self.q, shard = mesh.coordinate
        self.row_offset = lo = shard * p.n_loc
        mine = slice(lo, lo + p.n_loc)
        self.nodes, self.shares = mesh.nodes_group, mesh.shares_group

        def on_dev(a, dtype):
            return torch.as_tensor(np.ascontiguousarray(a, dtype=dtype), device=dev)

        self.ell_idx = on_dev(ell_idx[mine], np.int32)      # global partner ids
        self.ell_delay = on_dev(delays[mine], np.int32)
        self.degree = on_dev(degree[mine], np.int64)
        self.live = self.degree > 0                          # padding rows never exchange
        self.rows = torch.arange(p.n_loc, dtype=torch.int64, device=dev)
        self.node_ids = self.rows + lo
        picks = torch.arange(p.picks, dtype=torch.int64, device=dev)
        self.key = pick_key(self.node_ids[:, None], picks[None, :], seed)  # (n_loc, picks)
        self.churn = None if churn is None else (
            on_dev(pad_to_multiple(churn.down_start, p.k), np.int32),
            on_dev(pad_to_multiple(churn.down_end, p.k), np.int32))
        self.loss = loss.static_cfg if loss is not None and loss.threshold > 0 else None
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
        self.staged_bytes = sum(t.numel() * t.element_size() for t in staged)

    def resident_bytes(self, horizon: int, record_coverage: bool = False) -> int:
        """Modeled peak device memory of this rank over a call (telemetry
        off), counted from the code: the staged operands (``staged_bytes``)
        and the pass state — ``seen``, the ring (this shard's rows, or all
        rows when replicated), the counters, the delta state (per-delay
        mirrors, the received (idx, val) rings, the hub ring, the rebuild
        canvas) or the async landed slices, the coverage rows — plus the
        largest of the round's transient peaks, each the (n_loc, W) or
        (n_padded, W) tensors alive at one point of the round:

        - the read: the own (t - d) rows, and the pulled rows as they are
          assembled (on the sharded ring the old and the new pulled rows,
          one slice's selected rows and, on the dense transport, that
          gathered slice);
        - the push: the own and pulled rows, the global-width push buffer,
          the received (k, n_loc, W) stack and the folded rows;
        - the update: the arrivals, the generation bits and ``~seen``;
        - the delta exchange: the new rows, the changed words and ``~`` of
          the previous slot, then the two (1, capacity) buffers;
        - the async prefetch: the new rows and the next round's landed
          slices in flight beside this round's."""
        p = self.plan
        row = p.w * 4
        loc, glob = p.n_loc * row, p.n_padded * row
        groups = len(p.delay_values) if p.delay_values else 1
        rows = p.n_loc if p.sharded_ring else p.n_padded
        state = p.ring * rows * row + loc + p.n_loc * (4 + 8)
        if p.delta:
            state += (groups + 1) * glob + 2 * p.ring * p.k * p.capacity * 4
            state += p.ring * p.k * p.hub_count * row
        elif p.landed:
            state += groups * glob
        if record_coverage:
            state += (1 + p.s) * horizon * p.chunk * 4
        own = 0 if p.protocol == "pull" else p.picks * loc
        pulled = loc if p.anti else 0
        read = pulled
        if p.anti and p.sharded_ring:
            read = 3 * loc + (0 if p.delta or p.landed else glob)
        peaks = [own + read, 3 * loc + (p.n_padded * 8 if p.protocol == "pull" else 0)]
        if p.protocol != "pull":
            peaks.append(own + pulled + 2 * glob + loc)
        if p.delta:
            peaks.append(2 * loc + max(loc, 2 * p.capacity * 4))
        if p.landed:
            peaks.append(loc + groups * glob)
        return self.staged_bytes + state + max(peaks)

    # -- collectives ----------------------------------------------------------

    def _gather_rows(self, local: torch.Tensor, async_op: bool = False):
        """all_gather of a (n_loc, W) slice over the nodes group into a
        fresh (n_padded, W) tensor (and the work handle when async)."""
        out = torch.empty((self.plan.n_padded, self.plan.w), dtype=local.dtype,
                          device=self.dev)
        work = all_gather_rows(out, local, self.nodes, async_op=async_op)
        return (out, work) if async_op else out

    # -- the round's parts ------------------------------------------------------

    def _pull(self, st, t: int, partners, delay, slot):
        """The partners' (t - d) rows, (n_loc, W), a fresh tensor; under
        async with telemetry on, also adds each late view's staleness (a
        remote row holding any bit) into ``st['stale']``."""
        p = self.plan
        if not p.sharded_ring:
            return st["flat"][slot * p.n_padded + partners]
        remote = torch.zeros((p.n_loc, p.w), dtype=torch.int32, device=self.dev)
        lo, hi = self.row_offset, self.row_offset + p.n_loc
        for j, dv in enumerate(p.delay_values):
            if p.delta:
                view = st["mirrors"][j]
            elif p.landed:
                view, work = st["landed"][j]
                if work is not None:
                    work.wait()
            else:
                view = self._gather_rows(st["hist"][(t - dv) % p.ring])
            if self.tel and p.async_k and p.staleness[j] > 0:
                pending = ((view[:lo] != 0).any() | (view[hi:] != 0).any()).to(torch.int64)
                st["stale"] = st["stale"] + p.staleness[j] * pending
                st["folds"] = st["folds"] + pending
            remote = torch.where((delay == dv)[:, None], view[partners], remote)
            del view  # before the next slice's gather
        return remote

    def _push(self, dst, src_rows, ok):
        """The pushes of ``src_rows`` (M, W) to global rows ``dst`` (M,)
        where ``ok``: one `kernels.scatter_or` into the (n_padded, W) push
        buffer, then `_reduce_scatter_or` into this shard's (n_loc, W)."""
        p = self.plan
        offsets, entries = kernels.scatter_or_plan(dst, None, ok, p.n_padded, src_rows.shape[0])
        pushed = torch.empty((p.n_padded, p.w), dtype=torch.int32, device=self.dev)
        kernels.scatter_or(src_rows, offsets, entries, out=pushed, plain=self.plain)
        out = torch.empty((p.n_loc, p.w), dtype=torch.int32, device=self.dev)
        return _reduce_scatter_or(pushed, self.nodes, out, self.plain)

    def _advance(self, st, t: int, d_words) -> int:
        """The delta exchange of round t's changed words ``d_words`` and the
        mirrors' advance to the slices round t + 1 reads (u = t + 1 - d):
        a flagged slot resets from a dense all_gather (the ring slot IS the
        cumulative slice), any other ORs in its rebuilt deltas (an
        unwritten slot holds -1 indices: a no-op, as the all-zero
        pre-history). Returns the round's dense fallback reads."""
        p, plain = self.plan, self.plain
        slot_w = t % p.ring
        cidx, cval, counts = kernels.compress_deltas(d_words, self.need, p.capacity,
                                                     plain=plain)
        all_gather_rows(st["didx"][slot_w], cidx, self.nodes)
        all_gather_rows(st["dval"][slot_w], cval, self.nodes)
        if self.hub is not None:
            all_gather_rows(st["hub"][slot_w], d_words[self.hub[0]], self.nodes)
        vec = torch.stack([(counts > p.capacity).any().to(torch.int64),
                           counts.clamp(max=p.capacity).sum(dtype=torch.int64)])
        dist.all_reduce(vec, group=self.nodes)
        ovf, used = vec.tolist()  # the round's one host read, uniform over the group
        st["flags"][slot_w] = ovf > 0
        fallbacks = 0
        for j, dv in enumerate(p.delay_values):
            slot_u = (t + 1 - dv) % p.ring
            if st["flags"][slot_u]:
                all_gather_rows(st["mirrors"][j], st["hist"][slot_u], self.nodes)
                fallbacks += 1
                continue
            canvas = kernels.scatter_deltas(st["didx"][slot_u], st["dval"][slot_u], p.n_loc,
                                            p.w, p.n_padded, out=st["canvas"], plain=plain)
            if self.hub is not None:
                exch.overlay_hub(canvas, self.hub[1], st["hub"][slot_u])
            st["mirrors"][j] |= canvas
        st["counters"][0] += used
        st["counters"][1] += int(ovf > 0)
        st["counters"][2] += fallbacks
        return fallbacks

    # -- one pass ----------------------------------------------------------------

    def run_pass(self, origins, gen_ticks, horizon: int, record_coverage: bool) -> dict:
        """``horizon`` rounds of one pass (this rank's share shard's
        ``origins``/``gen_ticks``, (chunk,) int32 numpy). Returns host
        values, identical on every rank: the global counters, the exchange
        counters and, when recorded, every share shard's coverage rows and
        rings."""
        p, dev = self.plan, self.dev
        n_loc, w, ring = p.n_loc, p.w, p.ring
        rows = n_loc if p.sharded_ring else p.n_padded
        hist = torch.zeros((ring, rows, w), dtype=torch.int32, device=dev)
        local = origins.astype(np.int64) - self.row_offset
        in_shard = (local >= 0) & (local < n_loc)
        st = {
            "hist": hist, "flat": hist.view(ring * rows, w), "counters": [0, 0, 0],
            "stale": 0, "folds": 0,
            "seen": torch.zeros((n_loc, w), dtype=torch.int32, device=dev),
            "received": torch.zeros((n_loc,), dtype=torch.int32, device=dev),
            "sent": torch.zeros((n_loc,), dtype=torch.int64, device=dev),
            "ticks": torch.arange(horizon, dtype=torch.int64, device=dev),
            # The generations: this shard's rounds with one, and each share's
            # local row, origin, liveness and tick.
            "gen_rounds": set(np.unique(gen_ticks[in_shard]).tolist()),
            "gen": tuple(torch.as_tensor(a, device=dev) for a in (
                local, origins.astype(np.int64), in_shard, gen_ticks)),
            "slots": torch.arange(p.chunk, dtype=torch.int64, device=dev),
            "cov": (torch.zeros((horizon, p.chunk), dtype=torch.int32, device=dev)
                    if record_coverage else None),
            "rings": tel_rings.chunk_rings(horizon, dev) if self.tel else None,
        }
        groups = len(p.delay_values) if p.delay_values else 1
        if p.delta:
            st["mirrors"] = torch.zeros((groups, p.n_padded, w), dtype=torch.int32, device=dev)
            st["didx"] = torch.full((ring, p.k, p.capacity), -1, dtype=torch.int32, device=dev)
            st["dval"] = torch.zeros((ring, p.k, p.capacity), dtype=torch.int32, device=dev)
            st["canvas"] = torch.empty((p.n_padded, w), dtype=torch.int32, device=dev)
            st["flags"] = [False] * ring
            if self.hub is not None:
                st["hub"] = torch.zeros((ring, p.k * p.hub_count, w), dtype=torch.int32,
                                        device=dev)
        if p.landed:  # round 0 reads pre-history: zero slices
            st["landed"] = [(torch.zeros((p.n_padded, w), dtype=torch.int32, device=dev), None)
                            for _ in range(groups)]
        for t in range(horizon):
            self._round(st, t)  # its temporaries go when it returns
        for _, work in st.get("landed", ()):
            if work is not None:  # the prefetch past the horizon: done before its buffer goes
                work.wait()
        return self._finish(st, horizon)

    def _round(self, st, t: int) -> None:
        """Round t of a pass: picks, the pull and the push, the counters,
        the generations, the ring write, the exchange and the rows."""
        p, dev, plain = self.plan, self.dev, self.plain
        n_loc, w, ring = p.n_loc, p.w, p.ring
        anti, lo = p.anti, self.row_offset
        seen, hist = st["seen"], st["hist"]
        tt = st["ticks"][t]  # a device scalar: no host copy a round
        if anti:
            kidx = pick_from_key(self.key[:, 0], tt, self.degree)[:, None]
        else:
            kidx = pick_from_key(self.key, tt, self.degree[:, None])
        partners = self.ell_idx.gather(1, kidx).to(torch.int64)
        delay = self.ell_delay.gather(1, kidx)
        if anti:
            partners, delay = partners[:, 0], delay[:, 0]
        slot = torch.remainder(tt - delay, ring)
        my_old = None  # the own (t - d) rows the round pushes
        if p.protocol != "pull":
            rows = n_loc if p.sharded_ring else p.n_padded
            own = self.rows if p.sharded_ring else self.node_ids
            my_old = st["flat"][slot * rows + (own if anti else own[:, None])]
        remote = self._pull(st, t, partners, delay, slot) if anti else None

        self_ids = self.node_ids if anti else self.node_ids[:, None]
        attempted = (self.live if anti else self.live[:, None]).expand(partners.shape)
        up = None if self.churn is None else churn_mod.up_mask(*self.churn, t)
        if up is not None:
            attempted = attempted & up[self_ids] & up[partners]
        pull_ok = push_ok = attempted
        if self.loss is not None:
            thr, lseed = self.loss
            push_ok = attempted & ~drop_mask_torch(self_ids, partners, tt, thr, lseed)
            if anti:
                pull_ok = attempted & ~drop_mask_torch(partners, self.node_ids, tt, thr, lseed)
        dropped = 0
        if anti:
            pc_remote = bitmask.popcount_rows(remote, plain=plain)  # before the coin
            remote.masked_fill_(~pull_ok[:, None], 0)
            if self.tel and self.loss is not None:
                dropped = tel_rings.u32sum(torch.where(attempted & ~pull_ok, pc_remote, 0))
            if p.protocol == "pull":
                # Each attempted pull credits its (possibly remote) responder
                # with the row it served, lost or not.
                credit = torch.zeros((p.n_padded,), dtype=torch.int64, device=dev)
                credit.index_add_(0, partners,
                                  torch.where(attempted, pc_remote, 0).to(torch.int64))
                dist.all_reduce(credit, group=self.nodes)
                sent_add = credit[lo:lo + n_loc]
                arrivals = remote
            else:
                arrivals = self._push(partners, my_old, push_ok)
                arrivals |= remote
                my_cnt = bitmask.popcount_rows(my_old, plain=plain)
                sent_add = torch.where(attempted, my_cnt, 0)
                if self.tel and self.loss is not None:
                    pushed_lost = tel_rings.u32sum(torch.where(attempted & ~push_ok, my_cnt, 0))
                    dropped = (dropped + pushed_lost) & _U32  # a uint32 add, as in JAX
            del remote
        else:
            src_rows = my_old.reshape(-1, w)
            arrivals = self._push(partners.reshape(-1), src_rows, push_ok.reshape(-1))
            pick_cnt = bitmask.popcount_rows(src_rows, plain=plain).view(partners.shape)
            # JAX sums a node's picks in int32 and adds the sum as uint32.
            sent_add = torch.where(attempted, pick_cnt, 0).sum(dim=1, dtype=torch.int64) & _U32
            if self.tel and self.loss is not None:
                dropped = tel_rings.u32sum(torch.where(attempted & ~push_ok, pick_cnt, 0))
        del my_old
        st["sent"] += sent_add

        gen_bits = None
        if t in st["gen_rounds"]:
            gen_rows, gen_origins, gen_live, gen_ticks = st["gen"]
            gen_active = (gen_ticks == t) & gen_live
            if up is not None:
                gen_active &= up[gen_origins]
            gen_bits = bitmask.slot_scatter(n_loc, w, gen_rows, st["slots"], gen_active)
        gathered = tel_rings.total_bits(arrivals, plain=plain) if self.tel else None
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
        fallbacks = 0
        if p.delta:
            # This round's change against the previous slot, read before the
            # write (ring >= 2 slots).
            d_words = exchange & ~hist[(t - 1) % ring]
        if p.sharded_ring:
            hist[slot_w].copy_(exchange)
        else:
            all_gather_rows(hist[slot_w], exchange, self.nodes)
        if p.delta:
            fallbacks = self._advance(st, t, d_words)
        if p.landed:
            # Round t + 1's slices, issued now from the written ring (slot
            # t + 1 - d is final for every d >= 1).
            st["landed"] = [self._gather_rows(hist[(t + 1 - dv) % ring], async_op=True)
                            for dv in p.delay_values]
        if st["cov"] is not None:
            cov = bitmask.coverage_per_slot(seen, p.chunk, plain=plain)
            dist.all_reduce(cov, group=self.nodes)
            st["cov"][t] = cov
        if self.tel:
            self._telemetry_row(st, t, newbits, newly_cnt, gathered, sent_add, dropped,
                                fallbacks)
            st["stale"] = st["folds"] = 0

    def _finish(self, st, horizon: int) -> dict:
        """The pass's counters SUMmed over the mesh (own rows into a zero
        int64 canvas: disjoint over nodes, added over shares), the exchange
        counters over the share shards, and every share shard's coverage
        rows and rings."""
        p, dev = self.plan, self.dev
        counters = torch.zeros((2, p.n_padded), dtype=torch.int64, device=dev)
        own = slice(self.row_offset, self.row_offset + p.n_loc)
        counters[0, own] = st["received"]  # int32, as JAX's host sum of the shards' stacks
        counters[1, own] = st["sent"]
        dist.all_reduce(counters, group=self.mesh.group)
        ex = torch.tensor(st["counters"] + [horizon if p.delta else 0], dtype=torch.int64,
                          device=dev)
        dist.all_reduce(ex, group=self.shares)
        out = {"counters": counters.cpu().numpy(), "exchange": tuple(ex.tolist())}
        if st["cov"] is not None:
            out["coverage"] = self._gather_shares(st["cov"])
        if st["rings"] is not None:
            out["rings"] = tuple(self._gather_shares(r) for r in st["rings"])
        return out

    def _gather_shares(self, local: torch.Tensor) -> np.ndarray:
        """Every share shard's ``local`` tensor, stacked on the host."""
        out = torch.empty((self.plan.s * local.shape[0],) + tuple(local.shape[1:]),
                          dtype=local.dtype, device=self.dev)
        all_gather_rows(out, local, self.shares)
        return out.view((self.plan.s,) + tuple(local.shape)).cpu().numpy()

    def _telemetry_row(self, st, t, newbits, newly_cnt, gathered, sent_add, dropped,
                       fallbacks):
        """Row t of the metric ring, SUMmed over the nodes group (uint32
        wrap), and the digest of the post-round state XORed over it (the
        JAX package's sharded protocol rows, column for column)."""
        p = self.plan
        met, dig = st["rings"]
        pc_new = bitmask.popcount_rows(newbits, plain=self.plain)
        tel_rings.row(
            met, t,
            frontier_bits=tel_rings.u32sum(pc_new),
            frontier_nodes=tel_rings.u32sum(pc_new > 0),
            newly_infected=tel_rings.u32sum(newly_cnt),
            msgs_gathered=gathered,
            or_work=tel_rings.u32sum(sent_add),
            loss_dropped=dropped,
        )
        k1 = p.k - 1
        if p.delta:
            words = k1 * (2 * p.capacity + p.hub_count * p.w) + fallbacks * k1 * p.n_loc * p.w
        elif p.sharded_ring:
            words = (len(p.delay_values) if p.anti else 0) * k1 * p.n_loc * p.w
        else:
            words = k1 * p.n_loc * p.w
        met[t, 6] = words & _U32
        met[t, 7] = st["stale"]
        met[t, 8] = st["folds"]
        dist.all_reduce(met[t], group=self.nodes)
        met[t] &= _U32
        sent_lo, sent_hi = tel_digest.split_u64(st["sent"])
        dig[t] = tel_digest.tick_digest_sharded(
            st["seen"], st["received"], sent_lo, sent_hi=sent_hi, id_offset=self.row_offset,
            group=self.nodes, plain=self.plain)


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
    chunk_size = min(chunk_size, max(MIN_CHUNK_SHARES, schedule.num_shares))
    chunk_size = bitmask.num_words(chunk_size) * bitmask.WORD_BITS
    w = bitmask.num_words(chunk_size)

    # The JAX package's staging: partner picks index the real per-edge
    # delays, padding rows fill with delay 1 (degree 0: they never
    # exchange).
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
    (ring_mode, ring_bytes, delay_values, _, capacity, hub_plan, delta_on, exchange_extra,
     staleness) = _resolve_partnered_exchange(
        transport, protocol, ring_mode, delays, ring, n_padded, k, w, degree, k_async,
        stale_values, stale_amounts, hub_rows,
    )
    picks = fanout if protocol == "pushk" else 1
    plan = _Plan(
        protocol=protocol, picks=picks, n_padded=n_padded, k=k, s=s, chunk=chunk_size, w=w,
        ring=ring, ring_mode=ring_mode, delay_values=delay_values, delta=delta_on,
        capacity=capacity, hub_count=hub_plan["hub_count"] if hub_plan else 0,
        async_k=k_async, staleness=staleness,
    )
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
    stats.extra["ring"] = {
        "mode": ring_mode, "bytes_per_chip": ring_bytes, "slots": ring,
        "delay_splits": len(delay_values) if delay_values else 1,
    }
    if delta_on:
        used, ovf, fallbacks, ticks = (int(v) for v in exch_totals)
        exchange_extra = _achieved_exchange_report(
            exchange_extra, (used, ovf, fallbacks), ticks, k, plan.n_loc, w, capacity,
            hub_count=plan.hub_count)
    stats.extra["exchange"] = exchange_extra
    stats.extra["resident_bytes"] = runner.resident_bytes(horizon_ticks, record_coverage)
    if record_coverage:
        return stats, np.concatenate(cov_chunks, axis=1)
    return stats
