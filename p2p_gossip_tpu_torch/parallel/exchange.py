"""Sparse frontier-delta exchange for the sharded flood engine — the JAX
package's ``parallel/exchange.py`` on ``torch.distributed``.

The dense exchange moves whole bitmask slices: one all_gather of (n_loc,
W) rows per distinct delay value per tick, however little changed. The
sparse alternative, exact by OR-monotonicity:

- **compress** (`ops.kernels.compress_deltas`, a CUDA kernel): each
  tick, each shard packs the nonzero words of its new frontier slice
  into fixed-capacity (idx, val) buffers, one per destination shard,
  restricted by the static cut (`plan_flood_exchange`: which of MY rows
  does each destination's ELL read). The true counts come back, so the
  caller can flag overflow.
- **exchange**: the per-destination buffers ride ONE ``all_to_all_single``
  of idx and one of val per tick — 2 words per entry on the wire against
  n_loc x W words per dense slice.
- **reconstruct** (`ops.kernels.scatter_deltas`, a CUDA kernel): the
  receiver stores the entries into a zeroed (n_padded, W) canvas and
  overlays its own slice. Rows nobody sent stay zero — exact, because
  the gather masks the rows it reads by the cut, and ring slots hold
  newly-frontier words.
- **fallback**: when any shard's count exceeds capacity, the slot's
  overflow flag (a SUM over the nodes group, read on the host, so every
  rank takes the same branch) sends readers to the dense all_gather.

Capacity (`delta_capacity`): the worst-case cut words clamped to a
quarter of the dense per-tick slice traffic, so a no-overflow delta tick
moves at most half the dense words.

Degree-split hub/tail transport (``exchange="hub"``, `plan_hub_split`):
a static set of high-fan-out rows ships every tick as an index-free
all_gather block (`overlay_hub`), the sparse tail stays on the delta
buffers with a smaller capacity. The random-partner protocols
(`parallel.protocols_sharded`) need every row on every shard, so their
split ranks rows by degree (`plan_partnered_hub_split`). The numpy
planners are the JAX package's, so both packages plan the same capacities
and report the same modeled words.
"""

from __future__ import annotations

import numpy as np

import torch


def plan_flood_exchange(
    ell_idx: np.ndarray, ell_mask: np.ndarray, n_node_shards: int
) -> tuple[np.ndarray, np.ndarray]:
    """Static cut structure for the flood engines' delta exchange.

    Returns ``(need, need_counts)``: ``need`` is (n_padded, n_shards)
    bool — ``need[r, d]`` marks global row r as read by destination
    shard d's gather (r appears in d's valid ELL entries) — and
    ``need_counts[s, d]`` counts shard s's rows needed by d (the
    capacity planner's worst case). Own-shard rows are excluded: the
    reader overlays its local slice directly, so self-deltas never ride
    the wire. Rows sharded with P(nodes, None): each shard stages its
    own rows' destination sets."""
    n_padded = ell_idx.shape[0]
    n_loc = n_padded // n_node_shards
    need = np.zeros((n_padded, n_node_shards), dtype=bool)
    for d in range(n_node_shards):
        rows = np.unique(
            ell_idx[d * n_loc : (d + 1) * n_loc][
                ell_mask[d * n_loc : (d + 1) * n_loc]
            ]
        )
        need[rows, d] = True
        need[d * n_loc : (d + 1) * n_loc, d] = False
    need_counts = need.reshape(n_node_shards, n_loc, n_node_shards).sum(
        axis=1
    )
    return need, need_counts.astype(np.int64)


def plan_flood_exchange_csr(graph, n_padded: int, n_node_shards: int) -> np.ndarray:
    """`plan_flood_exchange`'s ``need`` straight from the graph's CSR, rows
    padded to ``n_padded`` (no (N, dmax) ELL is built): destination shard
    d reads every neighbour of its rows."""
    n_loc = n_padded // n_node_shards
    need = np.zeros((n_padded, n_node_shards), dtype=bool)
    for d in range(n_node_shards):
        lo, hi = min(d * n_loc, graph.n), min((d + 1) * n_loc, graph.n)
        rows = np.unique(graph.indices[graph.indptr[lo]:graph.indptr[hi]])
        need[rows, d] = True
        need[d * n_loc:(d + 1) * n_loc, d] = False
    return need


def delta_capacity(
    worst_rows: int, n_loc: int, w: int, delay_splits: int = 1
) -> int:
    """Fixed per-destination entry capacity for the delta buffers.

    ``worst_rows`` is the largest per-(src, dst) cut (rows; each row is
    ``w`` candidate words). The cap at ``delay_splits * n_loc * w / 4``
    guarantees a no-overflow tick moves <= half the dense slice traffic
    (2 wire words per entry); the floor and rounding keep tiny test
    shapes and TPU-friendly multiples."""
    worst_words = max(1, int(worst_rows)) * w
    cap = max(8, (delay_splits * n_loc * w) // 4)
    c = min(worst_words, cap)
    return max(8, -(-c // 8) * 8)


def modeled_exchange_words_per_tick(
    mode: str,
    *,
    n_shards: int,
    n_loc: int,
    w: int,
    delay_splits: int = 1,
    capacity: int = 0,
    hub_count: int = 0,
) -> int:
    """Per-chip per-tick exchange words received over ICI, by path —
    THE traffic model the engines'
    ``stats.extra['exchange']`` share (one definition so modeled numbers
    always match whichever path ran).

    - ``"replicated"``: write-time all_gather of the local newly slice.
    - ``"dense"`` (sharded ring): one slice all_gather per distinct
      delay value per tick.
    - ``"delta"``: one all_to_all/all_gather of (idx, val) pairs —
      2 words per entry, capacity entries per peer, delay-count
      independent. Overflow ticks add the dense cost back per fallback
      read (accounted separately by the achieved counters).
    - ``"hub"``: ``hub_count`` hub rows per shard ride an index-free
      all_gather (w words per row per peer) and the tail stays on the
      delta buffers (``capacity`` is the TAIL capacity).
    - ``"none"``: no cross-shard reads (fanout push's sharded ring).
    """
    if n_shards <= 1 or mode == "none":
        return 0
    if mode == "replicated":
        return (n_shards - 1) * n_loc * w
    if mode == "dense":
        return delay_splits * (n_shards - 1) * n_loc * w
    if mode == "delta":
        return (n_shards - 1) * 2 * capacity
    if mode == "hub":
        # Index-free hub block (w words per hub row per peer) + the
        # residual tail's (idx, val) delta buffers.
        return (n_shards - 1) * (hub_count * w + 2 * capacity)
    raise ValueError(f"unknown exchange mode {mode!r}")


def modeled_pack_index_words(
    n_dests: int, capacity: int, aggregate: bool
) -> int:
    """Scatter address words one compress pack spends per tick: the
    unaggregated pack drives two (dest, slot) dual-index 2-D scatters
    (2 address words per slot), the destination-major aggregate one
    flat 1-D scatter per buffer (1 address word per slot), over the
    same ``n_dests * (capacity + 1)`` slots either way."""
    return (1 if aggregate else 2) * n_dests * (capacity + 1)


def choose_aggregate(n_dests: int, capacity: int) -> bool:
    """Host-side per-fingerprint default for the JAX package's
    ``compress_deltas`` ``aggregate`` flag: True whenever the modeled
    aggregated pack is strictly cheaper than the unaggregated one. The outputs are
    bitwise-identical either way (the JAX package's tests pin it), so
    this is purely a cost-model decision — recorded by the engines in
    ``stats.extra['exchange']['aggregated']``."""
    return modeled_pack_index_words(
        n_dests, capacity, True
    ) < modeled_pack_index_words(n_dests, capacity, False)


def _hub_cost_curve(
    tail_worst, n_node_shards: int, n_loc: int, w: int, delay_splits: int
) -> tuple[list[int], list[int], int | None]:
    """Shared h-search: candidate hub sizes (multiples of 8 in
    [0, n_loc]), the modeled words/tick at each, and the crossover (the
    smallest h > 0 strictly beating the pure-delta h = 0 point).
    ``tail_worst`` maps candidate h -> worst per-(src, dst) tail rows."""
    cands = list(range(0, n_loc + 1, 8))
    if cands[-1] != n_loc:
        cands.append(n_loc)
    words = [
        modeled_exchange_words_per_tick(
            "hub", n_shards=n_node_shards, n_loc=n_loc, w=w,
            capacity=delta_capacity(
                tail_worst(h), n_loc, w, delay_splits
            ),
            hub_count=h,
        )
        for h in cands
    ]
    crossover = next(
        (h for h, wd in zip(cands, words) if h and wd < words[0]), None
    )
    return cands, words, crossover


def plan_hub_split(
    need: np.ndarray,          # (n_padded, k) bool — plan_flood_exchange
    need_counts: np.ndarray,   # (k, k) int64
    n_node_shards: int,
    n_loc: int,
    w: int,
    delay_splits: int = 1,
    hub_rows: int | None = None,
) -> dict:
    """Static degree-split for the flood engines' ``exchange="hub"``.

    Ranks each shard's rows by destination fan-out (how many remote
    shards read the row — the wire cost a hub row charges the delta
    path per tick) and searches hub sizes h (uniform across shards,
    multiples of 8 for static shapes) for the minimum of the shared
    cost model ``(k-1) * (h*w + 2*cap_tail(h))``; ties break toward
    smaller h and h = 0 degenerates to pure delta. ``hub_rows`` pins h
    (deterministic tests; hub-free graphs where the search picks 0).

    Returns ``{hub_count, hub_local (k, h) int32 local row ids,
    hub_global (k, h) int32 global row ids, need_tail (the need plan
    with hub rows cleared — tail buffers never re-ship a hub row),
    capacity (tail capacity), report (crossover + modeled words for
    a cost report)}``."""
    k = n_node_shards
    need = np.asarray(need, dtype=bool)
    need_counts = np.asarray(need_counts, dtype=np.int64)
    fan = need.sum(axis=1).reshape(k, n_loc)
    # Stable argsort on -fan: descending fan-out, row-id tiebreak.
    order = np.argsort(-fan, axis=1, kind="stable")
    ranked = np.take_along_axis(
        need.reshape(k, n_loc, k), order[:, :, None], axis=1
    )
    # cum[s, h, d]: how many of shard s's top-h rows are in d's cut.
    cum = np.concatenate(
        [np.zeros((k, 1, k), dtype=np.int64),
         np.cumsum(ranked, axis=1, dtype=np.int64)],
        axis=1,
    )

    def tail_worst(h: int) -> int:
        return int((need_counts - cum[:, h, :]).max(initial=0))

    cands, words, crossover = _hub_cost_curve(
        tail_worst, k, n_loc, w, delay_splits
    )
    if hub_rows is not None:
        h = max(0, min(int(hub_rows), n_loc))
    else:
        h = cands[int(np.argmin(words))]
    hub_local = order[:, :h].astype(np.int32)
    hub_global = (
        hub_local + np.arange(k, dtype=np.int32)[:, None] * n_loc
    )
    need_tail = need.copy()
    if h:
        need_tail[hub_global.reshape(-1), :] = False
    capacity = delta_capacity(
        int(
            need_tail.reshape(k, n_loc, k).sum(axis=1).max(initial=0)
        ),
        n_loc, w, delay_splits,
    )
    report = {
        "hub_count": h,
        "hub_rows_forced": hub_rows is not None,
        "crossover_h": crossover,
        "modeled_hub_words_per_tick": modeled_exchange_words_per_tick(
            "hub", n_shards=k, n_loc=n_loc, w=w, capacity=capacity,
            hub_count=h,
        ),
        # The pure-delta point of the same curve — what h beats.
        "modeled_delta_words_per_tick": words[0],
    }
    return {
        "hub_count": h, "hub_local": hub_local, "hub_global": hub_global,
        "need_tail": need_tail, "capacity": capacity, "report": report,
    }


def plan_partnered_hub_split(
    degree: np.ndarray,        # (>= n_padded,) node degrees (0-padded)
    n_node_shards: int,
    n_loc: int,
    w: int,
    delay_splits: int = 1,
    hub_rows: int | None = None,
) -> dict:
    """Degree-split for the partnered protocols' ``exchange="hub"``.

    Anti-entropy partner picks are global-random, so every shard needs
    every row (``need`` is all-ones) and fan-out cannot rank the split;
    node DEGREE does — hub rows are the ones whose delta words stay hot.
    The tail's worst case is uniform (``n_loc - h`` rows per shard), so
    the cost curve only rewards a hub once ``(n_loc - h) * w`` drops
    under the capacity clamp; the search is honest about that (h = 0
    wins on most shapes) and ``hub_rows`` pins h for the parity tests.
    Same return contract as `plan_hub_split` with ``need_tail`` shaped
    (n_padded, 1) — the partnered compress's single-destination cut mask."""
    k = n_node_shards
    n_padded = k * n_loc
    deg = np.zeros(n_padded, dtype=np.int64)
    m = min(n_padded, len(degree))
    deg[:m] = np.asarray(degree[:m], dtype=np.int64)
    order = np.argsort(-deg.reshape(k, n_loc), axis=1, kind="stable")

    def tail_worst(h: int) -> int:
        return n_loc - h

    cands, words, crossover = _hub_cost_curve(tail_worst, k, n_loc, w, delay_splits)
    if hub_rows is not None:
        h = max(0, min(int(hub_rows), n_loc))
    else:
        h = cands[int(np.argmin(words))]
    hub_local = order[:, :h].astype(np.int32)
    hub_global = hub_local + np.arange(k, dtype=np.int32)[:, None] * n_loc
    need_tail = np.ones((n_padded, 1), dtype=bool)
    if h:
        need_tail[hub_global.reshape(-1), :] = False
    capacity = delta_capacity(max(1, n_loc - h), n_loc, w, delay_splits)
    report = {
        "hub_count": h,
        "hub_rows_forced": hub_rows is not None,
        "crossover_h": crossover,
        "modeled_hub_words_per_tick": modeled_exchange_words_per_tick(
            "hub", n_shards=k, n_loc=n_loc, w=w, capacity=capacity, hub_count=h,
        ),
        "modeled_delta_words_per_tick": words[0],
    }
    return {
        "hub_count": h, "hub_local": hub_local, "hub_global": hub_global,
        "need_tail": need_tail, "capacity": capacity, "report": report,
    }


def cached_flood_plan(
    graph,
    n_padded: int,
    n_node_shards: int,
    aux_cache: tuple | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """``(need, need_counts)`` of `plan_flood_exchange_csr` (the cut
    `plan_flood_exchange` plans from the padded ELL, from the graph's CSR
    with rows padded to ``n_padded``), optionally persisted through the
    fingerprinted npz graph aux cache
    (models/topology.load_or_compute_graph_aux) so the 100K/1M-node cut
    scans run ONCE per graph build, like the partition labels they
    derive from. ``aux_cache`` is ``(path, fp, key)``; the key must
    encode everything that shapes the cut beyond the graph build —
    shard count, partition relabel seed — the caller owns that policy
    (the JAX package's scripts/mesh_rehearsal.py)."""
    def compute() -> np.ndarray:
        return plan_flood_exchange_csr(graph, n_padded, n_node_shards)

    if aux_cache:
        from p2p_gossip_tpu_torch.models.topology import load_or_compute_graph_aux
        from p2p_gossip_tpu_torch.utils import logging as p2plog

        path, fp, key = aux_cache
        need = load_or_compute_graph_aux(
            path, key, fp, lambda: compute().astype(np.uint8),
            p2plog.get_logger("Parallel.Exchange").info,
        ).astype(bool)
    else:
        need = compute()
    n_loc = need.shape[0] // n_node_shards
    need_counts = need.reshape(
        n_node_shards, n_loc, n_node_shards
    ).sum(axis=1).astype(np.int64)
    return need, need_counts


def overlay_hub(
    recon: torch.Tensor,       # (n_padded, w) int32 scattered tail canvas
    hub_global: torch.Tensor,  # (k, h) int64 global hub row ids
    hub_block: torch.Tensor,   # (k * h, w) int32 all_gathered hub rows
    replicas: int | None = None,
) -> torch.Tensor:
    """Overlay the all_gathered hub block onto a scattered tail canvas, in
    place (a row set, ``index_copy_``). Exact: the tail plan excludes hub
    rows, so the two row sets are disjoint, and the reader's own-slice
    overlay (when it runs) lands last with identical values for its own
    hub rows. ``replicas`` B: a campaign batch's (B, n_padded, w) canvases
    and the (k, B, h, w) block its all_gather leaves, every replica's hub
    rows set in the one ``index_copy_``. Returns ``recon``."""
    if replicas is None:
        return recon.index_copy_(0, hub_global.reshape(-1), hub_block)
    n_padded, w = recon.shape[-2], recon.shape[-1]
    rows = (torch.arange(replicas, dtype=torch.int64, device=recon.device)[:, None]
            * n_padded + hub_global.reshape(1, -1)).reshape(-1)
    k = hub_block.shape[0]
    block = hub_block.view(k, replicas, -1, w).transpose(0, 1).reshape(-1, w)
    recon.view(-1, w).index_copy_(0, rows, block)
    return recon



# --- audit specs (staticcheck/: the op audit runs these tiny cases) ---------

def _audit_spec(kind: str):
    """2 shards of 4 rows x 2 words, capacity 8 (the JAX package's
    ``_audit_spec``): the delta exchange's pack (`ops.kernels.
    compress_deltas`), its rebuild (`ops.kernels.scatter_deltas`) and the hub
    overlay."""
    from p2p_gossip_tpu_torch.ops import kernels
    from p2p_gossip_tpu_torch.staticcheck import specs
    from p2p_gossip_tpu_torch.staticcheck.registry import AuditSpec

    n_loc, w, cap, shards = 4, 2, 8, 2
    rng = np.random.default_rng(0)
    changed = specs.words(rng, (n_loc, w))
    common = dict(integer_only=True, bitmask_words=w)
    if kind == "compress":
        need = specs.tensor(rng.random((n_loc, shards)) < 0.5)
        return AuditSpec(fn=lambda ch, nd: kernels.compress_deltas(ch, nd, cap),
                         args=(changed, need), bitmask_args=(0,),
                         out_dtypes=("int32",) * 3, counterpart_outputs=(0, 1, 2), **common)
    if kind == "hub":
        h = 2
        hub_global = specs.tensor(np.stack([rng.choice(n_loc, h, replace=False) + s * n_loc
                                            for s in range(shards)]), np.int64)
        recon = specs.tensor(np.zeros((shards * n_loc, w)), np.int32)
        return AuditSpec(fn=overlay_hub, args=(recon, hub_global, specs.words(rng, (shards * h, w))),
                         bitmask_args=(0, 2), bitmask_outputs=(0,), out_dtypes=("int32",),
                         counterpart_outputs=(0,), **common)
    idx = specs.tensor(rng.integers(-1, n_loc * w, (shards, cap)), np.int32)
    return AuditSpec(fn=lambda i, v: kernels.scatter_deltas(i, v, n_loc, w, shards * n_loc),
                     args=(idx, specs.words(rng, (shards, cap))), bitmask_outputs=(0,),
                     out_dtypes=("int32",), counterpart_outputs=(0,), **common)


from p2p_gossip_tpu_torch.ops import kernels as _kernels  # noqa: E402
from p2p_gossip_tpu_torch.staticcheck.registry import register_entry  # noqa: E402

register_entry("ops.kernels.compress_deltas", _kernels.compress_deltas,
               spec=lambda: _audit_spec("compress"),
               counterpart="parallel.exchange.compress_deltas[delta]")
register_entry("ops.kernels.scatter_deltas", _kernels.scatter_deltas,
               spec=lambda: _audit_spec("scatter"),
               counterpart="parallel.exchange.scatter_deltas[delta]")
register_entry("parallel.exchange.overlay_hub", overlay_hub, spec=lambda: _audit_spec("hub"),
               counterpart="parallel.exchange.overlay_hub[hub]")
