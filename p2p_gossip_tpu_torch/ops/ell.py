"""ELL gather-OR frontier propagation — the hot op of the tick engine.

One tick delivers every in-flight message at once:

    arrivals[dst] = OR_{k in nbrs(dst)} hist[(t - delay[dst,k]) mod D, src[dst,k]]

where ``hist`` is a ring of the last D newly-acquired frontiers: per-edge
latency as reads into the past. On the GPU every variant below is one
launch of the hand-written ``gather_or`` kernel (ops/kernels.py) per ELL
(one per degree bucket); on the CPU it is that kernel's plain version.
Each variant takes the ring's sector occupancy ``occ`` ((D, N_src) int32,
`kernels.sector_occupancy` of each slot) so the kernel reads only the
sectors of a source row that hold bits; None reads every sector. Each also
takes the two options the kernel applies: ``loss``, the link-loss model's
(threshold, seed) pair, whose coin hashes (src, dst, arrival tick ``t``)
edge by edge before the OR (dst is the output row's node id: its index in
a full-width ELL, its bucket's ``rows`` entry in a bucketed one), and
``up``, the churn model's (N_out,) bool destination mask (a down node's
arrivals are zero). ``replicas`` B stacks B rings along the rows, each
variant still one launch per ELL (`kernels.gather_or`): the ring is (D,
B*N_src, W), ``occ`` (D, B*N_src), ``up`` (B*N_out,), the arrivals (B*N_out,
W), and the loss seed may be a (B,) int32 tensor, one seed a replica.
``seen`` ((B*N_out, W) int32, the destinations' seen-sets) masks the
arrivals to ``& ~seen`` — what the flood tick keeps of them — and lets the
kernel skip reads that could only bring bits the destination has; None
is the raw gather.

The host planners (`bucket_rows_by_count`, `build_degree_buckets`,
`detect_uniform_delay`, and the sharded engine's `split_ell_by_delay` and
`shard_bucket_ell`) are this package's own copies of the JAX package's,
so both stage identical buckets; `shard_buckets` cuts one shard's
buckets straight from CSR.
"""

from __future__ import annotations

import numpy as np
import torch

from p2p_gossip_tpu_torch.models.linkloss import drop_mask_torch
from p2p_gossip_tpu_torch.ops import kernels

# Degree quantum of the bucketing policy (row caps are multiples of it).
DEFAULT_DEGREE_BLOCK = 8

# Degree-bucket levels above this are quantized to powers of two (see
# build_degree_buckets) and always form standalone buckets.
GEOMETRIC_LEVEL_THRESHOLD = 8


def detect_uniform_delay(ell_delays, ell_mask) -> int | None:
    """The delay when every VALID edge shares it, else None — the single
    rule for choosing the uniform-delay path."""
    ell_delays = np.asarray(ell_delays)
    ell_mask = np.asarray(ell_mask)
    valid = ell_delays[ell_mask] if ell_mask.size else ell_delays
    if valid.size and (valid == valid.flat[0]).all():
        return int(valid.flat[0])
    return None


def gather_or_frontier(
    frontier: torch.Tensor,  # (N_src, W) int32 — one delay slice of history
    tick: int,
    ell_idx: torch.Tensor,   # (N_out, dmax) int32
    ell_mask: torch.Tensor,  # (N_out, dmax) bool
    *,
    occ: torch.Tensor | None = None,  # (N_src,) int32 sector occupancy
    loss: tuple | None = None,
    up: torch.Tensor | None = None,
    replicas: int = 1,
    seen: torch.Tensor | None = None,
    plain: bool = False,
) -> torch.Tensor:
    """OR-gather arrivals from a single source frontier: (N_out, W).
    ``tick`` is the arrival tick (the loss coin's input), whichever past
    slice ``frontier`` is."""
    out = torch.empty(
        (replicas * ell_idx.shape[0], frontier.shape[-1]), dtype=torch.int32,
        device=frontier.device,
    )
    return kernels.gather_or(
        frontier.unsqueeze(0), tick, ell_idx, ell_mask, uniform_slot=0,
        occ=None if occ is None else occ.unsqueeze(0), loss=loss, up=up,
        out=out, replicas=replicas, seen=seen, plain=plain,
    )


def propagate_uniform(
    hist: torch.Tensor,      # (D, N_src, W) int32
    tick: int,
    ell_idx: torch.Tensor,   # (N_out, dmax) int32
    ell_mask: torch.Tensor,  # (N_out, dmax) bool
    *,
    ring_size: int,
    uniform_delay: int = 1,
    occ: torch.Tensor | None = None,
    loss: tuple | None = None,
    up: torch.Tensor | None = None,
    replicas: int = 1,
    seen: torch.Tensor | None = None,
    plain: bool = False,
) -> torch.Tensor:
    """Uniform per-edge delay: the delay-line slot is one scalar per tick,
    so no per-edge delay is read."""
    if hist.shape[0] != ring_size:
        raise ValueError("hist ring does not match ring_size")
    slot = (tick - uniform_delay) % ring_size
    return gather_or_frontier(
        hist[slot], tick, ell_idx, ell_mask,
        occ=None if occ is None else occ[slot], loss=loss, up=up,
        replicas=replicas, seen=seen, plain=plain,
    )


def propagate(
    hist: torch.Tensor,       # (D, N_src, W) int32
    tick: int,
    ell_idx: torch.Tensor,    # (N_out, dmax) int32
    ell_delay: torch.Tensor,  # (N_out, dmax) int32, >= 1
    ell_mask: torch.Tensor,   # (N_out, dmax) bool
    *,
    ring_size: int,
    occ: torch.Tensor | None = None,
    loss: tuple | None = None,
    up: torch.Tensor | None = None,
    replicas: int = 1,
    seen: torch.Tensor | None = None,
    plain: bool = False,
) -> torch.Tensor:
    """Per-edge delays: arrivals (N_out, W) int32."""
    if hist.shape[0] != ring_size:
        raise ValueError("hist ring does not match ring_size")
    out = torch.empty(
        (replicas * ell_idx.shape[0], hist.shape[-1]), dtype=torch.int32,
        device=hist.device,
    )
    return kernels.gather_or(
        hist, tick, ell_idx, ell_mask, ell_delay, occ=occ, loss=loss, up=up,
        out=out, replicas=replicas, seen=seen, plain=plain,
    )


def propagate_bucketed(
    hist: torch.Tensor,
    tick: int,
    buckets,
    *,
    n_out: int,
    ring_size: int,
    uniform_delay: int | None = None,
    occ: torch.Tensor | None = None,
    loss: tuple | None = None,
    up: torch.Tensor | None = None,
    replicas: int = 1,
    seen: torch.Tensor | None = None,
    plain: bool = False,
) -> torch.Tensor:
    """Gather-OR over degree buckets (see `build_degree_buckets`),
    bitwise-identical to `propagate`/`propagate_uniform` on the full ELL.
    Each bucket's launch writes its rows straight into node order; rows no
    bucket names stay zero."""
    if hist.shape[0] != ring_size:
        raise ValueError("hist ring does not match ring_size")
    arrivals = torch.zeros(
        (replicas * n_out, hist.shape[-1]), dtype=torch.int32, device=hist.device
    )
    uniform_slot = (
        None if uniform_delay is None else (tick - uniform_delay) % ring_size
    )
    for rows, b_idx, b_mask, b_delay in buckets:
        kernels.gather_or(
            hist, tick, b_idx, b_mask,
            None if uniform_delay is not None else b_delay,
            uniform_slot=uniform_slot, rows=rows, occ=occ, loss=loss, up=up,
            out=arrivals, replicas=replicas, seen=seen, plain=plain,
        )
    return arrivals


def propagate_reference(
    hist, tick, ell_idx, ell_delay, ell_mask, *, ring_size, loss=None
):
    """Straight-line oracle: materializes (N_out, dmax, W) and OR-folds it,
    with the loss coin (dst = row index) cleared from the mask."""
    d, n_src, w = hist.shape
    slot = torch.remainder(tick - ell_delay.to(torch.int64), ring_size)
    gathered = hist.reshape(d * n_src, w)[slot * n_src + ell_idx.to(torch.int64)]
    if loss is not None:
        dst = torch.arange(ell_idx.shape[0], device=hist.device)[:, None]
        ell_mask = ell_mask & ~drop_mask_torch(ell_idx, dst, tick, *loss)
    gathered = torch.where(ell_mask[..., None], gathered, 0)
    acc = torch.zeros((ell_idx.shape[0], w), dtype=torch.int32, device=hist.device)
    for k in range(gathered.shape[1]):
        acc |= gathered[:, k]
    return acc


def bucket_rows_by_count(cnt, block: int, min_rows: int):
    """THE bucketing policy: quantize per-row valid-entry counts to levels
    (linear multiples of ``block``; powers of two past
    ``GEOMETRIC_LEVEL_THRESHOLD`` so heavy tails stay < 2x padded), then
    merge small linear-level groups upward until each holds ``min_rows``
    rows — tail levels always stand alone. Returns row-index arrays in
    ascending level order; they partition ``range(len(cnt))``."""
    cnt = np.asarray(cnt, dtype=np.int64)
    if cnt.size == 0:
        return []
    level = -(-cnt // block)
    high = level > GEOMETRIC_LEVEL_THRESHOLD
    if high.any():
        level = np.where(
            high,
            1 << np.ceil(np.log2(np.maximum(level, 1))).astype(np.int64),
            level,
        )
    order = np.argsort(level, kind="stable")
    sorted_level = level[order]
    change = np.flatnonzero(np.diff(sorted_level)) + 1
    groups = np.split(order, change)
    merged: list[np.ndarray] = []
    pending: list[np.ndarray] = []
    pending_count = 0
    for g in groups:
        if level[g[0]] > GEOMETRIC_LEVEL_THRESHOLD:  # geometric group
            if pending:
                merged.append(np.concatenate(pending))
                pending, pending_count = [], 0
            merged.append(g)
            continue
        pending.append(g)
        pending_count += g.shape[0]
        if pending_count >= min_rows:
            merged.append(np.concatenate(pending))
            pending, pending_count = [], 0
    if pending:
        # Leftovers keep their own bucket: folding them into the previous
        # bucket would raise that bucket's cap for every row.
        merged.append(np.concatenate(pending))
    return merged


def build_degree_buckets(
    graph,
    ell_delays=None,
    *,
    block: int = DEFAULT_DEGREE_BLOCK,
    min_rows: int = 2048,
    ell: tuple | None = None,
):
    """Group nodes into degree buckets for padding-free ELL propagation.

    Nodes are grouped by ``ceil(degree / block)`` so each group's ELL is
    padded only to its own cap. Returns a tuple of numpy ``(rows, ell_idx,
    ell_mask, ell_delay)`` per bucket (``ell_delay`` None without per-edge
    delays); the ``rows`` arrays partition ``range(n)``. ``ell`` passes an
    already built ``(ell_idx, ell_mask)`` pair."""
    deg = np.asarray(graph.degree)
    if ell is None and ell_delays is not None:
        ell = graph.ell()
    ell_idx, ell_mask = ell if ell is not None else (None, None)
    buckets = []
    for rows in bucket_rows_by_count(deg, block, min_rows):
        # Cap at the bucket's true max degree, block-rounded.
        cap = max(-(-int(deg[rows].max()) // block) * block, block)
        if ell_idx is not None:
            b_idx = np.ascontiguousarray(ell_idx[rows, :cap])
            b_mask = np.ascontiguousarray(ell_mask[rows, :cap])
        else:
            b_idx, b_mask = graph.ell_rows(rows, cap)
        buckets.append(
            (
                rows.astype(np.int32),
                b_idx.astype(np.int32, copy=False),
                b_mask.astype(bool, copy=False),
                np.ascontiguousarray(ell_delays[rows, :cap]).astype(np.int32)
                if ell_delays is not None
                else None,
            )
        )
    return tuple(buckets)


def split_ell_by_delay(ell_idx, ell_delay, ell_mask):
    """Partition ELL columns by delay value — the sharded-ring read plan
    (the JAX package's ``split_ell_by_delay``). One (idx, mask) pair per
    distinct delay of a valid edge, each packed left (valid edges first,
    in column order) and trimmed to its own max row count; padding slots
    hold index 0 under a False mask. Returns a tuple of ``(delay, idx_d,
    mask_d)``; the masks partition the valid entries of ``ell_mask``. With
    no valid edge, one vacuous pair ``(1, idx[:, :1], False)``."""
    ell_idx = np.asarray(ell_idx)
    ell_delay = np.asarray(ell_delay)
    ell_mask = np.asarray(ell_mask)
    values = np.unique(ell_delay[ell_mask])
    if values.size == 0:
        return ((1, ell_idx[:, :1], np.zeros_like(ell_mask[:, :1])),)
    n = ell_idx.shape[0]
    out = []
    for d in values:
        # O(nnz) packing through the nonzero coordinates (row-major, so
        # each row keeps its column order); no (N, dmax) permutation.
        m = ell_delay == d
        m &= ell_mask
        counts = m.sum(axis=1, dtype=np.int64)
        cap = max(int(counts.max()), 1)
        rows, cols = np.nonzero(m)
        pos = np.arange(rows.shape[0], dtype=np.int64) - (np.cumsum(counts) - counts)[rows]
        idx_d = np.zeros((n, cap), dtype=ell_idx.dtype)
        msk_d = np.zeros((n, cap), dtype=bool)
        idx_d[rows, pos] = ell_idx[rows, cols]
        msk_d[rows, pos] = True
        out.append((int(d), idx_d, msk_d))
    return tuple(out)


def shard_bucket_ell(ell_idx, ell_mask, n_shards: int, *,
                     block: int = DEFAULT_DEGREE_BLOCK, min_rows: int = 2048):
    """Degree buckets of one ELL (idx, mask) pair for each of ``n_shards``
    node shards, with shard-uniform shapes (the JAX package's
    ``shard_bucket_ell``): rows grouped by valid-entry count with the
    `bucket_rows_by_count` policy over ``min_rows * n_shards`` rows, each
    bucket's row capacity the max over shards. Returns a tuple of ``(rows,
    idx, mask)`` with a leading shard axis: rows (S, R) int32 LOCAL row
    ids padded with ``n_loc`` (out of range: dropped), idx/mask (S, R, C)
    from the pair's leading columns (idx holds GLOBAL source ids).
    Zero-count rows appear in no bucket."""
    ell_idx = np.asarray(ell_idx)
    ell_mask = np.asarray(ell_mask)
    return shard_buckets(
        ell_mask.sum(axis=1).astype(np.int64), ell_idx.shape[1],
        lambda rows, cap: (ell_idx[rows, :cap], ell_mask[rows, :cap]),
        n_shards, block=block, min_rows=min_rows,
    )


def shard_buckets(cnt, width: int, rows_fn, n_shards: int, *,
                  block: int = DEFAULT_DEGREE_BLOCK, min_rows: int = 2048,
                  shard: int | None = None):
    """`shard_bucket_ell` from per-row valid-entry counts ``cnt``
    (n_padded,), the ELL ``width`` and ``rows_fn(global_rows, cap) ->
    (idx, mask)`` (an ELL slice, or `Graph.ell_rows` straight from CSR, so
    no global ELL is built). With ``shard`` set, only that shard's arrays
    are built and returned without the shard axis: rows (R,), idx/mask (R,
    C), the same values as the stacked arrays' row ``shard``."""
    cnt = np.asarray(cnt, dtype=np.int64)
    n_padded = cnt.shape[0]
    assert n_padded % n_shards == 0, (n_padded, n_shards)
    n_loc = n_padded // n_shards
    nz = np.flatnonzero(cnt > 0)
    row_groups = (
        [nz[g] for g in bucket_rows_by_count(cnt[nz], block, min_rows * n_shards)]
        if nz.size
        else [np.zeros(0, dtype=np.int64)]
    )
    shards = range(n_shards) if shard is None else (shard,)
    buckets = []
    for grows in row_groups:
        grp_max = int(cnt[grows].max()) if grows.size else 1
        cap = min(max(-(-grp_max // block) * block, 1), width)
        owner = grows // n_loc
        r_cap = max(max(int((owner == s).sum()) for s in range(n_shards)), 1)
        rows_arr = np.full((len(shards), r_cap), n_loc, dtype=np.int32)
        idx_arr = np.zeros((len(shards), r_cap, cap), dtype=np.int32)
        msk_arr = np.zeros((len(shards), r_cap, cap), dtype=bool)
        for i, s in enumerate(shards):
            gsl = grows[owner == s]
            if not gsl.size:
                continue
            rows_arr[i, : gsl.size] = gsl - s * n_loc
            idx_arr[i, : gsl.size], msk_arr[i, : gsl.size] = rows_fn(gsl, cap)
        if shard is None:
            buckets.append((rows_arr, idx_arr, msk_arr))
        else:
            buckets.append((rows_arr[0], idx_arr[0], msk_arr[0]))
    return tuple(buckets)


# --- audit specs (staticcheck/: the op audit runs these tiny cases) ---------

def _audit_spec(kind: str):
    """8 rows, degree cap 3, W = 2 words, the loss coin on (the JAX
    package's ``_audit_spec_propagate``), on a random ring."""
    from p2p_gossip_tpu_torch.staticcheck import specs
    from p2p_gossip_tpu_torch.staticcheck.registry import AuditSpec

    rng = np.random.default_rng(0)
    n, dmax, w, ring = 8, 3, 2, 2
    hist = specs.words(rng, (ring, n, w))
    idx = specs.tensor(rng.integers(0, n, (n, dmax)), np.int32)
    msk = specs.tensor(rng.random((n, dmax)) < 0.8)
    common = dict(integer_only=True, bitmask_words=w, bitmask_args=(0,), bitmask_outputs=(0,),
                  out_dtypes=("int32",), counterpart_outputs=(0,))
    loss = (1 << 20, 3)
    if kind == "frontier":
        return AuditSpec(args=(hist[0], 1, idx, msk), kwargs=dict(loss=loss), **common)
    if kind == "uniform":
        return AuditSpec(args=(hist, 1, idx, msk),
                         kwargs=dict(ring_size=ring, uniform_delay=1, loss=loss), **common)
    dly = specs.tensor(rng.integers(1, ring, (n, dmax)), np.int32)
    return AuditSpec(args=(hist, 1, idx, dly, msk), kwargs=dict(ring_size=ring, loss=loss),
                     **common)


from p2p_gossip_tpu_torch.staticcheck.registry import register_entry  # noqa: E402

register_entry("ops.ell.propagate", propagate, spec=lambda: _audit_spec("per_edge"),
               counterpart="ops.ell.propagate")
register_entry("ops.ell.propagate_uniform", propagate_uniform,
               spec=lambda: _audit_spec("uniform"), counterpart="ops.ell.propagate_uniform")
register_entry("ops.ell.gather_or_frontier", gather_or_frontier,
               spec=lambda: _audit_spec("frontier"), counterpart="ops.ell.gather_or_frontier")
