"""Device-side metric rings — fixed-shape per-tick aggregate buffers.

A metric ring is a ``(capacity, NUM_METRICS)`` int64 tensor holding
uint32 values; each tick writes one row of aggregate counters
(schema.METRIC_COLUMNS) at its tick index, on the device. The ring is
harvested ONCE per chunk on the host (`emit_ring`) — nothing per tick
crosses to the host. Rows are the JAX package's ``telemetry/rings.py``
rows value for value.

Engines build a ring only when `sink.rings_enabled()` is on; off, no
ring exists and no row is computed, and a tick launches exactly the
kernels it launches without telemetry.

Overflow bound: values are uint32, as in the JAX package, so a per-tick
aggregate >= 2^32 cannot be represented. `u32sum` SATURATES at 2^32 - 1
instead of wrapping, so an overflowed aggregate reads as the sentinel
4294967295 rather than a small garbage value — the same value the JAX
package's limb sum gives wherever its sum is exact (up to 2^24 summands).
"""

from __future__ import annotations

import numpy as np
import torch

from p2p_gossip_tpu_torch.ops import kernels
from p2p_gossip_tpu_torch.telemetry import digest, sink
from p2p_gossip_tpu_torch.telemetry.schema import METRIC_COLUMNS, NUM_METRICS

#: uint32 saturation sentinel: an aggregate that could not be
#: represented reads as exactly this value.
U32_MAX = 0xFFFFFFFF


def chunk_rings(horizon: int, device, replicas: int | None = None):
    """A chunk's fresh telemetry rings, one row per tick: the (horizon,
    NUM_METRICS) metric ring and the (horizon,) digest ring, both zero; for
    a campaign batch of ``replicas`` B, the (B, horizon, NUM_METRICS) and
    (B, horizon) rings of `init_batched` and `digest.init_batched`."""
    if replicas is None:
        return (torch.zeros((horizon, NUM_METRICS), dtype=torch.int64, device=device),
                digest.init(horizon, device))
    return init_batched(replicas, horizon, device), digest.init_batched(replicas, horizon, device)


def init_batched(batch: int, capacity: int, device) -> torch.Tensor:
    """Zeroed (batch, capacity, NUM_METRICS) ring: one metric ring a replica
    of a campaign batch (the JAX package's ``init_batched``)."""
    return torch.zeros((batch, capacity, NUM_METRICS), dtype=torch.int64, device=device)


def write_batched(ring: torch.Tensor, t: int, rows: torch.Tensor) -> None:
    """Write the (B, k) ``rows`` into the first k columns of row ``t`` of
    each replica's ring in the (B, capacity, NUM_METRICS) ``ring`` (the JAX
    package's ``write_batched``): one device copy."""
    ring[:, t, :rows.shape[1]] = rows


def ring_replicas(ring: torch.Tensor) -> int | None:
    """B of a (B, capacity, NUM_METRICS) campaign ring; None for a solo
    (capacity, NUM_METRICS) ring."""
    return ring.shape[0] if ring.dim() == 3 else None


def u32sum(x: torch.Tensor, replicas: int | None = None) -> torch.Tensor:
    """Saturating-uint32 total of an integer (or bool) tensor, as a 0-d
    int64: each entry read as its uint32 value, summed in int64 and
    clamped at ``U32_MAX``. With ``replicas`` B, ``x`` holds B replicas
    stacked along its first axis and the result is the (B,) per-replica
    totals, one reduction over a (B, -1) view."""
    x = x.to(torch.int64) & U32_MAX
    total = x.sum() if replicas is None else x.reshape(replicas, -1).sum(dim=1)
    return torch.clamp(total, max=U32_MAX)


def total_bits(words: torch.Tensor, replicas: int | None = None, *,
               plain: bool = False) -> torch.Tensor:
    """Popcount of a whole bitmask, through the ``popcount_rows`` kernel,
    as a 0-d int64 uint32 value; per replica, (B,), with ``replicas`` B
    stacked along the rows."""
    return u32sum(kernels.popcount_rows(words.reshape(-1, words.shape[-1]), plain=plain),
                  replicas)


def row(
    ring: torch.Tensor,
    t: int,
    frontier_bits,
    frontier_nodes,
    newly_infected,
    msgs_gathered,
    or_work,
    loss_dropped=0,
) -> None:
    """Write one tick's row into row ``t`` of ``ring`` (zero until now:
    each tick writes its row once), in METRIC_COLUMNS order. Each column
    is a 0-d int64 tensor holding a uint32 value (`u32sum`,
    `total_bits`), or for a (B, capacity, NUM_METRICS) campaign ring a
    (B,) tensor of every replica's value; ``loss_dropped`` may be the int
    0, which stays unwritten. ``exchange_words``, ``staleness`` and
    ``stale_folds`` price the JAX package's sharded and async exchanges,
    which a single device never makes: they stay 0. One stack and one
    copy, nothing from the host: a copy from pageable host memory would
    wait for the stream, a sync every tick."""
    cols = [frontier_bits, frontier_nodes, newly_infected, msgs_gathered, or_work]
    if isinstance(loss_dropped, torch.Tensor):
        cols.append(loss_dropped)
    batched = ring if ring.dim() == 3 else ring[None]
    write_batched(batched, t, torch.stack(cols, dim=-1).reshape(batched.shape[0], -1))


def flood_row(
    ring: torch.Tensor,
    t: int,
    arrivals: torch.Tensor,        # (N, W) post-loss gather output, pre-churn
    newly_out: torch.Tensor,       # (N, W) the tick's new frontier (incl. gens)
    received_delta: torch.Tensor,  # (N,) first-time receives this tick
    degree: torch.Tensor,          # (N,) int32
    arrivals_lossless=None,        # (N, W) the same gather with loss off
    *,
    plain: bool = False,
) -> None:
    """Write the flood engine's row ``t`` into ``ring`` (the JAX
    package's ``flood_row``). ``loss_dropped`` is the post-OR popcount delta between the lossless
    and actual gathers, exact in message *bits* (a bit dropped on every
    one of its arriving edges counts once); a uint32 difference, as
    there. A campaign batch passes its (B, capacity, NUM_METRICS) ring and
    its state stacked along the rows (every N above B*N): each replica's
    row comes from reductions over a (B, N) view, so the tick's launches do
    not grow with B, and replica r's row is its solo run's."""
    b = ring_replicas(ring)
    pc_new = kernels.popcount_rows(newly_out, plain=plain)
    gathered = total_bits(arrivals, b, plain=plain)
    dropped = 0
    if arrivals_lossless is not None:
        dropped = (total_bits(arrivals_lossless, b, plain=plain) - gathered) & U32_MAX
    row(
        ring, t,
        frontier_bits=u32sum(pc_new, b),
        frontier_nodes=u32sum(pc_new > 0, b),
        newly_infected=u32sum(received_delta, b),
        msgs_gathered=gathered,
        or_work=u32sum(torch.where(pc_new > 0, degree, 0), b),
        loss_dropped=dropped,
    )


def emit_ring(
    kernel: str,
    ring,
    *,
    t0: int = 0,
    ticks: int | None = None,
    **provenance,
) -> None:
    """Harvest one ring into a ``ring`` event (the JAX package's slicing).
    ``ring`` is the (cap, NUM_METRICS) ring, a device tensor or a host
    array; rows [t0, t0+ticks) are emitted (all rows past ``t0`` when
    ``ticks`` is None), less the trailing all-zero ones (a run that stops
    at quiescence leaves them zero), never fewer than 1 row. Extra
    keywords (chunk=, replica=, seed=, shard=) ride along as provenance
    fields. No-op when telemetry is off."""
    if not sink.enabled():
        return
    if isinstance(ring, torch.Tensor):
        ring = ring.cpu().numpy()
    ring = np.asarray(ring)
    window = ring[t0:] if ticks is None else ring[t0 : t0 + int(ticks)]
    nz = np.flatnonzero(window.any(axis=1))
    rows = ring[t0 : t0 + (int(nz[-1]) + 1 if nz.size else 1)]
    event = {
        "type": "ring",
        "kernel": kernel,
        "t0": int(t0),
        "ticks": int(rows.shape[0]),
        "columns": list(METRIC_COLUMNS),
        "metrics": {
            col: [int(v) for v in rows[:, i]]
            for i, col in enumerate(METRIC_COLUMNS)
        },
    }
    for key, val in provenance.items():
        if val is not None:
            event[key] = int(val) if isinstance(val, (np.integer,)) else val
    sink.emit(event)
