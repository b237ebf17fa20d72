"""Bounded-staleness async ticks: K-ahead double-buffered frontiers.

The sharded engines' per-tick barrier is the scalability ceiling named
in ROADMAP: every shard waits for the slowest shard's frontier exchange
before it may OR a single new bit. ``exchange="async"`` removes the
read-side wait by double-buffering the exchanged frontier: each shard
keeps a ``landed`` carry — the already-completed gather of an OLDER ring
slot — and runs up to K ticks ahead on locally-known bits while the next
gather (issued at the top of the previous tick, riding the prefetch
window) completes in the background.

Exact semantics (the contract every parity test pins down):

- **Flood** (parallel/engine_sharded.py): ``async(K)`` is bitwise
  identical — per tick, digests included — to the synchronous engine run
  with per-edge delays ``d' = d`` on intra-shard edges and
  ``d' = max(d, K)`` on cross-shard edges. Local propagation stays
  timely (each shard "runs ahead on locally-known bits"); remote bits
  fold in when their prefetched gather lands, at most K ticks late.
  `clamp_flood_delays` builds that reference delay array so the EXISTING
  engines (sync/event/sharded-dense) replay the async schedule exactly,
  under churn and link loss: the loss coin hashes (tick, global ids) and
  the churn up-gate reads the current tick — neither reads delays — so
  arrival-tick equality implies coin-for-coin equality.
- **Partnered protocols**: not ported yet (their clamp,
  ``clamp_partner_delays``, comes with the sharded protocols).

Why stale reads are SAFE here (the OR-monotonicity argument,
the JAX package's docs/OBSERVABILITY.md): gossip state is a monotone join-semilattice —
``seen`` only grows, and `apply_tick_updates` dedups arrivals against
it (``newly = arrivals & ~seen``). A read of an older frontier can only
UNDER-report remote bits, never invent or double-count them; every bit
still arrives (the prefetched gather of its slot lands at most K ticks
later, and the ring keeps ``max(dmax, K) + 1`` slots, so no slot is
overwritten before its last reader), so the fixed point — final seen
universe, received/sent counters — is reached unchanged. Staleness
costs TIME (bounded by K per hop, the `ttc_percentiles` probe), never
correctness.

Convergence: quiescence must be judged at a common fold epoch — a shard
whose own ring is empty may still owe bits sitting in another shard's
not-yet-consumed ``landed`` buffer. `in_flight` ORs the history ring
with the landed carry; the engines psum that predicate over every mesh
axis, so the loop terminates only when all shards agree the frontier is
globally empty at the same fold epoch. (The ring check alone is already
exact — a bit in a landed buffer is gathered from a slot still inside
the ring window, hence nonzero — the landed term keeps the detector
locally sufficient rather than relying on that global invariant.)
"""

from __future__ import annotations

import numpy as np

#: Exchange-mode spellings accepted by the sharded entry points on top of the
#: synchronous "dense"/"delta"/"auto" trio.
ASYNC_EXCHANGES = ("async", "async-dense", "async-delta", "async-hub")


def parse_exchange(exchange: str, async_k: int) -> tuple[str, int]:
    """Split an entry point's ``exchange`` value into (transport, k).

    Synchronous modes pass through with k=0 (``async_k`` is ignored —
    it only parameterizes the async spellings). "async" leaves the
    transport on "auto" (delta when the ring shards across >1 chips);
    "async-dense"/"async-delta" pin it. ``async_k`` must be >= 1: K=1
    is the synchronous program routed through the double-buffer (the
    bitwise anchor of the parity ladder)."""
    if exchange not in ASYNC_EXCHANGES:
        if exchange not in ("dense", "delta", "auto", "hub"):
            raise ValueError(
                f"unknown exchange mode {exchange!r} (valid: dense, delta, "
                f"auto, hub, {', '.join(ASYNC_EXCHANGES)})"
            )
        return exchange, 0
    if async_k < 1:
        raise ValueError(
            f"async exchange needs async_k >= 1, got {async_k}"
        )
    transport = {
        "async": "auto", "async-dense": "dense", "async-delta": "delta",
        "async-hub": "hub",
    }[exchange]
    return transport, int(async_k)


def effective_ring(ring: int, async_k: int) -> int:
    """History-ring slots needed under async(K): the deepest read is
    ``max(dmax, K)`` ticks back (``ring`` arrives as dmax+1), and the
    prefetch issued one tick early must never race the write slot —
    ``max(dmax, K) + 1`` slots give both."""
    if async_k <= 0:
        return ring
    return max(ring, async_k + 1)


def group_offsets(
    group_delays: tuple, async_k: int
) -> tuple[tuple, tuple, tuple]:
    """Plan the landed-carry layout for the flood engine's delay groups.

    Returns ``(offsets, off_index, amounts)``: ``offsets`` is the sorted
    distinct tuple of prefetch offsets ``off = max(d, K)`` with
    ``off >= 2`` (one landed-carry slice — one background gather per
    tick — each; groups sharing an offset share the gather);
    ``off_index[g]`` maps group g to its slice, or -1 for the direct
    read-time path (only ``off == 1``: K=1 with delay-1 edges — the
    synchronous read); ``amounts[g] = off - d`` is the group's staleness
    in ticks (0 unless d < K), the telemetry column's unit."""
    if async_k < 1:
        raise ValueError(f"group_offsets needs async_k >= 1, got {async_k}")
    offs = sorted({
        max(int(d), async_k)
        for d in group_delays
        if max(int(d), async_k) >= 2
    })
    pos = {off: i for i, off in enumerate(offs)}
    off_index = tuple(
        pos.get(max(int(d), async_k), -1) for d in group_delays
    )
    amounts = tuple(
        max(int(d), async_k) - int(d) for d in group_delays
    )
    return tuple(offs), off_index, amounts


def clamp_flood_delays(
    graph,
    n_node_shards: int,
    async_k: int,
    ell_delays: np.ndarray | None = None,
    constant_delay: int = 1,
) -> np.ndarray:
    """The flood parity reference: the per-edge delay array that makes a
    SYNCHRONOUS engine replay async(K) exactly (module docstring) —
    ``d' = max(d, K)`` on cross-shard edges, ``d' = d`` on intra-shard.

    Shard membership follows the engines' padded row layout
    (`_padded_device_graph` + `pad_to_multiple`: padding rows append at
    the end, so node i lives in block ``i // n_loc`` with
    ``n_loc = n_padded / n_node_shards``). ELL row i gathers FROM
    ``idx[i, j]``, so the edge crosses shards iff the row and its source
    land in different blocks. Returns an (n, dmax) int32 array to pass
    as ``ell_delays`` to any engine."""
    ell_idx, ell_mask = graph.ell()
    if ell_delays is None:
        delays = np.full(ell_idx.shape, constant_delay, dtype=np.int32)
    else:
        delays = np.asarray(ell_delays, dtype=np.int32).copy()
    if async_k <= 1 or n_node_shards <= 1:
        return delays
    n = ell_idx.shape[0]
    n_padded = n + ((-n) % n_node_shards)
    n_loc = n_padded // n_node_shards
    rows = np.arange(n, dtype=np.int64)[:, None] // n_loc
    src = ell_idx.astype(np.int64) // n_loc
    cross = ell_mask & (rows != src)
    return np.where(
        cross, np.maximum(delays, np.int32(async_k)), delays
    ).astype(np.int32)


def in_flight(hist, landed=None) -> bool:
    """The async-aware convergence predicate on one rank: bits are still
    in flight while the history ring OR the landed (prefetched, not yet
    consumed) carry holds any nonzero word. The engines SUM it over every
    mesh axis, so termination is a global agreement at a common fold
    epoch."""
    alive = bool((hist != 0).any())
    if landed is not None:
        alive = alive or bool((landed != 0).any())
    return alive


def ttc_percentiles(coverage, fracs=(0.5, 0.9, 0.99)):
    """Staleness probe: per-share time-to-coverage percentiles from a
    (horizon, n_shares) per-tick coverage matrix (the flood-coverage
    entry points' second return). For each share and target fraction, the
    first tick whose count reaches ``frac * final`` (horizon when the
    share never gets there). Async(K) may only shift these RIGHT, by at
    most a factor bounded by the per-hop staleness — the
    tests/test_async_ticks.py bound ``sync <= async <= K * sync + K``
    per percentile."""
    cov = np.asarray(coverage)
    if cov.ndim == 1:
        cov = cov[:, None]
    horizon, s = cov.shape
    final = cov[-1].astype(np.float64)
    out = np.full((len(fracs), s), horizon, dtype=np.int64)
    for fi, frac in enumerate(fracs):
        target = frac * final
        reached = cov.astype(np.float64) >= target[None, :]
        any_hit = reached.any(axis=0)
        out[fi, any_hit] = reached.argmax(axis=0)[any_hit]
    return out


def modeled_overlap_report(
    transport: str,
    group_delays: tuple,
    async_k: int,
    n_shards: int,
    n_loc: int,
    w: int,
    capacity: int = 0,
    hub_count: int = 0,
) -> dict:
    """The ``stats.extra['exchange']`` async fields, priced against the
    shared traffic model (exchange.modeled_exchange_words_per_tick):
    per-tick words that ride the prefetch window (issued a full tick
    before their first reader — overlappable with the whole tick's
    compute) vs words a reader still blocks on (only the K=1 delay-1
    direct-read gathers). The cost observatory compares this modeled
    fraction against the achieved wall-clock ratio the mesh rehearsal
    measures."""
    offs, off_index, amounts = group_offsets(group_delays, async_k)
    k1 = max(0, n_shards - 1)
    blocking_groups = sum(1 for i in off_index if i < 0)
    if transport in ("delta", "hub"):
        # The fixed all_to_all footprint — plus the hub block's
        # all_gather under exchange="hub" — is written >= 2 ticks before
        # its first async reader; only dense fallbacks on direct groups
        # block.
        prefetch = k1 * (2 * capacity + hub_count * w)
        blocking = 0
    else:
        prefetch = len(offs) * k1 * n_loc * w
        blocking = blocking_groups * k1 * n_loc * w
    total = prefetch + blocking
    return {
        "async_k": int(async_k),
        "prefetch_offsets": list(offs),
        "staleness_amounts": list(amounts),
        "modeled_prefetch_words_per_tick": prefetch,
        "modeled_blocking_words_per_tick": blocking,
        "modeled_overlap_fraction": (
            prefetch / total if total else 1.0
        ),
    }
