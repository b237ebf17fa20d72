"""Per-tick state digests — the flight recorder's black-box stream.

A digest is one uint32 per simulated tick summarizing the engine's full
state: every packed seen-bitmask word and every per-node counter is
salted (by node id, word index, and counter kind), passed through a
32-bit integer mix, and XOR-folded. XOR is associative and commutative,
so the fold order never matters: the CUDA kernel (`ops.kernels.
tick_digest`, one atomicXor per block), its plain torch version and the
JAX package's XLA fold give bit-identical digests for the same state.
Two engines that agree tick for tick produce identical digest streams,
and the first differing index IS the first divergent tick
(`telemetry.compare`) — between the port and the JAX package too, since
both fold the same constants over the same state.

The device digest ring is a (capacity,) int32 tensor holding uint32 bit
patterns (a campaign batch's is (B, capacity), one lane a replica, all
written by one launch a tick), created only when telemetry's rings are
on; each tick XORs its digest into its own zeroed slot, and the ring is
harvested once a chunk (`emit_digest`, as ``v & 0xFFFFFFFF``). With
telemetry off no ring exists and the kernel never launches.

Digest semantics (what is folded, per tick, after the tick's updates):

- every seen word ``seen[i, k]`` salted with global node id i and
  chunk-local word index k;
- ``received[i]`` (per-node first-time receives, chunk-local);
- ``sent`` — the uint32 low word, plus the high word for the engines
  whose counter passes 2^32 (the partnered protocols: the port's int64
  ``sent`` folds as its low and high words, the JAX package's uint32
  pair). Flood engines fold the low word only.

The fold is SPARSE: an entry whose value is zero contributes nothing
(rather than mix(0 ^ salts)). That makes the digest invariant to pad
width — engines with different pad shapes produce bit-identical digests
for identical live state — and means sent_hi == 0 folds like an absent
high word.

`tick_digest_np` is the numpy twin (the JAX package's, copied) for host
code and tests.
"""

from __future__ import annotations

import numpy as np
import torch

from p2p_gossip_tpu_torch.ops import kernels
from p2p_gossip_tpu_torch.ops.kernels import (
    MIX_M1,
    MIX_M2,
    SALT_NODE,
    SALT_RECV,
    SALT_SENT_HI,
    SALT_SENT_LO,
    SALT_WORD,
)
from p2p_gossip_tpu_torch.telemetry import sink

_U32 = 0xFFFFFFFF


def split_u64(sent: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """An int64 counter (below 2^63) as its (lo, hi) uint32 words, each an
    int32 bit pattern — the JAX package's (sent_lo, sent_hi) pair."""
    lo = sent & _U32
    lo = torch.where(lo >= 2**31, lo - 2**32, lo).to(torch.int32)
    return lo, (sent >> 32).to(torch.int32)


# --- ring helpers --------------------------------------------------------------

def init(capacity: int, device) -> torch.Tensor:
    """Fresh (capacity,) int32 digest ring, every slot zero."""
    return torch.zeros((capacity,), dtype=torch.int32, device=device)


def init_batched(batch: int, capacity: int, device) -> torch.Tensor:
    """Fresh (batch, capacity) int32 digest ring: one digest lane a replica
    of a campaign batch (the JAX package's ``init_batched``)."""
    return torch.zeros((batch, capacity), dtype=torch.int32, device=device)


def write(ring: torch.Tensor, t: int, seen, received, sent_lo, sent_hi=None, *,
          plain: bool = False) -> None:
    """Digest the post-tick state into slot ``t`` of ``ring`` (zero
    until now: each tick writes its slot once): the ``tick_digest``
    kernel on a CUDA tensor, its plain version on the CPU or with
    ``plain=True``. ``seen`` (n, w) int32; ``received``/``sent_lo``/
    ``sent_hi`` (n,) int32 bit patterns. Omit ``sent_hi`` for the
    flood's int32 ``sent``. A (B, capacity) campaign ring goes to
    `write_batched`."""
    batched = ring if ring.dim() == 2 else ring[None]
    write_batched(batched, t, seen, received, sent_lo, sent_hi, plain=plain)


def write_batched(ring: torch.Tensor, t: int, seen, received, sent_lo, sent_hi=None, *,
                  plain: bool = False) -> None:
    """`write` for a campaign batch: the (B, capacity) ``ring`` and the B
    replicas' state stacked along the rows (``seen`` (B*n, w), the
    counters (B*n,)); one ``tick_digest`` launch writes every replica's
    slot ``t``, replica r's digest salted by node id as in its solo run."""
    kernels.tick_digest(seen, received, sent_lo, sent_hi, out=ring[:, t],
                        replicas=ring.shape[0], plain=plain)


def tick_digest_sharded(seen, received, sent_lo, *, id_offset: int, group,
                        sent_hi=None, replicas: int | None = None,
                        plain: bool = False) -> torch.Tensor:
    """One node shard's part of the tick digest, XOR-combined over the
    nodes process ``group`` (the JAX package's ``tick_digest_sharded``):
    the shard folds its rows with GLOBAL node ids (``id_offset`` + local
    row) through the ``tick_digest`` kernel, then one all_gather of the
    partials and an XOR of them — a SUM collective cannot XOR. Equal to
    the digest of the whole state, because XOR is order-free. Returns a
    0-d int32 device tensor (uint32 bits); with ``replicas`` B (state
    stacked along the rows, one launch) the (B,) digests."""
    import torch.distributed as dist

    from p2p_gossip_tpu_torch.parallel.mesh import all_gather_rows

    b = 1 if replicas is None else replicas
    part = kernels.tick_digest(seen, received, sent_lo, sent_hi, id_offset=id_offset,
                               replicas=b, plain=plain)
    parts = torch.empty((dist.get_world_size(group) * b,), dtype=torch.int32,
                        device=part.device)
    all_gather_rows(parts, part, group)
    parts = parts.view(-1, b)
    h = parts[0]
    for i in range(1, parts.shape[0]):
        h = h ^ parts[i]
    return h[0] if replicas is None else h


# --- host (numpy) twin -----------------------------------------------------------

def _mix_np(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint32)
    with np.errstate(over="ignore"):
        x = x ^ (x >> np.uint32(16))
        x = x * np.uint32(MIX_M1)
        x = x ^ (x >> np.uint32(15))
        x = x * np.uint32(MIX_M2)
        x = x ^ (x >> np.uint32(15))
    return x


def tick_digest_np(
    seen_words: np.ndarray,
    received: np.ndarray,
    sent_lo: np.ndarray,
    sent_hi: np.ndarray | None = None,
    node_ids: np.ndarray | None = None,
) -> int:
    """Bit-exact numpy twin of `tick_digest` for host code and for unit
    tests pinning the device implementation."""
    n, _w = seen_words.shape
    if node_ids is None:
        node_ids = np.arange(n, dtype=np.uint32)

    def fold_sparse(values, salted):
        return np.bitwise_xor.reduce(
            np.where(
                values.astype(np.uint32) == 0,
                np.uint32(0),
                _mix_np(salted),
            ),
            axis=None,
        )

    with np.errstate(over="ignore"):
        node_salt = node_ids.astype(np.uint32) * np.uint32(SALT_NODE)
        word_salt = (
            np.arange(seen_words.shape[1], dtype=np.uint32)
            * np.uint32(SALT_WORD)
        )
        seen_words = seen_words.astype(np.uint32)
        received = received.astype(np.uint32)
        sent_lo = sent_lo.astype(np.uint32)
        h = fold_sparse(
            seen_words,
            seen_words ^ word_salt[None, :] ^ node_salt[:, None],
        )
        h ^= fold_sparse(
            received, received ^ node_salt ^ np.uint32(SALT_RECV)
        )
        h ^= fold_sparse(
            sent_lo, sent_lo ^ node_salt ^ np.uint32(SALT_SENT_LO)
        )
        if sent_hi is not None:
            sent_hi = sent_hi.astype(np.uint32)
            h ^= fold_sparse(
                sent_hi, sent_hi ^ node_salt ^ np.uint32(SALT_SENT_HI)
            )
    return int(h)


def pack_seen_np(member: np.ndarray, num_words: int) -> np.ndarray:
    """(n, slots) bool membership -> (n, num_words) uint32 packed words,
    matching ops/bitmask.py's contract (slot s -> word s // 32, bit
    s % 32) — how host code rebuilds the engines' seen layout."""
    n, slots = member.shape
    out = np.zeros((n, num_words), dtype=np.uint32)
    for s in range(slots):
        if member[:, s].any():
            out[:, s // 32] |= (
                member[:, s].astype(np.uint32) << np.uint32(s % 32)
            )
    return out


# --- stream emission -----------------------------------------------------------

def emit_digest(kernel: str, ring, *, t0: int, ticks: int, **provenance):
    """Emit one harvested digest ring as a ``digest`` event: rows
    [t0, t0+ticks) of the (capacity,) ring (a device tensor or a host
    array of int32 bit patterns, emitted as uint32 values), the JAX
    package's slicing. No-op when device rings are disabled. ``ticks`` is
    the executed-tick count (a run that stops at quiescence never wrote
    the rows past it)."""
    if not sink.rings_enabled():
        return
    if isinstance(ring, torch.Tensor):
        ring = ring.cpu().numpy()
    values = np.asarray(ring).astype(np.int64)[
        int(t0) : int(t0) + max(int(ticks), 0)
    ] & _U32
    event = {
        "type": "digest",
        "kernel": kernel,
        "t0": int(t0),
        "ticks": int(values.shape[0]),
        "values": [int(v) for v in values],
    }
    for key, val in provenance.items():
        if val is not None:
            event[key] = val
    sink.emit(event)
