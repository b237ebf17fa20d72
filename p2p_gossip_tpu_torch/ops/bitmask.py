"""Bitmask frontier primitives.

The reference's per-node ``processedShares`` set (p2pnode.h:38) becomes a
dense (nodes x shares) bitmask packed into 32-bit words: share slot ``s``
lives at word ``s // 32``, bit ``s % 32``. Words are torch.int32 holding
the uint32 bit pattern; numpy sees them through ``.view(np.uint32)``.
"""

from __future__ import annotations

import torch

from p2p_gossip_tpu_torch.ops import kernels
from p2p_gossip_tpu_torch.ops.kernels import WORD_BITS

__all__ = [
    "WORD_BITS", "num_words", "popcount_rows", "coverage_per_slot",
    "slot_scatter",
]


def num_words(num_shares: int) -> int:
    return (num_shares + WORD_BITS - 1) // WORD_BITS


def popcount_rows(
    words: torch.Tensor, *, out: torch.Tensor | None = None, plain: bool = False
) -> torch.Tensor:
    """Per-row set-bit count: (N, W) -> (N,) int32 — the number of shares
    each node newly processed this tick (p2pnode.cc:157-163); written into
    ``out`` when given."""
    return kernels.popcount_rows(words, out=out, plain=plain)


def coverage_per_slot(
    words: torch.Tensor, n_slots: int, *, plain: bool = False
) -> torch.Tensor:
    """Per-share coverage: (N, W) bitmask -> (n_slots,) int32 node counts,
    the time-to-99%-coverage metric's per-tick reduction; B replicas'
    (B, N, W) -> (B, n_slots)."""
    return kernels.coverage_per_slot(words, n_slots, plain=plain)


def slot_scatter(
    n_nodes: int,
    n_words: int,
    rows: torch.Tensor,
    slots: torch.Tensor,
    active: torch.Tensor,
) -> torch.Tensor:
    """Scatter share slots into a fresh (N, W) int32 bitmask.

    ``rows[s]`` is the node, ``slots[s]`` the share slot, ``active[s]``
    whether the event fires (`GenerateAndGossipShare`'s seen-set insert,
    p2pnode.cc:120). Distinct slots are distinct bits, so a scatter-add is
    a scatter-OR — bit 31 included, added as -2**31 in two's complement.
    Rows outside ``[0, n_nodes)`` are dropped, never wrapped."""
    rows = rows.to(torch.int64)
    slots = slots.to(torch.int64)
    keep = active & (rows >= 0) & (rows < n_nodes)
    bit = slots % WORD_BITS
    # 1 << bit as the int32 bit pattern: bit 31 is -2**31.
    vals = torch.where(bit == WORD_BITS - 1, -(1 << 31), 1 << bit)
    vals = torch.where(keep, vals, 0).to(torch.int32)
    flat = torch.where(keep, rows * n_words + slots // WORD_BITS, 0)
    out = torch.zeros((n_nodes * n_words,), dtype=torch.int32, device=rows.device)
    out.index_add_(0, flat, vals)
    return out.view(n_nodes, n_words)


# --- audit specs (staticcheck/: the op audit runs these tiny cases) ---------

def _audit_spec(kind: str):
    """N = 8 rows, W = 2 words (the JAX package's ``_audit_spec``)."""
    import numpy as np

    from p2p_gossip_tpu_torch.staticcheck import specs
    from p2p_gossip_tpu_torch.staticcheck.registry import AuditSpec

    n, w = 8, 2
    rng = np.random.default_rng(0)
    if kind == "cov":
        return AuditSpec(fn=lambda seen: coverage_per_slot(seen, w * WORD_BITS - 3),
                         args=(specs.words(rng, (n, w)),), integer_only=True,
                         bitmask_words=w, bitmask_args=(0,), out_dtypes=("int32",),
                         counterpart_outputs=(0,))
    s = w * WORD_BITS
    return AuditSpec(
        fn=lambda rows, slots, active: slot_scatter(n, w, rows, slots, active),
        args=(specs.tensor(rng.integers(0, n, s), np.int32),
              specs.tensor(np.arange(s), np.int32), specs.tensor(rng.random(s) < 0.5)),
        integer_only=True, bitmask_words=w, bitmask_outputs=(0,), out_dtypes=("int32",),
        counterpart_outputs=(0,),
    )


from p2p_gossip_tpu_torch.staticcheck.registry import register_entry  # noqa: E402

register_entry("ops.bitmask.coverage_per_slot", coverage_per_slot,
               spec=lambda: _audit_spec("cov"), counterpart="ops.bitmask.coverage_per_slot")
register_entry("ops.bitmask.slot_scatter", slot_scatter, spec=lambda: _audit_spec("scatter"),
               counterpart="ops.bitmask.slot_scatter")
