"""Per-link message-loss model, deterministic in its seed.

Each directed link (src -> dst) suffers an erasure at a given arrival tick
with probability ``prob``, dropping every message crossing it that tick.
The sender still counts its sends (loss happens in flight); ``received``
counts only successful first-time deliveries.

The coin is a counter-based hash of the directed edge, the arrival tick
and the seed, the JAX package's spec (its ``models/linkloss.py``), so both
packages drop the same messages:

    h0   = seed ^ (src * 0x9E3779B1) ^ (dst * 0x85EBCA77) ^ (t * 0xC2B2AE3D)
    h    = mix32(h0)  where  mix32: h ^= h>>16; h *= 0x7FEB352D;
                              h ^= h>>15; h *= 0x846CA68B; h ^= h>>16
    drop iff h <= threshold - 1   (all mod 2^32; threshold = round(prob *
                                   2^32); 0 = off, 2^32 drops everything)

On the GPU the gather kernel computes the coin edge by edge
(`ops.kernels.gather_or`); `drop_mask_torch` is its plain version.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

_C_SRC = 0x9E3779B1
_C_DST = 0x85EBCA77
_C_TICK = 0xC2B2AE3D
_M1 = 0x7FEB352D
_M2 = 0x846CA68B
_MASK = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class LinkLossModel:
    """Directed-link erasure model: ``prob`` in [0, 1], deterministic in
    ``seed``. ``threshold`` is the uint32 acceptance bound of the spec
    above (0 disables; 2^32 drops everything)."""

    prob: float
    seed: int = 0

    def __post_init__(self):
        if not 0.0 <= self.prob <= 1.0:
            raise ValueError(f"loss prob must be in [0, 1], got {self.prob}")

    @property
    def threshold(self) -> int:
        return int(round(self.prob * (1 << 32)))

    @property
    def static_cfg(self) -> tuple:
        """The (threshold, seed) pair the gather ops take as ``loss``."""
        return (self.threshold, self.seed)


def drop_mask_np(src, dst, tick, threshold: int, seed: int) -> np.ndarray:
    """Reference (numpy) evaluation of the spec; shapes broadcast."""
    h = (
        np.uint64(seed & _MASK)
        ^ (np.asarray(src, np.uint64) * np.uint64(_C_SRC))
        ^ (np.asarray(dst, np.uint64) * np.uint64(_C_DST))
        ^ (np.asarray(tick, np.uint64) * np.uint64(_C_TICK))
    ) & np.uint64(_MASK)
    h ^= h >> np.uint64(16)
    h = (h * np.uint64(_M1)) & np.uint64(_MASK)
    h ^= h >> np.uint64(15)
    h = (h * np.uint64(_M2)) & np.uint64(_MASK)
    h ^= h >> np.uint64(16)
    if threshold <= 0:
        return np.zeros(h.shape, dtype=bool)
    return h <= np.uint64(threshold - 1)


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2^32 for int64 ``h`` in [0, 2^32): the constant is split
    in 16-bit halves so no int64 product overflows."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def drop_mask_torch(src, dst, tick, threshold: int, seed) -> torch.Tensor:
    """The coin in torch, bit for bit `drop_mask_np`; shapes broadcast.
    ``seed`` is an int, or a tensor of seeds (each read as its uint32 bit
    pattern) that broadcasts with the edges: a campaign's one seed per
    replica.

    torch's uint32 is not usable on the CPU and int32 ``>>`` sign-extends,
    so the hash runs in int64 on values masked to 32 bits: after every
    multiply and before every shift, and the unsigned compare is an int64
    compare of values in [0, 2^32)."""
    src = torch.as_tensor(src)
    dst = torch.as_tensor(dst, device=src.device)
    tick = torch.as_tensor(tick, device=src.device)

    def u32(x):
        return x.to(torch.int64) & _MASK

    h = (
        (u32(seed) if isinstance(seed, torch.Tensor) else int(seed) & _MASK)
        ^ _mul32(u32(src), _C_SRC)
        ^ _mul32(u32(dst), _C_DST)
        ^ _mul32(u32(tick), _C_TICK)
    )
    h = h ^ (h >> 16)
    h = _mul32(h, _M1)
    h = h ^ (h >> 15)
    h = _mul32(h, _M2)
    h = h ^ (h >> 16)
    if threshold <= 0:
        return torch.zeros(h.shape, dtype=torch.bool, device=h.device)
    return h <= min(int(threshold), 1 << 32) - 1
