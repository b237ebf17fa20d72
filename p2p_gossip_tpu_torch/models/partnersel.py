"""Counter-based random partner selection, deterministic across engines.

The random-partner protocols (push-pull and pull anti-entropy, fanout
push; `models.protocols`) need "node n picks a uniform-random neighbour at
round t". The pick is a pure counter-based hash, the JAX package's spec
(its ``models/partnersel.py``), so both packages pick the same partners
from the same seed:

    h(node, t, j)   = mix32(seed ^ node*C_NODE ^ t*C_TICK ^ j*C_PICK)
    pick(node,t,j)  = h % max(degree(node), 1)   # index into the sorted
                                                  # neighbour row (CSR/ELL)

with ``j`` the pick slot (0 for push-pull's one partner, 0..k-1 for fanout
k), mix32 the splitmix32 finalizer and all arithmetic mod 2^32.
"""

from __future__ import annotations

import numpy as np
import torch

from p2p_gossip_tpu_torch.models.linkloss import _mul32

_C_NODE = 0x9E3779B1
_C_TICK = 0x85EBCA77
_C_PICK = 0xC2B2AE3D
_M1 = 0x7FEB352D
_M2 = 0x846CA68B
_MASK = 0xFFFFFFFF


def pick_index_np(node, tick, pick, degree, seed: int) -> np.ndarray:
    """Reference (numpy) evaluation: neighbour-slot index in [0, degree).
    Shapes broadcast; degree 0 yields 0 (callers gate empty rows)."""
    h = (
        np.uint64(seed & _MASK)
        ^ (np.asarray(node, np.uint64) * np.uint64(_C_NODE))
        ^ (np.asarray(tick, np.uint64) * np.uint64(_C_TICK))
        ^ (np.asarray(pick, np.uint64) * np.uint64(_C_PICK))
    ) & np.uint64(_MASK)
    h ^= h >> np.uint64(16)
    h = (h * np.uint64(_M1)) & np.uint64(_MASK)
    h ^= h >> np.uint64(15)
    h = (h * np.uint64(_M2)) & np.uint64(_MASK)
    h ^= h >> np.uint64(16)
    deg = np.maximum(np.asarray(degree, np.uint64), 1)
    return (h % deg).astype(np.int64)


def _term(x, c: int):
    """(x * c) mod 2^32 of one hash input: Python arithmetic for an int,
    the int64 16-bit-split multiply for a tensor."""
    if isinstance(x, int):
        return (x & _MASK) * c & _MASK
    return _mul32(x.to(torch.int64) & _MASK, c)


def pick_key(node, pick, seed):
    """The tick-free part of the hash input, ``seed ^ node*C_NODE ^
    pick*C_PICK`` mod 2^32: a round loop computes it once per chunk and
    hands it to `pick_from_key` every round. ``seed`` is an int, or a
    tensor of seeds (uint32 bit patterns) that broadcasts with ``node``: a
    campaign's one partner stream per replica."""
    if isinstance(seed, torch.Tensor):
        seed = seed.to(torch.int64) & _MASK
    else:
        seed = int(seed) & _MASK
    return seed ^ _term(node, _C_NODE) ^ _term(pick, _C_PICK)


def pick_from_key(key, tick, degree) -> torch.Tensor:
    """The pick from a `pick_key`: mix32(key ^ tick*C_TICK) % max(degree,
    1), int64 in the broadcast shape."""
    h = key ^ _term(tick, _C_TICK)
    if isinstance(h, int):
        raise TypeError("node, tick or pick must be a tensor")
    h = h ^ (h >> 16)
    h = _mul32(h, _M1)
    h = h ^ (h >> 15)
    h = _mul32(h, _M2)
    h = h ^ (h >> 16)
    deg = torch.as_tensor(degree, device=h.device).to(torch.int64).clamp_min(1)
    return h % deg


def pick_index_torch(node, tick, pick, degree, seed: int) -> torch.Tensor:
    """The pick in torch, bit for bit `pick_index_np`: (broadcast shape)
    int64 indices in [0, max(degree, 1)).

    ``node``, ``tick`` and ``pick`` are tensors or Python ints (at least
    one a tensor). torch's uint32 is not usable on the CPU and int32
    ``>>`` sign-extends, so the hash runs in int64 on values in [0, 2^32),
    masked after every multiply (`models.linkloss._mul32`), and the
    unsigned modulo is an int64 ``%`` of such a value by ``max(degree,
    1)``."""
    return pick_from_key(pick_key(node, pick, seed), tick, degree)
