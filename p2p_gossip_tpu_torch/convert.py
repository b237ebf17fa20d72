"""Carry state across from the JAX package: bitmasks and staged graphs.

Bitmasks are uint32 words in numpy and JAX and int32 tensors here; every
crossing reinterprets the bits (``.view``), never converts values, so bit
31 survives both ways.
"""

from __future__ import annotations

import numpy as np
import torch

from p2p_gossip_tpu_torch.engine.sync import DeviceGraph
from p2p_gossip_tpu_torch.utils.device import resolve_device


def bitmask_to_torch(words) -> torch.Tensor:
    """uint32 (or int32) words -> int32 CPU tensor with the same bits."""
    arr = np.ascontiguousarray(np.asarray(words))
    if arr.dtype == np.uint32:
        arr = arr.view(np.int32)
    if arr.dtype != np.int32:
        raise TypeError(f"bitmask words must be uint32 or int32, got {arr.dtype}")
    return torch.from_numpy(arr.copy())


def bitmask_to_numpy(words: torch.Tensor) -> np.ndarray:
    """int32 tensor -> uint32 numpy array with the same bits."""
    if words.dtype != torch.int32:
        raise TypeError(f"bitmask tensor must be int32, got {words.dtype}")
    return words.detach().cpu().numpy().view(np.uint32)


def device_graph_from_numpy(
    n, ell_idx, ell_delay, ell_mask, degree, ring_size,
    uniform_delay=None, buckets=None, *, device=None,
) -> DeviceGraph:
    """The port's DeviceGraph from the JAX ``DeviceGraph``'s fields, each
    array taken with ``np.asarray`` (bucket tuples included), so both
    engines run on the identical staging. ``device`` as in the entry
    points (None means CUDA)."""
    return DeviceGraph.from_numpy(
        n, ell_idx, ell_delay, ell_mask, degree, ring_size, uniform_delay,
        buckets, device=resolve_device(device),
    )
