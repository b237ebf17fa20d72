"""Tiny operands for the audit specs the engine modules register.

The engine modules build their specs from these (imported inside each
spec builder, never at module import), on the device the audit targets
(`registry.audit_device`). The shapes are the JAX package's audit shapes
(``p2p_gossip_tpu/engine/sync.py`` ``_audit_inputs``,
``models/protocols.py`` ``_audit_inputs_partnered``, the sharded
runners' 16-node graph): the same graphs, schedules and chunk widths.
"""

from __future__ import annotations

import numpy as np
import torch

from p2p_gossip_tpu_torch.staticcheck import registry


def device() -> torch.device:
    return torch.device(registry.audit_device())


def tensor(a, dtype=None) -> torch.Tensor:
    """A host array on the audit's device."""
    return torch.as_tensor(np.ascontiguousarray(a, dtype=dtype), device=device())


def words(rng, shape) -> torch.Tensor:
    """Random bitmask words: int32 tensors holding uint32 bits."""
    bits = rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)
    return tensor(bits.view(np.int32))


def flood_inputs(chunk: int = 32, horizon: int = 16):
    """The flood engine's tiny case: ER(48, 0.2) staged full-width, four
    shares at nodes 0, 7, 14, 21 on ticks 0, 1, 2, 0, padded to ``chunk``.
    Returns (DeviceGraph, origins (S,) int64, gen_ticks (S,) int32, last
    live generation tick)."""
    from p2p_gossip_tpu_torch.engine.sync import DeviceGraph
    from p2p_gossip_tpu_torch.models.generation import Schedule
    from p2p_gossip_tpu_torch.models.topology import erdos_renyi

    graph = erdos_renyi(48, 0.2, seed=0)
    dg = DeviceGraph.build(graph, device=device())
    sched = Schedule(graph.n, np.arange(4, dtype=np.int32) * 7 % graph.n,
                     np.arange(4, dtype=np.int32) % 3)
    origins, gen_ticks = sched.padded(chunk, horizon)
    return dg, tensor(origins, np.int64), tensor(gen_ticks, np.int32), 2


def partnered_inputs(chunk: int = 32, horizon: int = 8):
    """The protocols' tiny case: ER(48, 0.2) staged as its CSR, four
    shares at nodes 0, 5, 10, 15 on tick 0. Returns (PartnerGraph,
    origins, gen_ticks) with the schedule as host arrays (the round loop
    stages its own events)."""
    from p2p_gossip_tpu_torch.models.generation import Schedule
    from p2p_gossip_tpu_torch.models.protocols import PartnerGraph
    from p2p_gossip_tpu_torch.models.topology import erdos_renyi

    graph = erdos_renyi(48, 0.2, seed=0)
    dg = PartnerGraph.build(graph, device=device())
    sched = Schedule(graph.n, np.arange(4, dtype=np.int32) * 5 % graph.n,
                     np.zeros(4, dtype=np.int32))
    origins, gen_ticks = sched.padded(chunk, horizon)
    return dg, origins, gen_ticks


def sharded_graph():
    """The sharded runners' tiny graph: ER(16, 0.3)."""
    from p2p_gossip_tpu_torch.models.topology import erdos_renyi

    return erdos_renyi(16, 0.3, seed=0)
