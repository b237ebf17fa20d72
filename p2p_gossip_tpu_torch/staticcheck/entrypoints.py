"""Populate the audit registry: import every module that registers.

The port's counterpart of ``p2p_gossip_tpu/staticcheck/entrypoints.py``.
The registry is filled by import side effects (``audited`` and
module-bottom ``register_entry`` calls), so the analyzers import the
registering modules first; a module added here is audited by default.

``UNPORTED`` is the other half of the map from the JAX package's audit
names: a JAX entry with no callable of its own in the port, with the
reason. Every other JAX name is some port entry's ``counterpart``.
"""

from __future__ import annotations

#: JAX audit names served by no separate port callable, and why.
UNPORTED = {
    "ops.bitmask.coverage_per_slot_scan":
        "the JAX scan form of coverage_per_slot (a TPU lowering choice); the port has "
        "one coverage_per_slot, its kernel, audited as ops.bitmask.coverage_per_slot",
    "ops.segment.scatter_or_bits":
        "the JAX bit-unpack form of scatter_or (same bits, other XLA cost); the port "
        "has one scatter_or entry point, audited as ops.segment.scatter_or",
    "parallel.exchange.compress_deltas[aggregate]":
        "aggregate picks JAX's XLA scatter layout (bitwise the same buffers); the "
        "port's compress_deltas kernel writes the destination-major buffers in one "
        "pass, audited as ops.kernels.compress_deltas",
}


def load_all() -> None:
    """Import every registering module (idempotent)."""
    import p2p_gossip_tpu_torch.batch.campaign  # noqa: F401
    import p2p_gossip_tpu_torch.engine.sync  # noqa: F401
    import p2p_gossip_tpu_torch.models.protocols  # noqa: F401
    import p2p_gossip_tpu_torch.ops.bitmask  # noqa: F401
    import p2p_gossip_tpu_torch.ops.ell  # noqa: F401
    import p2p_gossip_tpu_torch.ops.segment  # noqa: F401
    import p2p_gossip_tpu_torch.parallel.engine_sharded  # noqa: F401
    import p2p_gossip_tpu_torch.parallel.exchange  # noqa: F401
    import p2p_gossip_tpu_torch.parallel.protocols_sharded  # noqa: F401


def counterpart_map() -> dict:
    """Every JAX audit name a port entry serves -> the port entries."""
    from p2p_gossip_tpu_torch.staticcheck import registry

    load_all()
    out: dict = {}
    for e in registry.all_entries():
        if e.counterpart is not None:
            out.setdefault(e.counterpart, []).append(e.name)
    return out
