"""Gossip-as-a-service: a continuous-batching simulation server (the JAX
package's ``serve`` on one device).

Layout: `request` (the JSON-serializable request model + static
signature, numpy-only), `scheduler` (slot bin-packing + modeled-cost
admission control, host-only), `server` (the in-process queue + dispatch
loop onto the port's campaign runners), `bench` (a mixed trace through
one server, verified against solo campaigns: ``python -m
p2p_gossip_tpu_torch.serve.bench``).
"""

from p2p_gossip_tpu_torch.serve.request import (  # noqa: F401
    PROTOCOLS,
    TOPOLOGY_FAMILIES,
    SimRequest,
    build_graph,
    topology_fingerprint,
    validate_request,
)
from p2p_gossip_tpu_torch.serve.scheduler import (  # noqa: F401
    BatchPlan,
    SlotScheduler,
    SlotUnit,
    modeled_request_cost,
)

__all__ = [
    "PROTOCOLS",
    "TOPOLOGY_FAMILIES",
    "SimRequest",
    "build_graph",
    "topology_fingerprint",
    "validate_request",
    "BatchPlan",
    "SlotScheduler",
    "SlotUnit",
    "modeled_request_cost",
    "GossipServer",
]


def __getattr__(name):
    # GossipServer pulls in the campaign stack (torch); keep `import
    # p2p_gossip_tpu_torch.serve` light for clients that only build
    # requests.
    if name == "GossipServer":
        from p2p_gossip_tpu_torch.serve.server import GossipServer

        return GossipServer
    raise AttributeError(name)
