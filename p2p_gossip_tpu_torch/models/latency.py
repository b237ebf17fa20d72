"""Per-edge latency models (host-side numpy).

The reference gives every point-to-point link one constant delay
(`ConnectNodes`, p2pnetwork.cc:110-130). The tick engine works in integer
ticks: each edge carries a delay in [1, max_delay], laid out in ELL order
aligned with ``Graph.ell()`` for the flood, so the gather reads ``hist[(t
- d) % D, src]`` from a ring of past frontiers, or one per CSR entry for
the random-partner protocols (`lognormal_edge_delays`), whose picks index
the CSR row.
"""

from __future__ import annotations

import numpy as np

from p2p_gossip_tpu_torch.models.topology import Graph


def constant_delays(graph: Graph, ticks: int = 1) -> np.ndarray:
    """Every edge has the same integer-tick delay (reference default)."""
    if ticks < 1:
        raise ValueError("delays must be >= 1 tick")
    return np.full((graph.n, graph.ell_width), ticks, dtype=np.int32)


def _csr_edge_values(graph: Graph, undirected_vals: np.ndarray) -> np.ndarray:
    """Per-undirected-edge values (in ``graph.edges()``' order) as one value
    per CSR entry, the same in both directions of a link: each directed
    entry is keyed by its canonical (min, max) pair and looked up in the
    sorted undirected edge list."""
    edges = graph.edges()
    n = graph.n
    edge_keys = edges[:, 0].astype(np.int64) * n + edges[:, 1].astype(np.int64)
    rows, _ = graph.csr_rows_pos()
    cols = graph.indices.astype(np.int64)
    keys = np.minimum(rows, cols) * n + np.maximum(rows, cols)
    return np.asarray(undirected_vals)[np.searchsorted(edge_keys, keys)]


def ell_from_edge_delays(graph: Graph, edge_delays: np.ndarray) -> np.ndarray:
    """Per-CSR-entry delays in the (N, dmax) ELL layout of ``Graph.ell()``,
    padding 1."""
    rows, pos = graph.csr_rows_pos()
    out = np.ones((graph.n, graph.ell_width), dtype=np.int32)
    out[rows, pos] = edge_delays
    return out


def lognormal_edge_delays(
    graph: Graph,
    mean_ticks: float = 2.0,
    sigma: float = 0.5,
    max_ticks: int = 8,
    seed: int = 0,
) -> np.ndarray:
    """Log-normal per-edge delays in integer ticks, clipped to [1,
    max_ticks], symmetric per link: one int32 per CSR entry, in
    ``graph.indices``' order (the form the random-partner protocols
    stage; no (N, dmax) array is built). One draw per undirected edge, in
    ``graph.edges()``' order."""
    rng = np.random.default_rng(seed)
    m = graph.num_edges
    mu = np.log(mean_ticks) - 0.5 * sigma**2
    vals = np.clip(
        np.round(rng.lognormal(mu, sigma, size=m)), 1, max_ticks
    ).astype(np.int32)
    return _csr_edge_values(graph, vals)


def lognormal_delays(
    graph: Graph,
    mean_ticks: float = 2.0,
    sigma: float = 0.5,
    max_ticks: int = 8,
    seed: int = 0,
) -> np.ndarray:
    """`lognormal_edge_delays` in the (N, dmax) ELL layout (padding 1), the
    form the flood's callers take."""
    return ell_from_edge_delays(
        graph, lognormal_edge_delays(graph, mean_ticks, sigma, max_ticks, seed)
    )


def serialization_ticks(
    *,
    latency_ticks: int = 1,
    message_bytes: int = 30,
    bandwidth_mbps: float = 5.0,
    tick_dt: float = 0.005,
) -> int:
    """Latency plus the per-hop serialization time of an S-byte message on
    the reference's point-to-point links (5 Mbps, p2pnetwork.cc:113): the
    combined time (latency + S*8/bandwidth) rounded half-up to whole ticks,
    floored at 1. The reference's ~30-byte shares at 5 Mbps on 5 ms ticks
    stay at 1 tick a hop; larger payloads or slower links add whole ticks.
    Each message is charged on its own (no per-link queue)."""
    if latency_ticks < 1:
        raise ValueError("latency_ticks must be >= 1")
    if message_bytes < 0:
        raise ValueError("message_bytes must be >= 0")
    if bandwidth_mbps <= 0 or tick_dt <= 0:
        raise ValueError("bandwidth_mbps and tick_dt must be > 0")
    ser_s = message_bytes * 8 / (bandwidth_mbps * 1e6)
    total_s = latency_ticks * tick_dt + ser_s
    # floor(x + 0.5): half-up, immune to float banker's rounding.
    return max(1, int(np.floor(total_s / tick_dt + 0.5)))


def serialization_delays(graph: Graph, **link) -> np.ndarray:
    """`serialization_ticks` of the ``link`` (its keyword arguments) on
    every edge, in the (N, dmax) ELL layout. Uniform across edges, so the
    uniform-delay path applies."""
    return np.full((graph.n, graph.ell_width), serialization_ticks(**link), dtype=np.int32)


#: Sub-tick time unit of the FIFO link model: all queue arithmetic is in
#: integer micro-ticks (1e-6 tick), so the event engine and the C++ engine
#: compute the same arrival ticks.
MICROTICKS = 1_000_000


class FifoLinkModel:
    """Opt-in FIFO link queueing for the event engines (the reference's
    NS-3 DataRate queue on each 5 Mbps link, p2pnetwork.cc:113).

    Each directed link carries a ``busy_until`` time in integer
    micro-ticks; a message sent at tick ``t`` starts at ``max(t,
    busy_until)``, holds the link for ``ser_micro`` micro-ticks and arrives
    its propagation latency after its last bit leaves, rounded half-up to
    a whole tick and floored at ``t + 1`` (the quantization of
    `serialization_delays`, so an uncontended run equals the closed-form
    per-message path). All broadcasts of one tick are enqueued in
    ascending (node, share), the order the C++ engine uses too."""

    __slots__ = ("ser_micro",)

    def __init__(self, ser_micro: int):
        if ser_micro < 0:
            raise ValueError("ser_micro must be >= 0")
        self.ser_micro = int(ser_micro)


def fifo_link_model(
    message_bytes: int = 30,
    bandwidth_mbps: float = 5.0,
    tick_dt: float = 0.005,
) -> FifoLinkModel:
    """`FifoLinkModel` from the physical link: serialization time
    S*8/bandwidth in integer micro-ticks (half-up). The reference's 30 B at
    5 Mbps on 5 ms ticks give 9,600 micro-ticks, 0.0096 of a tick."""
    if message_bytes < 0:
        raise ValueError("message_bytes must be >= 0")
    if bandwidth_mbps <= 0 or tick_dt <= 0:
        raise ValueError("bandwidth_mbps and tick_dt must be > 0")
    ser_ticks = message_bytes * 8 / (bandwidth_mbps * 1e6) / tick_dt
    return FifoLinkModel(int(np.floor(ser_ticks * MICROTICKS + 0.5)))


def max_delay(ell_delays: np.ndarray) -> int:
    return int(ell_delays.max()) if ell_delays.size else 1
