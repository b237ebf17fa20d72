"""Per-edge latency models (host-side numpy).

The reference gives every point-to-point link one constant delay
(`ConnectNodes`, p2pnetwork.cc:110-130). The tick engine works in integer
ticks: each edge carries a delay in [1, max_delay], laid out in ELL order
aligned with ``Graph.ell()``, so the gather reads ``hist[(t - d) % D,
src]`` from a ring of past frontiers.
"""

from __future__ import annotations

import numpy as np

from p2p_gossip_tpu_torch.models.topology import Graph


def constant_delays(graph: Graph, ticks: int = 1) -> np.ndarray:
    """Every edge has the same integer-tick delay (reference default)."""
    if ticks < 1:
        raise ValueError("delays must be >= 1 tick")
    return np.full((graph.n, graph.ell_width), ticks, dtype=np.int32)


def _symmetrize_edge_values(graph: Graph, undirected_vals: np.ndarray) -> np.ndarray:
    """Expand per-undirected-edge values to ELL layout (same value in both
    directions): each directed CSR entry is keyed by its canonical (min,
    max) pair and looked up in the sorted undirected edge list."""
    edges = graph.edges()
    n = graph.n
    edge_keys = edges[:, 0].astype(np.int64) * n + edges[:, 1].astype(np.int64)
    rows, pos = graph.csr_rows_pos()
    cols = graph.indices.astype(np.int64)
    keys = np.minimum(rows, cols) * n + np.maximum(rows, cols)
    vals = np.asarray(undirected_vals)[np.searchsorted(edge_keys, keys)]
    out = np.ones((n, graph.ell_width), dtype=np.int32)
    out[rows, pos] = vals
    return out


def lognormal_delays(
    graph: Graph,
    mean_ticks: float = 2.0,
    sigma: float = 0.5,
    max_ticks: int = 8,
    seed: int = 0,
) -> np.ndarray:
    """Log-normal per-edge delays in integer ticks, clipped to [1,
    max_ticks], symmetric per link."""
    rng = np.random.default_rng(seed)
    m = graph.num_edges
    mu = np.log(mean_ticks) - 0.5 * sigma**2
    vals = np.clip(
        np.round(rng.lognormal(mu, sigma, size=m)), 1, max_ticks
    ).astype(np.int32)
    return _symmetrize_edge_values(graph, vals)


def serialization_delays(
    graph: Graph,
    *,
    latency_ticks: int = 1,
    message_bytes: int = 30,
    bandwidth_mbps: float = 5.0,
    tick_dt: float = 0.005,
) -> np.ndarray:
    """Latency plus the per-hop serialization time of an S-byte message on
    the reference's point-to-point links (5 Mbps, p2pnetwork.cc:113): the
    combined time (latency + S*8/bandwidth) rounded half-up to whole ticks,
    floored at 1. The reference's ~30-byte shares at 5 Mbps on 5 ms ticks
    stay at 1 tick a hop; larger payloads or slower links add whole ticks.
    Each message is charged on its own (no per-link queue). Uniform across
    edges, so the uniform-delay path applies."""
    if latency_ticks < 1:
        raise ValueError("latency_ticks must be >= 1")
    if message_bytes < 0:
        raise ValueError("message_bytes must be >= 0")
    if bandwidth_mbps <= 0 or tick_dt <= 0:
        raise ValueError("bandwidth_mbps and tick_dt must be > 0")
    ser_s = message_bytes * 8 / (bandwidth_mbps * 1e6)
    total_s = latency_ticks * tick_dt + ser_s
    # floor(x + 0.5): half-up, immune to float banker's rounding.
    ticks = max(1, int(np.floor(total_s / tick_dt + 0.5)))
    return np.full((graph.n, graph.ell_width), ticks, dtype=np.int32)
