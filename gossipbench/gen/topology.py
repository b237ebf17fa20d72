"""Graph generators of the benchmark: frozen NumPy copies of the program's
builders, so that a later change to the program cannot move the graphs a
cell runs on.

Both return the raw edge list, ``(m, 2)`` int64, before deduplication:
the benchmark hands the same list to the program (which builds its own
CSR from it) and to the plain reference.

- `erdos_renyi`: G(n, p) as the NS-3 reference's ``CreateRandomTopology``
  samples it (p2pnetwork.cc:62-84): upper-triangle Bernoulli(p), then its
  connectivity fix (a row with no edge to a higher node gets an edge to
  the node before it). Dense sampling up to 4,096 nodes, per-row binomial
  counts above (the same distribution).
- `barabasi_albert`: preferential attachment (Barabási and Albert,
  Science 286, 1999), m edges a new node, nodes attached in batches that
  grow with the graph (a 64th of the nodes so far), so that a batch's
  frozen weights move the degrees by under 2%: the hubs follow BA's
  m * sqrt(N / i) law as attaching one node at a time does.

With the same seed `erdos_renyi` gives the edges of the program's
``models.topology.erdos_renyi`` draw for draw. The program's
``barabasi_albert`` attaches 1,024 nodes a batch from the start, which
puts ~3,072 edges on the m + 1 seed nodes; this copy does not follow it.
"""

from __future__ import annotations

import numpy as np

_DENSE_ER_LIMIT = 4096


def forced_edges(n: int, has_upper_edge: np.ndarray) -> np.ndarray:
    """The reference's connectivity fix (p2pnetwork.cc:81-84): rows with no
    sampled edge to any j > i get an edge to i-1 (row 0: (0, 1))."""
    out = []
    for i in np.flatnonzero(~has_upper_edge):
        if i == 0:
            if n > 1:
                out.append((0, 1))
        else:
            out.append((i - 1, i))
    return np.array(out, dtype=np.int64).reshape(-1, 2)


def erdos_renyi(n: int, p: float, seed) -> np.ndarray:
    """Edge list of G(n, p) with the reference's connectivity fix."""
    if n <= 0:
        raise ValueError("n must be positive")
    rng = np.random.default_rng(seed)
    if n <= _DENSE_ER_LIMIT:
        tri = np.triu(rng.random((n, n)) < p, k=1)
        src, dst = np.nonzero(tri)
        has_upper = tri.any(axis=1)
        edges = np.stack([src, dst], axis=1).astype(np.int64)
    else:
        counts = rng.binomial(np.maximum(n - 1 - np.arange(n), 0), p)
        has_upper = counts > 0
        srcs, dsts = [], []
        for i in np.flatnonzero(counts):
            k = counts[i]
            cols = rng.choice(n - 1 - i, size=k, replace=False) + i + 1
            srcs.append(np.full(k, i, dtype=np.int64))
            dsts.append(cols.astype(np.int64))
        edges = (
            np.stack([np.concatenate(srcs), np.concatenate(dsts)], axis=1)
            if srcs
            else np.zeros((0, 2), dtype=np.int64)
        )
    return np.concatenate([edges, forced_edges(n, has_upper)], axis=0)


def barabasi_albert(n: int, m: int, seed, batch_divisor: int = 64) -> np.ndarray:
    """Edge list of a Barabási–Albert graph: a ring of m + 1 seed nodes,
    then each new node draws m targets from the degree-weighted endpoint
    pool (duplicate targets collapse when the list is deduplicated). Nodes
    attach ``max(1, nodes so far // batch_divisor)`` at a time."""
    if n <= m:
        raise ValueError("n must exceed m")
    rng = np.random.default_rng(seed)
    seed_nodes = np.arange(m + 1)
    edges = [np.stack([seed_nodes, np.roll(seed_nodes, -1)], axis=1)]
    pool = np.empty(2 * ((m + 1) + m * (n - m - 1)), dtype=np.int64)
    fill = 2 * (m + 1)
    pool[:fill] = edges[0].ravel()
    next_node = m + 1
    while next_node < n:
        b = min(max(1, next_node // batch_divisor), n - next_node)
        new_nodes = np.arange(next_node, next_node + b)
        targets = pool[rng.integers(0, fill, size=(b, m))]
        batch_edges = np.stack([np.repeat(new_nodes, m), targets.ravel()], axis=1)
        edges.append(batch_edges)
        pool[fill: fill + 2 * b * m] = batch_edges.ravel()
        fill += 2 * b * m
        next_node += b
    return np.concatenate(edges, axis=0).astype(np.int64)


FAMILIES = {  # family -> (keys of its graph block, generator)
    "erdos_renyi": ({"n", "p"}, lambda g, seed: erdos_renyi(int(g["n"]), float(g["p"]), seed)),
    "barabasi_albert": ({"n", "m", "batch_divisor"}, lambda g, seed: barabasi_albert(
        int(g["n"]), int(g["m"]), seed, int(g["batch_divisor"]))),
}


def edges_of(graph_spec: dict, seed) -> np.ndarray:
    """The edge list of a configuration's ``graph`` block, which holds its
    family's keys and no others."""
    keys, make = FAMILIES[graph_spec["family"]]
    given = set(graph_spec) - {"family"}
    if given != keys:
        raise ValueError(f"graph {graph_spec['family']}: keys {sorted(given)}, want {sorted(keys)}")
    return make(graph_spec, seed)
