"""Random P2P network topology builders (host-side numpy).

The port's own copy of the JAX package's topology layer, rebuilding the
reference's `CreateRandomTopology` (p2pnetwork.cc:62-96): a builder emits a
symmetric adjacency in CSR plus the ELL (padded dense) form the tick engine
gathers over. With the same seed these builders produce the same graphs as
the reference package's, draw for draw.

Connectivity guarantee parity (p2pnetwork.cc:81-84): any row ``i`` with no
sampled edge to a higher-numbered node gets a forced edge to ``i-1``
(``(0, 1)`` for row 0). Edges are canonicalized and deduplicated.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from p2p_gossip_tpu_torch.telemetry.spans import span

# Dense O(n^2) ER sampling below this size; sparse per-row binomial above.
_DENSE_ER_LIMIT = 4096


@dataclasses.dataclass
class Graph:
    """Undirected graph in CSR + ELL forms (both directions stored)."""

    n: int
    indptr: np.ndarray   # (n+1,) int64 — CSR row pointers (rows = nodes)
    indices: np.ndarray  # (nnz,) int32 — CSR neighbor ids, sorted per row

    def __post_init__(self):
        self.indptr = np.asarray(self.indptr, dtype=np.int64)
        self.indices = np.asarray(self.indices, dtype=np.int32)

    @functools.cached_property
    def degree(self) -> np.ndarray:
        return np.diff(self.indptr).astype(np.int32)

    @property
    def num_edges(self) -> int:
        """Number of undirected edges (nnz / 2)."""
        return int(self.indices.shape[0] // 2)

    @property
    def max_degree(self) -> int:
        return int(self.degree.max()) if self.n else 0

    @property
    def ell_width(self) -> int:
        """The (n, dmax) ELL minor dimension shared by `ell()` and the delay
        builders (models/latency.py), so mask and delay arrays align.
        Minimum 1: one all-masked column is harmless."""
        return max(self.max_degree, 1)

    def csr_rows_pos(self) -> tuple[np.ndarray, np.ndarray]:
        """(rows, pos): for each CSR entry, its row id and its position
        within the row — the coordinate map between CSR and ELL layouts."""
        deg = self.degree
        rows = np.repeat(np.arange(self.n, dtype=np.int64), deg)
        pos = np.arange(self.indices.shape[0], dtype=np.int64) - np.repeat(
            self.indptr[:-1], deg
        )
        return rows, pos

    def ell(self, pad_to: int | None = None) -> tuple[np.ndarray, np.ndarray]:
        """ELL form ``(ell_idx, ell_mask)`` of shape (n, dmax): ``ell_idx[i,
        k]`` is the k-th neighbor of node i (0-padded), ``ell_mask[i, k]``
        marks valid entries."""
        dmax = int(pad_to) if pad_to is not None else self.ell_width
        ell_idx = np.zeros((self.n, dmax), dtype=np.int32)
        ell_mask = np.zeros((self.n, dmax), dtype=bool)
        rows, pos = self.csr_rows_pos()
        ell_idx[rows, pos] = self.indices
        ell_mask[rows, pos] = True
        return ell_idx, ell_mask

    def ell_rows(
        self, rows: np.ndarray, pad_to: int, block_entries: int = 1 << 24
    ) -> tuple[np.ndarray, np.ndarray]:
        """ELL form of a row subset straight from CSR, identical to
        ``self.ell()[...][rows, :pad_to]`` without building the global
        (n, dmax) ELL. Rows are filled a block at a time (about
        ``block_entries`` CSR entries a block), so the int64 index
        temporaries stay a few hundred MB even when the subset holds 10^9
        entries (a million-node ER graph's degree bucket)."""
        rows = np.asarray(rows)
        ell_idx = np.zeros((len(rows), pad_to), dtype=np.int32)
        ell_mask = np.zeros((len(rows), pad_to), dtype=bool)
        deg = self.degree[rows].astype(np.int64)
        ends = np.cumsum(deg)
        lo = 0
        while lo < len(rows):
            base = int(ends[lo - 1]) if lo else 0
            hi = int(np.searchsorted(ends, base + block_entries, side="right"))
            hi = min(max(hi, lo + 1), len(rows))
            d = deg[lo:hi]
            nnz = int(d.sum())
            rep = np.repeat(np.arange(hi - lo, dtype=np.int64), d)
            pos = np.arange(nnz, dtype=np.int64) - np.repeat(np.cumsum(d) - d, d)
            src = self.indices[np.repeat(self.indptr[rows[lo:hi]], d) + pos]
            ell_idx[lo:hi][rep, pos] = src
            ell_mask[lo:hi][rep, pos] = True
            lo = hi
        return ell_idx, ell_mask

    def edges(self) -> np.ndarray:
        """(m, 2) array of undirected edges with src < dst."""
        rows = np.repeat(np.arange(self.n, dtype=np.int64), self.degree)
        mask = rows < self.indices
        return np.stack([rows[mask], self.indices[mask]], axis=1).astype(np.int32)

    def validate(self) -> None:
        """Structural invariants: CSR shape, no isolated node (the
        reference's connectivity guarantee), symmetric adjacency."""
        if self.indptr.shape != (self.n + 1,):
            raise ValueError("indptr has the wrong shape")
        if self.indptr[0] != 0 or self.indptr[-1] != self.indices.shape[0]:
            raise ValueError("indptr does not span indices")
        if not (self.degree >= 1).all():
            raise ValueError("isolated node — connectivity guarantee violated")
        rows, _ = self.csr_rows_pos()
        cols = self.indices.astype(np.int64)
        fwd = np.sort(rows * self.n + cols)
        rev = np.sort(cols * self.n + rows)
        if not np.array_equal(fwd, rev):
            raise ValueError("adjacency not symmetric")

    @staticmethod
    def from_edges(n: int, edges: np.ndarray) -> "Graph":
        """Build a symmetric, deduplicated CSR graph from an (m, 2) edge list."""
        edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
        with span("stage.csr", edges=int(edges.shape[0])):
            edges = edges[edges[:, 0] != edges[:, 1]]
            lo = np.minimum(edges[:, 0], edges[:, 1])
            hi = np.maximum(edges[:, 0], edges[:, 1])
            keys = np.unique(lo * n + hi)
            lo, hi = keys // n, keys % n
            src = np.concatenate([lo, hi])
            dst = np.concatenate([hi, lo])
            order = np.lexsort((dst, src))
            src, dst = src[order], dst[order]
            indptr = np.zeros(n + 1, dtype=np.int64)
            np.add.at(indptr, src + 1, 1)
            np.cumsum(indptr, out=indptr)
            return Graph(n=n, indptr=indptr, indices=dst.astype(np.int32))


def _forced_edges(n: int, has_upper_edge: np.ndarray) -> np.ndarray:
    """The reference connectivity fix (p2pnetwork.cc:81-84): rows with no
    sampled edge to any j > i get a forced edge to i-1 (row 0 -> (0, 1))."""
    out = []
    for i in np.flatnonzero(~has_upper_edge):
        if i == 0:
            if n > 1:
                out.append((0, 1))
        else:
            out.append((i - 1, i))
    return np.array(out, dtype=np.int64).reshape(-1, 2)


def erdos_renyi(
    n: int, p: float, seed: int = 0, return_parallel_extra: bool = False
):
    """Erdős–Rényi G(n, p) with the reference's connectivity fix: dense
    upper-triangle Bernoulli(p) sampling for small n, per-row binomial
    sampling (identical distribution) above ``_DENSE_ER_LIMIT``.

    ``return_parallel_extra`` also returns the (n,) int32 duplicate
    peer-list entries of the reference's parallel-link quirk
    (`parallel_link_extra`): ``(graph, extra)``."""
    if n <= 0:
        raise ValueError("n must be positive")
    rng = np.random.default_rng(seed)
    if n <= _DENSE_ER_LIMIT:
        tri = np.triu(rng.random((n, n)) < p, k=1)
        src, dst = np.nonzero(tri)
        has_upper = tri.any(axis=1)
        edges = np.stack([src, dst], axis=1)
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
    graph = Graph.from_edges(
        n, np.concatenate([edges, _forced_edges(n, has_upper)], axis=0)
    )
    if not return_parallel_extra:
        return graph
    return graph, parallel_link_extra(n, edges, has_upper)


def parallel_link_extra(
    n: int, sampled_edges: np.ndarray, has_upper: np.ndarray
) -> np.ndarray:
    """Per-node duplicate peer-list entries under the reference's
    parallel-link quirk (the CLI's ``--refParallelLinks``).

    The reference keys its link map by the ordered pair passed to
    `ConnectNodes` (p2pnetwork.cc:129): a sampled edge is (i-1, i) while
    row i's forced fallback is (i, i-1) (p2pnetwork.cc:83), so both
    physical links are built. The REGISTER reply handler appends a peer
    without a membership check (p2pnode.cc:186), so both endpoints of a
    doubled pair list each other twice and every broadcast sends that peer
    two copies (p2pnode.cc:129); the receiver drops the second copy
    without touching a counter (p2pnode.cc:189-193). The observable
    effects are a doubled ``sent`` on those entries and an inflated "Peer
    count" (`NodeStats.with_parallel_links`).

    A pair {i-1, i} is doubled iff row i forced its fallback edge and the
    (i-1, i) key exists: sampled by row i-1, or (for i == 1) forced by row
    0's own fallback (0, 1)."""
    extra = np.zeros(n, dtype=np.int32)
    if n <= 1:
        return extra
    forced_rows = np.flatnonzero(~has_upper)
    forced_rows = forced_rows[forced_rows >= 1]
    if forced_rows.size == 0:
        return extra
    sampled_edges = np.asarray(sampled_edges, dtype=np.int64).reshape(-1, 2)
    sampled_keys = set((sampled_edges[:, 0] * n + sampled_edges[:, 1]).tolist())
    for i in forced_rows:
        i = int(i)
        if ((i - 1) * n + i) in sampled_keys or (i == 1 and not has_upper[0]):
            extra[i - 1] += 1
            extra[i] += 1
    return extra


def barabasi_albert(n: int, m: int = 3, seed: int = 0, batch: int = 1024) -> Graph:
    """Barabási–Albert preferential attachment, m edges per node, attached
    in batches (preferential weights frozen per batch)."""
    if n <= m:
        raise ValueError("n must exceed m")
    rng = np.random.default_rng(seed)
    seed_nodes = np.arange(m + 1)
    edges = [np.stack([seed_nodes, np.roll(seed_nodes, -1)], axis=1)]
    # Endpoint pool: each edge contributes both endpoints -> degree-weighted.
    pool = np.empty(2 * ((m + 1) + m * (n - m - 1)), dtype=np.int64)
    fill = 2 * (m + 1)
    pool[:fill] = edges[0].ravel()
    next_node = m + 1
    while next_node < n:
        b = min(batch, n - next_node)
        new_nodes = np.arange(next_node, next_node + b)
        targets = pool[rng.integers(0, fill, size=(b, m))]
        batch_edges = np.stack(
            [np.repeat(new_nodes, m), targets.ravel()], axis=1
        )
        edges.append(batch_edges)
        pool[fill : fill + 2 * b * m] = batch_edges.ravel()
        fill += 2 * b * m
        next_node += b
    return Graph.from_edges(n, np.concatenate(edges, axis=0))


def ring_graph(n: int) -> Graph:
    """Ring topology — deterministic diameter."""
    nodes = np.arange(n, dtype=np.int64)
    return Graph.from_edges(n, np.stack([nodes, (nodes + 1) % n], axis=1))


def complete_graph(n: int) -> Graph:
    """Fully connected topology (single-hop flood)."""
    src, dst = np.nonzero(np.triu(np.ones((n, n), dtype=bool), k=1))
    return Graph.from_edges(n, np.stack([src, dst], axis=1))


def watts_strogatz(n: int, k: int = 4, beta: float = 0.1, seed: int = 0) -> Graph:
    """Watts–Strogatz small-world: ring lattice (each node to its k nearest
    neighbors, k even) with each clockwise edge rewired to a uniform random
    endpoint with probability ``beta``.

    Beyond-reference topology family: gossip latency studies care about the
    small-world regime (high clustering, log diameter) between the ring
    (beta=0) and ER-like (beta=1) extremes. Fully vectorized; rewires that
    would create a self-loop or duplicate are dropped by ``from_edges``'s
    canonicalization, and the ring backbone keeps every node connected
    (min degree >= k/2 >= 1, matching the reference's no-isolated-nodes
    guarantee).
    """
    if k < 2 or k % 2 != 0:
        raise ValueError("k must be a positive even integer")
    if k >= n:
        raise ValueError("k must be < n")
    if not 0.0 <= beta <= 1.0:
        raise ValueError("beta must be in [0, 1]")
    rng = np.random.default_rng(seed)
    nodes = np.arange(n, dtype=np.int64)
    lattice = [
        np.stack([nodes, (nodes + d) % n], axis=1) for d in range(1, k // 2 + 1)
    ]
    edges = np.concatenate(lattice, axis=0)
    rewire = np.flatnonzero(rng.random(edges.shape[0]) < beta)
    # Redraw targets that would self-loop (expected O(1) rounds).
    targets = rng.integers(0, n, size=rewire.shape[0])
    while True:
        bad = targets == edges[rewire, 0]
        if not bad.any():
            break
        targets[bad] = rng.integers(0, n, size=int(bad.sum()))
    edges[rewire, 1] = targets
    g = Graph.from_edges(n, edges)
    # Rewiring keeps each node's k/2 clockwise edges attached, so isolation
    # is only possible through duplicate-collapse corners; apply the
    # reference's forced-edge fix (p2pnetwork.cc:81-84) if it ever happens.
    isolated = np.flatnonzero(g.degree == 0)
    if isolated.size:
        fix = np.stack([isolated, (isolated - 1) % n], axis=1)
        g = Graph.from_edges(n, np.concatenate([g.edges(), fix], axis=0))
    return g


def grid_graph(rows: int, cols: int, torus: bool = False) -> Graph:
    """2D grid (optionally wrapped into a torus): the NetAnim layout's
    geometry (p2pnetwork.cc:167-176 arranges nodes on exactly this grid) as
    an actual communication topology. Deterministic degree <= 4, diameter
    rows+cols — the worst-case flood-latency stress test.
    """
    if rows < 1 or cols < 1 or rows * cols < 2:
        raise ValueError("grid needs at least 2 nodes")
    n = rows * cols
    ids = np.arange(n, dtype=np.int64).reshape(rows, cols)
    edges = []
    if cols > 1:
        edges.append(np.stack([ids[:, :-1].ravel(), ids[:, 1:].ravel()], axis=1))
    if rows > 1:
        edges.append(np.stack([ids[:-1, :].ravel(), ids[1:, :].ravel()], axis=1))
    if torus:
        if cols > 2:
            edges.append(np.stack([ids[:, -1].ravel(), ids[:, 0].ravel()], axis=1))
        if rows > 2:
            edges.append(np.stack([ids[-1, :].ravel(), ids[0, :].ravel()], axis=1))
    return Graph.from_edges(n, np.concatenate(edges, axis=0))


# --- npz graph caches (the JAX package's format: same keys, same
# fingerprints, so a cache either package writes loads in the other) ------

#: npz key prefix for derived per-graph arrays stored beside the CSR.
AUX_PREFIX = "aux_"


def save_graph_cache(
    path: str, graph: Graph, fp: str = "", aux: dict | None = None
) -> None:
    """Atomic npz graph cache write (tmp + fsync + replace). ``fp`` is the
    caller's build-parameter fingerprint, checked on load; ``aux`` arrays
    ride along under ``aux_<name>`` keys."""
    from p2p_gossip_tpu_torch.utils.checkpoint import atomic_savez

    extra = {AUX_PREFIX + name: np.asarray(arr) for name, arr in (aux or {}).items()}
    atomic_savez(
        path, n=graph.n, indptr=graph.indptr, indices=graph.indices, fp=fp,
        **extra,
    )


def load_graph_cache(path: str) -> tuple[Graph, str | None]:
    """Load an npz graph cache -> (graph, fingerprint or None). Raises
    ValueError with a readable message on an unreadable or non-graph
    file."""
    try:
        with np.load(path) as d:
            fp = str(d["fp"]) if "fp" in d else None
            graph = Graph(n=int(d["n"]), indptr=d["indptr"], indices=d["indices"])
    except Exception as e:  # any unreadable file: one message for the caller
        raise ValueError(
            f"{path} is not a readable graph cache "
            f"({type(e).__name__}: {e}); delete it to rebuild"
        ) from e
    return graph, fp


def scale_graph_fingerprint(
    topology: str, nodes: int, prob: float, ba_m: int, seed: int
) -> str:
    """Build-parameter fingerprint of the big-graph caches (the JAX
    package's ``scripts/scale_1m.py`` caches and the port's
    ``p2p_gossip_tpu_torch.scale``). ``ba_m`` is pinned to 3 for non-BA
    topologies, and the "scale_1m" prefix is kept, as in the JAX package."""
    from p2p_gossip_tpu_torch.utils.checkpoint import fingerprint

    return fingerprint(
        "scale_1m", topology, nodes, prob, ba_m if topology == "ba" else 3, seed,
    )


def load_or_build_graph_cache(
    cache: str,
    *,
    topology: str,
    nodes: int,
    prob: float,
    ba_m: int,
    seed: int,
    build,
    log,
) -> Graph:
    """Load ``cache`` if it exists and its fingerprint matches the build
    parameters (a cache with no fingerprint loads with a warning), else
    call ``build()`` and save the result under the fingerprint. ``cache``
    may be empty (always build, never save). Raises SystemExit(2) after
    ``log``-ging a message on an unreadable cache or a fingerprint
    mismatch."""
    import os
    import time

    fp = scale_graph_fingerprint(topology, nodes, prob, ba_m, seed)
    if cache and os.path.exists(cache):
        t0 = time.perf_counter()
        try:
            graph, cached_fp = load_graph_cache(cache)
        except ValueError as e:
            log(f"error: --cache {e}")
            raise SystemExit(2)
        if not cached_fp:  # None (no fp key) or "" (saved without one)
            log(f"WARNING: {cache} predates cache fingerprints — "
                "assuming it matches the requested topology flags")
        elif cached_fp != fp:
            log(f"error: {cache} was built with different topology "
                "flags; delete it or match the original arguments")
            raise SystemExit(2)
        log(f"graph loaded from {cache}: {time.perf_counter()-t0:.1f}s")
        return graph
    graph = build()
    if cache:
        save_graph_cache(cache, graph, fp=fp)
    return graph


# --- derived per-graph arrays and node orderings (the JAX package's
# models/topology.py: same aux keys and fingerprints, so either package
# reads the other's aux cache) --------------------------------------------

def load_graph_cache_aux(path: str) -> dict:
    """The ``aux_<name>`` arrays of an npz graph cache as {name: array}.
    Missing file or no aux keys -> {}; unreadable file raises ValueError
    like `load_graph_cache`."""
    import os

    if not os.path.exists(path):
        return {}
    try:
        with np.load(path) as d:
            return {
                key[len(AUX_PREFIX):]: d[key]
                for key in d.files
                if key.startswith(AUX_PREFIX)
            }
    except Exception as e:
        raise ValueError(
            f"{path} is not a readable graph cache "
            f"({type(e).__name__}: {e}); delete it to rebuild"
        ) from e


def load_or_compute_graph_aux(
    cache: str, name: str, fp: str, compute, log
) -> np.ndarray:
    """Load derived array ``name`` (partition labels, an RCM permutation)
    from the graph cache if the cache's fingerprint matches ``fp``, else
    ``compute()`` it and persist it back into the npz (atomic rewrite
    preserving every existing key). The point: 1M-node partitioning and
    RCM run host-side in minutes — they must run ONCE per graph build,
    not once per scale-run invocation. ``cache`` may be empty or
    fingerprint-mismatched (always compute, never save — the mismatch
    error stays `load_or_build_graph_cache`'s job)."""
    import os

    cached: dict = {}
    cache_ok = False
    if cache and os.path.exists(cache):
        try:
            _, cached_fp = load_graph_cache(cache)
            cached = load_graph_cache_aux(cache)
        except ValueError:
            cached_fp = None
        cache_ok = bool(cached_fp) and cached_fp == fp
        if cache_ok and name in cached:
            log(f"aux '{name}' loaded from {cache}")
            return cached[name]
    arr = np.asarray(compute())
    if cache_ok:
        graph, _ = load_graph_cache(cache)
        cached[name] = arr
        save_graph_cache(cache, graph, fp=fp, aux=cached)
        log(f"aux '{name}' computed and persisted to {cache}")
    return arr


def partition_labels(graph: Graph, n_parts: int, seed: int = 0) -> np.ndarray:
    """Greedy BFS-growing graph partitioning over the ``nodes`` mesh axis:
    ``labels[node] = partition`` in [0, n_parts).

    Partition-centric layout (PAPERS.md: Partition-Centric PageRank): each
    partition grows breadth-first from a low-degree seed, absorbing whole
    neighborhoods until it reaches the shard row budget, so most edges
    land inside a partition and the cross-shard cut — the rows the sparse
    frontier-delta exchange must ship — stays small. Sizes are pinned to
    the engines' contiguous-block sharding: every partition holds exactly
    ``ceil(n / n_parts)`` rows (the last takes the remainder), matching
    ``pad_to_multiple``'s end-padding, so ``partition_order`` relabeling
    aligns partition p with node shard p bit-for-bit.

    Deterministic for a given graph (ties break on node id; ``seed`` only
    rotates the first seed choice). Pure numpy level-synchronous BFS —
    O(edges) per pass, fine at 1M nodes host-side, and persisted via
    `load_or_compute_graph_aux` so it runs once per graph build."""
    n = graph.n
    if n_parts <= 0:
        raise ValueError(f"n_parts must be >= 1, got {n_parts}")
    cap = -(-n // n_parts)  # == n_loc after pad_to_multiple(n, n_parts)
    labels = np.full(n, -1, dtype=np.int32)
    degree = graph.degree
    # Low-degree-first seed order: peripheral nodes first keeps dense
    # cores intact inside one partition (classic BFS-growth heuristic).
    seed_order = np.argsort(degree, kind="stable").astype(np.int64)
    if seed != 0 and n:
        seed_order = np.roll(seed_order, -(seed % n))
    seed_pos = 0
    for part in range(n_parts):
        # Shard p owns padded rows [p*cap, (p+1)*cap); the pad lives at
        # the END (pad_to_multiple), so trailing partitions absorb it.
        remaining = max(0, min(cap, n - cap * part))
        frontier = np.empty(0, dtype=np.int64)
        while remaining > 0:
            if frontier.size == 0:
                while (
                    seed_pos < n and labels[seed_order[seed_pos]] >= 0
                ):
                    seed_pos += 1
                if seed_pos >= n:
                    break
                frontier = seed_order[seed_pos: seed_pos + 1]
                labels[frontier] = part
                remaining -= 1
                continue
            # Level-synchronous expansion: all unvisited neighbors of the
            # current frontier, deduped, id-sorted for determinism.
            starts = graph.indptr[frontier]
            counts = graph.indptr[frontier + 1] - starts
            gather = np.repeat(starts, counts) + (
                np.arange(int(counts.sum()), dtype=np.int64)
                - np.repeat(np.cumsum(counts) - counts, counts)
            )
            nxt = np.unique(graph.indices[gather].astype(np.int64))
            nxt = nxt[labels[nxt] < 0]
            if nxt.size > remaining:
                nxt = nxt[:remaining]
            labels[nxt] = part
            remaining -= nxt.size
            frontier = nxt
    assert (labels >= 0).all()
    return labels


def partition_order(labels: np.ndarray) -> np.ndarray:
    """Partition labels -> node renumbering for `relabel_graph`:
    ``order[new_id] = old_id``, stable within a partition so each
    partition occupies one contiguous block of new ids (= one node shard
    after `pad_to_multiple`)."""
    return np.argsort(np.asarray(labels), kind="stable").astype(np.int64)


def edge_cut(graph: Graph, labels: np.ndarray) -> int:
    """Undirected edges crossing partitions — the rows the sharded
    engines' frontier exchange must move when their owners change."""
    labels = np.asarray(labels)
    src = np.repeat(
        np.arange(graph.n, dtype=np.int64),
        np.diff(graph.indptr).astype(np.int64),
    )
    return int((labels[src] != labels[graph.indices]).sum()) // 2


def rcm_order(graph: Graph) -> np.ndarray:
    """Reverse Cuthill–McKee node ordering: ``order[new_id] = old_id``.

    A gather-locality lever, not a correctness feature: the tick engine's
    hot op gathers neighbors' frontier rows by node id
    (`ops/ell.py propagate_bucketed`), so renumbering nodes to cluster
    neighborhoods turns random HBM row reads into nearer ones. Gains are
    topology-dependent — lattices/small-world graphs reorder well, while
    the ER benchmark graph is an expander whose bandwidth RCM provably
    cannot reduce much — which is why this ships as a measurement
    candidate rather than a default.
    Gossip dynamics are label-invariant, so results are bitwise-equal
    after unrelabeling (tested in tests/test_topology.py)."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    m = csr_matrix(
        (np.ones(graph.indices.shape[0], dtype=np.int8), graph.indices,
         graph.indptr),
        shape=(graph.n, graph.n),
    )
    return np.asarray(reverse_cuthill_mckee(m, symmetric_mode=True),
                      dtype=np.int64)


def relabel_graph(graph: Graph, order: np.ndarray) -> tuple[Graph, np.ndarray]:
    """Apply a node renumbering: ``order[new_id] = old_id``.

    Returns ``(relabeled, inv)`` where ``inv[old_id] = new_id``. Per-node
    result arrays computed on the relabeled graph map back to original
    ids as ``arr_new[inv]`` (the JAX package's tests verify it bitwise for the
    flood engines)."""
    order = np.asarray(order, dtype=np.int64)
    assert order.shape == (graph.n,)
    inv = np.empty(graph.n, dtype=np.int64)
    inv[order] = np.arange(graph.n, dtype=np.int64)
    deg = graph.degree.astype(np.int64)[order]
    indptr = np.zeros(graph.n + 1, dtype=np.int64)
    np.cumsum(deg, out=indptr[1:])
    # Neighbor lists of row new_i are old row order[new_i]'s neighbors,
    # renumbered, and re-sorted to keep the CSR per-row sort invariant.
    gather_idx = np.repeat(graph.indptr[:-1][order], deg) + (
        np.arange(indptr[-1], dtype=np.int64)
        - np.repeat(indptr[:-1], deg)
    )
    indices = inv[graph.indices[gather_idx]].astype(np.int32)
    rows = np.repeat(np.arange(graph.n, dtype=np.int64), deg)
    indices = indices[np.lexsort((indices, rows))]
    relabeled = Graph(n=graph.n, indptr=indptr, indices=indices)
    return relabeled, inv
