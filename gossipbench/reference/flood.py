"""The plain reference of the flood: what every node counts, what every
share covers tick by tick, and how many ticks the loop runs, worked out
again from the edge list and the schedule alone.

Semantics (the NS-3 reference's flood, p2pnode.cc:106-193, on a tick
clock): a share generated at node ``o`` on tick ``g`` is processed by
``o`` on tick ``g``; every node that processes a share forwards it once
to each peer, and the copy lands ``delay`` ticks later; a node processes
the first copy that reaches it and drops the rest. With one delay on
every link, node ``v`` processes share ``s`` on tick ``g + delay *
dist(o, v)`` (hop distance), if that tick is before the horizon. So:

- ``received[v]`` = shares that reach ``v`` at a distance >= 1 before the
  horizon; ``generated[v]`` = shares ``v`` generates before the horizon;
  ``processed = generated + received``; ``forwarded = received``;
  ``sent = processed * degree``;
- ``coverage[t, s]`` = nodes that have processed ``s`` by tick ``t``;
- the loop of a pass (a chunk of ``chunk`` shares in schedule order)
  starts at its first generation tick and runs tick ``t`` while ``t <
  horizon`` and some tick of ``t - D .. t - 1`` (D = delay + 1, the
  frontiers still in flight) processed anything, or a generation is still
  due (``t <=`` its last generation tick).

Distances come from breadth-first search on the graph's CSR, many shares
at a time: a block of B share columns is a dense (N, B) frontier, and one
sparse-by-dense product with the adjacency gives each node's count of
frontier neighbours. Everything is plain torch (and NumPy on the host);
nothing of the program is used.

The work splits into blocks of share columns; the `Partial`s of disjoint
blocks add up (counters, layer sizes and sector counts add, occupancy
ORs), so several ranks can each work out a part.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

SECTOR_SLOTS = 256   # a 32-byte sector holds 8 words of 32 share bits
_UNREACHED = 32767   # int16 distance of a node a share never reaches
_MAX_LAYERS = 128    # deeper breadth-first search raises


def csr_from_edges(n: int, edges: np.ndarray):
    """Symmetric CSR (indptr (n+1,), indices) of an undirected edge list:
    self-loops dropped, duplicates merged, neighbours sorted."""
    e = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    e = e[e[:, 0] != e[:, 1]]
    keys = np.unique(np.minimum(e[:, 0], e[:, 1]) * n + np.maximum(e[:, 0], e[:, 1]))
    lo, hi = keys // n, keys % n
    src = np.concatenate([lo, hi])
    dst = np.concatenate([hi, lo])
    order = np.argsort(src * n + dst, kind="stable")
    src, dst = src[order], dst[order]
    indptr = np.concatenate([[0], np.cumsum(np.bincount(src, minlength=n))]).astype(np.int64)
    return indptr, dst.astype(np.int64)


@dataclasses.dataclass
class Problem:
    """One simulation's inputs, as the benchmark hands them to both sides.
    ``origins`` and ``gen_ticks`` are in schedule order (sorted by tick)."""

    n: int
    indptr: np.ndarray
    indices: np.ndarray
    origins: np.ndarray
    gen_ticks: np.ndarray
    horizon: int
    delay: int = 1
    chunk: int | None = None   # shares a pass carries (None: all in one)

    @property
    def degree(self) -> np.ndarray:
        return np.diff(self.indptr)

    @property
    def shares(self) -> int:
        return int(self.origins.shape[0])

    @property
    def pass_size(self) -> int:
        return self.chunk or max(self.shares, 1)


@dataclasses.dataclass
class Partial:
    """The additive part of the reference over some share blocks."""

    received: np.ndarray          # (N,) int64
    layers: np.ndarray            # (S, K) int64: nodes at hop k of share s
    sectors: int = 0              # (node, sector, tick) triples with a bit
    active: dict | None = None    # pass -> (N, horizon) bool: frontier non-empty


def block_plan(p: Problem, block: int) -> list[tuple[int, int, int]]:
    """(pass, first share, end share) of each block; blocks never cross a
    pass, so sectors (256 slots of a pass) never cross a block."""
    out = []
    for c0 in range(0, p.shares, p.pass_size):
        c1 = min(c0 + p.pass_size, p.shares)
        for b0 in range(c0, c1, block):
            out.append((c0 // p.pass_size, b0, min(b0 + block, c1)))
    return out


def block_columns(n: int, dense_bytes: float = 4e9) -> int:
    """Share columns a block holds: a dense float32 (N, B) frontier of
    about ``dense_bytes``, in whole sectors."""
    cols = int(dense_bytes // (4 * max(n, 1)))
    return max(SECTOR_SLOTS, cols // SECTOR_SLOTS * SECTOR_SLOTS)


def _adjacency(p: Problem, device, dtype):
    crow = torch.as_tensor(p.indptr, dtype=torch.int64, device=device)
    col = torch.as_tensor(p.indices, dtype=torch.int64, device=device)
    val = torch.ones(col.shape[0], dtype=dtype, device=device)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # "sparse CSR support is in beta"
        return torch.sparse_csr_tensor(crow, col, val, size=(p.n, p.n))


def _distinct_ticks_per_sector(arr: torch.Tensor, horizon: int, rows: int) -> int:
    """(node, sector, tick) triples: for each node and each run of 256
    columns, the number of distinct ticks below ``horizon`` in ``arr``."""
    n, b = arr.shape
    total = 0
    for r0 in range(0, n, rows):
        part = arr[r0:r0 + rows].view(-1, b // SECTOR_SLOTS, SECTOR_SLOTS)
        s, _ = torch.sort(part, dim=-1)
        valid = s < horizon
        first = valid[..., 0].sum()
        change = ((s[..., 1:] != s[..., :-1]) & valid[..., 1:]).sum()
        total += int(first + change)
    return total


def flood_blocks(p: Problem, blocks, *, device, occupancy: bool = False,
                 lose_seed: int | None = None, dense_dtype=torch.float32) -> Partial:
    """Breadth-first search of the given blocks. With ``occupancy``, also
    the frontier's sector and node occupancy (for `gossipbench.roofline`).
    With ``lose_seed`` (the control), one delivery is lost: in the first
    block, a share drawn from the seed misses one node of its last hop
    before the horizon (which forwards to no one new)."""
    n, h, d = p.n, p.horizon, p.delay
    adj = _adjacency(p, device, dense_dtype)
    origins = torch.as_tensor(p.origins.astype(np.int64), device=device)
    gen = torch.as_tensor(p.gen_ticks.astype(np.int32), device=device)
    received = torch.zeros(n, dtype=torch.int64, device=device)
    k_cap = min(h // d + 1, _MAX_LAYERS)
    layers = torch.zeros((p.shares, k_cap), dtype=torch.int64, device=device)
    sectors = 0
    active = {}
    for bi, (c, b0, b1) in enumerate(blocks):
        cols = b1 - b0
        width = -(-cols // SECTOR_SLOTS) * SECTOR_SLOTS
        g = torch.full((width,), h, dtype=torch.int32, device=device)
        g[:cols] = gen[b0:b1]
        live = torch.nonzero(g < h).flatten()  # dead and padding columns have g = h
        frontier = torch.zeros((n, width), dtype=dense_dtype, device=device)
        frontier[origins[b0:b1][live], live] = 1
        visited = frontier > 0
        dist = torch.full((n, width), _UNREACHED, dtype=torch.int16, device=device)
        dist.masked_fill_(visited, 0)
        layers[b0:b1, 0] = (g[:cols] < h).to(torch.int64)
        k = 0
        while True:
            k += 1
            new = (torch.sparse.mm(adj, frontier) > 0) & ~visited
            count = new.sum(dim=0)
            if int(count.sum()) == 0:
                break
            if k >= k_cap:
                if k * d >= h:
                    break  # later hops land past the horizon anyway
                raise RuntimeError(f"breadth-first search deeper than {k_cap} hops")
            layers[b0:b1, k] = count[:cols]
            visited |= new
            dist.masked_fill_(new, k)
            frontier = new.to(dense_dtype)
            del new
        del frontier, visited
        arr = g[None, :] + d * dist.to(torch.int32)       # arrival tick, or past h
        arr.masked_fill_(dist == _UNREACHED, h)
        arr.clamp_(max=h)
        if lose_seed is not None and bi == 0:
            lost = _lose_one(p, layers, dist, g, b0, cols, lose_seed)
            if lost is not None:  # the node never processes the share
                s, v = lost
                layers[s, int(dist[v, s - b0])] -= 1
                arr[v, s - b0] = h
        reach = (arr < h) & (dist >= 1)
        received += reach.sum(dim=1)
        del reach
        if occupancy:
            rows = max(1, int(2e8 // width))
            sectors += _distinct_ticks_per_sector(arr, h, rows)
            act = active.setdefault(c, torch.zeros((n, h), dtype=torch.bool, device=device))
            for r0 in range(0, n, rows):
                part = arr[r0:r0 + rows]
                node = torch.arange(r0, r0 + part.shape[0], device=device)[:, None]
                hit = part < h
                flat = (node * h + part.to(torch.int64))[hit]
                act.view(-1)[flat] = True
        del dist, arr
    return Partial(
        received=received.cpu().numpy(),
        layers=layers.cpu().numpy(),
        sectors=sectors,
        active={c: a.cpu().numpy() for c, a in active.items()} or None,
    )


def _lose_one(p: Problem, layers, dist, g, b0, cols, seed):
    """The control's lost delivery: a share of the block (drawn from
    ``seed``) whose last hop lands before the horizon, and the first node
    of that hop."""
    h, d = p.horizon, p.delay
    lay = layers[b0:b0 + cols].cpu().numpy()
    gen = g[:cols].cpu().numpy()
    last = np.array([np.flatnonzero(row).max() if row.any() else -1 for row in lay])
    ok = np.flatnonzero((last >= 1) & (gen + d * last < h))
    if ok.size == 0:
        return None
    j = int(np.random.default_rng(seed).choice(ok))
    v = int(torch.nonzero(dist[:, j] == int(last[j]))[0, 0])
    return b0 + j, v


def derive(p: Problem, part: Partial, coverage: bool = False) -> dict:
    """The outputs a run of the program gives, from the summed partial:
    the five per-node counters (int64), the ticks the loops run over all
    passes, and with ``coverage`` the (horizon, S) coverage rows."""
    h, d = p.horizon, p.delay
    gen = p.gen_ticks.astype(np.int64)
    live = gen < h
    generated = np.bincount(p.origins[live], minlength=p.n).astype(np.int64)
    received = part.received.astype(np.int64)
    processed = generated + received
    out = {
        "generated": generated,
        "received": received,
        "forwarded": received.copy(),
        "sent": processed * p.degree.astype(np.int64),
        "processed": processed,
    }
    hop = np.arange(part.layers.shape[1], dtype=np.int64)
    tick_of = gen[:, None] + d * hop[None, :]                 # (S, K)
    lands = (part.layers > 0) & (tick_of < h) & live[:, None]
    ticks = 0
    for c0 in range(0, p.shares, p.pass_size):
        sl = slice(c0, min(c0 + p.pass_size, p.shares))
        if not live[sl].any():
            continue
        busy = np.zeros(h, dtype=bool)
        busy[tick_of[sl][lands[sl]]] = True
        ticks += loop_ticks(busy, int(gen[sl][live[sl]].min()), int(gen[sl][live[sl]].max()),
                            d + 1, h)
    out["ticks"] = ticks
    if coverage:
        cov = np.zeros((h, p.shares), dtype=np.int64)
        counts = np.where(lands, part.layers, 0)
        for k in range(counts.shape[1]):
            t = tick_of[:, k]
            ok = (counts[:, k] > 0) & (t < h)
            np.add.at(cov, (t[ok], np.flatnonzero(ok)), counts[ok, k])
        out["coverage"] = np.cumsum(cov, axis=0)
    return out


def loop_ticks(busy: np.ndarray, first: int, last_gen: int, ring: int, horizon: int) -> int:
    """Ticks a pass's loop runs: from ``first`` while ``t < horizon`` and a
    frontier of the last ``ring`` ticks was non-empty or ``t <=
    last_gen``."""
    flags = [False] * ring
    t = first
    while t < horizon and (any(flags) or t <= last_gen):
        flags[t % ring] = bool(busy[t])
        t += 1
    return t - first


def occupancy_counts(p: Problem, part: Partial) -> dict:
    """The frontier's occupancy over every tick of every pass: ``sectors``
    (node, 32-byte sector, tick) triples holding a bit, ``nodes`` (node,
    tick) pairs with a non-empty frontier, and ``edges``, the directed
    edges out of those nodes on those ticks."""
    deg = p.degree.astype(np.int64)
    nodes = edges = 0
    for act in (part.active or {}).values():
        per_node = act.sum(axis=1).astype(np.int64)
        nodes += int(per_node.sum())
        edges += int((per_node * deg).sum())
    return {"sectors": int(part.sectors), "nodes": nodes, "edges": edges}


class _Alone:
    """A world of one rank on ``device`` (see `solve`)."""

    rank, size = 0, 1

    def __init__(self, device):
        self.device = torch.device(device)


def solve(p: Problem, world, *, coverage: bool = False, occupancy: bool = False,
          lose_seed: int | None = None, dense_bytes: float = 4e9):
    """The reference of one simulation, its blocks shared out over the
    ranks of ``world`` (``rank``, ``size``, ``device``, and ``all_reduce(a,
    op)`` where ``size`` > 1) and added up: (outputs, occupancy counts or
    None), on every rank. The control's lost delivery is rank 0's."""
    blocks = block_plan(p, block_columns(p.n, dense_bytes))
    part = flood_blocks(p, blocks[world.rank::world.size], device=world.device,
                        occupancy=occupancy, lose_seed=lose_seed if world.rank == 0 else None)
    if world.size > 1:
        passes = sorted({c for c, _, _ in blocks}) if occupancy else ()
        part = _total(part, world, passes, p.horizon)
    return derive(p, part, coverage), occupancy_counts(p, part) if occupancy else None


def _total(part: Partial, world, passes, horizon: int) -> Partial:
    """Every rank's partial added up (occupancy ORed over ``passes``)."""
    active = {}
    for c in passes:
        a = (part.active or {}).get(c)
        if a is None:
            a = np.zeros((len(part.received), horizon), dtype=bool)
        active[c] = world.all_reduce(a.astype(np.uint8), "max").astype(bool)
    return Partial(world.all_reduce(part.received), world.all_reduce(part.layers),
                   int(world.all_reduce(np.array([part.sectors], dtype=np.int64))[0]),
                   active or None)


def flood(p: Problem, *, device="cpu", coverage: bool = False, occupancy: bool = False,
          lose_seed: int | None = None, dense_bytes: float = 4e9):
    """The whole reference on one device: (outputs, occupancy counts or
    None)."""
    return solve(p, _Alone(device), coverage=coverage, occupancy=occupancy,
                 lose_seed=lose_seed, dense_bytes=dense_bytes)
