"""The plain reference of push-pull anti-entropy (Demers et al., PODC 1987)
on a tick clock: what every node counts and what every share covers
round by round, worked out again from the CSR, the link delays, the
schedule and the partner seed alone. Plain torch and NumPy; nothing of
the program is used.

Semantics (the program's `models.protocols` push-pull, BASELINE.json
config 5):

- each round t every node v with a neighbour picks one: entry ``k =
  mix32(seed ^ v*C_NODE ^ t*C_TICK) % degree(v)`` of its sorted CSR row
  (`pick`: the splitmix32 finalizer, all arithmetic mod 2^32, this
  file's own copy of `models/partnersel.py`'s spec), partner p and that
  link's delay d;
- both directions read the sender's ``seen`` as it stood after round t -
  d (nothing before round 0): v ORs in p's (the pull) and p ORs in v's
  (the push); a node's new ``seen`` is its ``seen`` of round t - 1 ORed
  with every row that reached it, then the shares generated at it on tick
  t;
- ``sent[v]`` adds the size of the row v sent (its ``seen`` of round t -
  d) every round it has a neighbour; ``received`` = the final ``seen``'s
  size less the shares generated at the node; ``forwarded = received``;
  ``processed = generated + received``; ``coverage[t, s]`` the nodes
  holding share s after round t. Every round runs (no early exit).

Share columns are independent given the picks, so the work splits into
blocks of columns (a dense bool (N, B) row a node, a ring of D = max delay
+ 1 of them), and counters, sizes and coverage columns add up over the
blocks. A campaign replica is a solo run with its own partner seed (the
campaign's bitwise contract), so a campaign is R of these.

The least bytes of a round (`roofline.gather_bytes` reads ``sectors``
and ``edges``): a round must write every node's new ``seen`` where it is
not empty, and each such byte has at least one source byte that holds its
bits (the old ``seen``, the pulled or a pushed row); so, counting each
input byte read once and each output byte written once over the data the
round needs, at least 32 B written and 32 B read an occupied 32-byte
sector of the new rows, and the 4 B index of each pick. Occupancy is
counted in 16-byte units (128 share columns, aligned in the simulation's
share order) and given as ``sectors`` = units / 2: a pass of 128 shares
holds a row in one unit, a wider pass's 32-byte sector holds two, at
least one of them occupied, so no layout moves fewer bytes. ``edges``
counts the exchanges made, ``nodes`` the (node, round) pairs with a new
bit. A lower bound for any implementation that keeps each round's
``seen`` rows, as the delays require.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

_C_NODE, _C_TICK = 0x9E3779B1, 0x85EBCA77
_M1, _M2 = 0x7FEB352D, 0x846CA68B
_MASK = np.uint64(0xFFFFFFFF)
UNIT_COLS = 128  # share columns of a 16-byte unit of a row


def pick(seed: int, nodes: np.ndarray, t: int, degree: np.ndarray) -> np.ndarray:
    """Each node's pick (slot 0) at round ``t``: an index in [0,
    max(degree, 1))."""
    u = np.uint64
    h = (u(seed) & _MASK) ^ ((nodes.astype(u) * u(_C_NODE)) & _MASK) ^ u((t * _C_TICK) & 0xFFFFFFFF)
    h &= _MASK
    h ^= h >> u(16)
    h = (h * u(_M1)) & _MASK
    h ^= h >> u(15)
    h = (h * u(_M2)) & _MASK
    h ^= h >> u(16)
    return (h % np.maximum(degree, 1).astype(u)).astype(np.int64)


def partner_seeds(origins: np.ndarray, gen_ticks: np.ndarray, count: int) -> np.ndarray:
    """``count`` partner seeds in [0, 2^31) drawn from a simulation's
    schedule, so the program's call and the reference derive the same
    ones from what both are given."""
    data = np.concatenate([np.asarray(origins), np.asarray(gen_ticks)]).astype(np.uint32)
    return np.random.default_rng(data).integers(0, 2**31, size=count)


@dataclasses.dataclass
class Problem:
    """One solo simulation. ``delays`` (E,) ticks a CSR entry, or None
    for ``delay`` on every link; ``origins`` and ``gen_ticks`` in
    schedule order."""

    n: int
    indptr: np.ndarray
    indices: np.ndarray
    delays: np.ndarray | None
    origins: np.ndarray
    gen_ticks: np.ndarray
    horizon: int
    seed: int
    delay: int = 1

    @property
    def degree(self) -> np.ndarray:
        return np.diff(self.indptr)

    @property
    def ring(self) -> int:
        hi = self.delay if self.delays is None else int(self.delays.max(initial=1))
        return hi + 1


def exchanges(p: Problem, device) -> tuple:
    """Every round's partner (H, N) int64 and ring slot of the rows read
    (H, N) int64 on ``device``; rows without a neighbour pick themselves
    (and exchange nothing)."""
    nodes = np.arange(p.n, dtype=np.int64)
    deg = p.degree
    live = deg > 0
    partners = np.empty((p.horizon, p.n), dtype=np.int64)
    slots = np.empty((p.horizon, p.n), dtype=np.int64)
    for t in range(p.horizon):
        pos = np.minimum(p.indptr[:-1] + pick(p.seed, nodes, t, deg), max(len(p.indices) - 1, 0))
        partners[t] = np.where(live, np.asarray(p.indices)[pos] if len(p.indices) else 0, nodes)
        d = p.delay if p.delays is None else np.where(live, np.asarray(p.delays)[pos], 1)
        slots[t] = np.mod(t - d, p.ring)
    return torch.as_tensor(partners, device=device), torch.as_tensor(slots, device=device)


def block_columns(n: int, ring: int, budget: float = 16e9) -> int:
    """Share columns a block holds: its ring of bool rows and the round's
    temporaries (~12 B a column a node) in about ``budget`` bytes, in
    whole units."""
    cols = int(budget // (max(n, 1) * (ring + 12)))
    return max(UNIT_COLS, cols // UNIT_COLS * UNIT_COLS)


def solve(p: Problem, device, *, occupancy: bool = False, lose_seed: int | None = None,
          budget: float = 16e9):
    """(outputs, occupancy counts or None) of one simulation: the five
    counters (int64, (N,)) and ``coverage`` (H, S). With ``lose_seed`` (the
    control), one node loses what reached it in one round: in the first
    block, in one of the first four rounds (from round 1) where some node
    gains a bit, drawn from the seed, a node drawn among those gainers
    keeps its old row (so its coverage columns read one less)."""
    device = torch.device(device)
    n, h, s = p.n, p.horizon, int(p.origins.shape[0])
    ring = p.ring
    partners, slots = exchanges(p, device)
    deg = torch.as_tensor(p.degree, device=device)
    live = deg > 0
    rows = torch.arange(n, device=device)
    gen = np.asarray(p.gen_ticks, dtype=np.int64)
    org = np.asarray(p.origins, dtype=np.int64)
    final = torch.zeros(n, dtype=torch.int64, device=device)
    sent = torch.zeros(n, dtype=torch.int64, device=device)
    cov = np.zeros((h, s), dtype=np.int64)
    units = 0
    hit = torch.zeros((h, n), dtype=torch.bool, device=device) if occupancy else None
    lose = None if lose_seed is None else np.random.default_rng(lose_seed)
    lose_after = None if lose is None else int(lose.integers(0, 4))  # gaining rounds to skip
    step = block_columns(n, ring, budget)
    for b0 in range(0, s, step):
        b1 = min(b0 + step, s)
        width = -(-(b1 - b0) // UNIT_COLS) * UNIT_COLS  # padding columns never fill
        cols = np.arange(b0, b1)
        hist = torch.zeros((ring, n, width), dtype=torch.bool, device=device)
        for t in range(h):
            old = hist[(t - 1) % ring]
            pt, st = partners[t], slots[t]
            mine = hist[st, rows]                   # what v sends: its row of round t - d
            new = old | (hist[st, pt] & live[:, None])  # the pull
            pushed = torch.zeros((n, width), dtype=torch.int32, device=device)
            pushed.index_add_(0, pt[live], mine[live].to(torch.int32))  # the push
            new |= pushed > 0
            del pushed
            sent += torch.where(live, mine.sum(dim=1), 0)
            if lose_after is not None and b0 == 0 and t >= 1:
                gainers = torch.nonzero((new & ~old).any(dim=1)).flatten().cpu().numpy()
                if gainers.size and lose_after == 0:
                    v = int(lose.choice(gainers))
                    new[v] = old[v]
                    lose_after = None
                elif gainers.size:
                    lose_after -= 1
            now = cols[gen[b0:b1] == t]
            if now.size:
                new[torch.as_tensor(org[now], device=device),
                    torch.as_tensor(now - b0, device=device)] = True
            hist[t % ring] = new
            cov[t, b0:b1] = new[:, :b1 - b0].sum(dim=0).cpu().numpy()
            if occupancy:
                units += int(new.view(n, width // UNIT_COLS, UNIT_COLS).any(dim=2).sum())
                hit[t] |= (new & ~old).any(dim=1)
            del mine, new
        final += hist[(h - 1) % ring].sum(dim=1)
        del hist
    live_gen = gen < h
    generated = np.bincount(org[live_gen], minlength=n).astype(np.int64)
    received = final.cpu().numpy() - generated
    out = {
        "generated": generated,
        "received": received,
        "forwarded": received.copy(),
        "sent": sent.cpu().numpy(),
        "processed": generated + received,
        "coverage": cov,
    }
    occ = None
    if occupancy:
        occ = {"sectors": units // 2, "edges": h * int(live.sum()),
               "nodes": int(hit.sum())}
    return out, occ


def campaign(problems: list, device, *, occupancy: bool = False,
             lose_seed: int | None = None):
    """R replicas, each a solo `solve` (the control's loss in replica 0):
    counters (R, N), coverage (R, H, S), occupancy counts summed."""
    outs, occ = [], None
    for r, p in enumerate(problems):
        out, o = solve(p, device, occupancy=occupancy,
                       lose_seed=lose_seed if r == 0 else None)
        outs.append(out)
        if o is not None:
            occ = o if occ is None else {k: occ[k] + o[k] for k in occ}
    return {k: np.stack([o[k] for o in outs]) for k in outs[0]}, occ
