"""Share-generation schedules of the benchmark (host NumPy): the general
generator that every traffic mix's parameters drive.

A schedule is two (S,) int32 arrays, ``origins`` and ``gen_ticks``,
sorted by generation tick (stable), which is the order the program's
``Schedule`` keeps and chunks in; a share's slot is its index.

Generation kinds (the ``gen`` block of a traffic file):

- ``{"kind": "uniform_ticks", "shares": S, "lo": a, "hi": b}``: S shares,
  origins uniform over the nodes, ticks uniform in [a, b);
- ``{"kind": "renewal", "lo_s": 2.0, "hi_s": 5.0}``: the NS-3 reference's
  generation (p2pnode.cc:97-104): each node generates a share every
  U(lo_s, hi_s) seconds over the configuration's ``simTime``, cut into
  ticks of its ``tick_s`` (a frozen copy of the program's
  ``uniform_renewal_schedule``).
"""

from __future__ import annotations

import math

import numpy as np


def sort_by_tick(origins: np.ndarray, gen_ticks: np.ndarray):
    order = np.argsort(gen_ticks, kind="stable")
    return (np.asarray(origins, dtype=np.int32)[order],
            np.asarray(gen_ticks, dtype=np.int32)[order])


def uniform_renewal(n: int, sim_time: float, tick_dt: float, lo: float, hi: float,
                    rng: np.random.Generator):
    """Per-node renewal process with inter-arrival U(lo, hi) seconds."""
    k = int(math.ceil(sim_time / lo)) + 2
    gaps = rng.uniform(lo, hi, size=(n, k))
    times = np.cumsum(gaps, axis=1).ravel()
    node_ids = np.broadcast_to(np.arange(n, dtype=np.int64)[:, None], (n, k)).ravel()
    mask = (times >= 0) & (times < sim_time)
    ticks = np.floor(times[mask] / tick_dt).astype(np.int32)
    return sort_by_tick(node_ids[mask], ticks)


def uniform_ticks(n: int, shares: int, lo: int, hi: int, rng: np.random.Generator):
    """S shares with origins uniform and ticks uniform in [lo, hi), in
    tick order: the tick counts drawn at once (multinomial), the origins
    independent of them (the law of drawing (origin, tick) pairs and
    sorting them by tick, without the sort)."""
    counts = rng.multinomial(shares, np.full(hi - lo, 1.0 / (hi - lo)))
    ticks = np.repeat(np.arange(lo, hi, dtype=np.int32), counts)
    return rng.integers(0, n, size=shares).astype(np.int32), ticks


KINDS = {"uniform_ticks": ("shares", "lo", "hi"), "renewal": ("lo_s", "hi_s")}


def draw(gen: dict, config: dict, rng: np.random.Generator):
    """(origins, gen_ticks) of one simulation; the ``gen`` block holds its
    kind's keys and no others."""
    n = int(config["graph"]["n"])
    kind = gen["kind"]
    if set(gen) - {"kind"} != set(KINDS.get(kind, ())):
        raise ValueError(f"gen {kind!r}: keys {sorted(gen)}")
    if kind == "uniform_ticks":
        return uniform_ticks(n, int(gen["shares"]), int(gen["lo"]), int(gen["hi"]), rng)
    if kind == "renewal":
        return uniform_renewal(n, float(config["simTime"]), float(config["tick_s"]),
                               float(gen["lo_s"]), float(gen["hi_s"]), rng)
    raise ValueError(f"unknown generation kind {kind!r}")
