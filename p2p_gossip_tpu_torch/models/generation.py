"""Share-generation schedules (host-side numpy).

The reference generates shares per node as a renewal process with
inter-arrival ~ U(2, 5) seconds (`P2PNode::ScheduleNextShare`,
p2pnode.cc:97-104). The whole process is pre-sampled into flat
``(origin, gen_tick)`` arrays sorted by time; the tick engine scatters each
generation into the frontier at its tick. The share's identity is its
array index.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Schedule:
    """Flat share-generation schedule sorted by generation tick."""

    n_nodes: int
    origins: np.ndarray    # (S,) int32 — generating node per share
    gen_ticks: np.ndarray  # (S,) int32 — generation tick per share, sorted

    def __post_init__(self):
        self.origins = np.asarray(self.origins, dtype=np.int32)
        self.gen_ticks = np.asarray(self.gen_ticks, dtype=np.int32)
        order = np.argsort(self.gen_ticks, kind="stable")
        self.origins = self.origins[order]
        self.gen_ticks = self.gen_ticks[order]

    @property
    def num_shares(self) -> int:
        return int(self.origins.shape[0])

    def generated_per_node(self, max_tick: int | None = None) -> np.ndarray:
        """Per-node sharesGenerated counter (p2pnode.cc:118) for the shares
        generated before ``max_tick``."""
        mask = (
            self.gen_ticks < max_tick
            if max_tick is not None
            else np.ones_like(self.gen_ticks, dtype=bool)
        )
        return np.bincount(
            self.origins[mask], minlength=self.n_nodes
        ).astype(np.int32)

    def padded(self, chunk_size: int, horizon: int) -> tuple[np.ndarray, np.ndarray]:
        """(origins, gen_ticks) padded to ``chunk_size``; padded slots get
        gen_tick == horizon, the never-fires sentinel."""
        origins = np.zeros(chunk_size, dtype=np.int32)
        gen_ticks = np.full(chunk_size, horizon, dtype=np.int32)
        origins[: self.num_shares] = self.origins
        gen_ticks[: self.num_shares] = self.gen_ticks
        return origins, gen_ticks

    def chunk(self, chunk_size: int) -> list["Schedule"]:
        """Split into fixed-size chunks (shares are independent and counters
        add across chunks)."""
        return [
            Schedule(
                self.n_nodes,
                self.origins[i : i + chunk_size],
                self.gen_ticks[i : i + chunk_size],
            )
            for i in range(0, self.num_shares, chunk_size)
        ]


def _times_to_schedule(
    n: int, times: np.ndarray, node_ids: np.ndarray, sim_time: float, tick_dt: float
) -> Schedule:
    mask = (times >= 0) & (times < sim_time)
    ticks = np.floor(times[mask] / tick_dt).astype(np.int32)
    return Schedule(n, node_ids[mask].astype(np.int32), ticks)


def uniform_renewal_schedule(
    n: int,
    sim_time: float,
    tick_dt: float,
    lo: float = 2.0,
    hi: float = 5.0,
    seed: int = 0,
) -> Schedule:
    """Per-node renewal process with inter-arrival U(lo, hi) seconds — the
    reference's generation model (p2pnode.cc:99)."""
    rng = np.random.default_rng(seed)
    k = int(np.ceil(sim_time / lo)) + 2
    gaps = rng.uniform(lo, hi, size=(n, k))
    times = np.cumsum(gaps, axis=1)
    node_ids = np.broadcast_to(np.arange(n, dtype=np.int64)[:, None], (n, k))
    return _times_to_schedule(n, times.ravel(), node_ids.ravel(), sim_time, tick_dt)


def poisson_schedule(
    n: int, sim_time: float, tick_dt: float, rate: float, seed: int = 0
) -> Schedule:
    """Poisson share generation at ``rate`` shares/sec/node."""
    rng = np.random.default_rng(seed)
    counts = rng.poisson(rate * sim_time, size=n)
    total = int(counts.sum())
    times = rng.uniform(0.0, sim_time, size=total)
    node_ids = np.repeat(np.arange(n, dtype=np.int64), counts)
    return _times_to_schedule(n, times, node_ids, sim_time, tick_dt)


def single_share_schedule(n: int, origin: int = 0, tick: int = 0) -> Schedule:
    """One share from one origin — the flood coverage-time experiment."""
    return Schedule(n, np.array([origin]), np.array([tick]))
