"""Node churn / failure model.

The reference runs with permanently-up nodes (NS-3 apps started once,
p2pnetwork.cc:193-219). Each node here carries up to K **downtime
intervals** ``[start, end)`` in integer ticks. While down, a node

- does not generate (its scheduled generation events are skipped: no
  counter, no broadcast);
- does not receive (messages arriving while it is down are lost, with no
  counter change and NOT entered into the seen-set, so a later copy of the
  same share via a slower path can still be delivered);
- consequently does not forward or send.

State is kept across an outage (offline model, not crash-reset).

The numpy half is the JAX package's ``models/churn.py``, so the same seed
gives the same intervals. The torch half stages the (N, K) interval pair on
the device; the tick engine evaluates the up mask ``~any(down_start <= t <
down_end, axis=K)`` per tick and hands it to the gather kernel, which
writes a down node's arrivals as zeros.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ChurnModel:
    """Per-node downtime intervals, padded to a common K with empty
    (start == end == 0) slots. Overlapping intervals are allowed; the node
    is down in their union."""

    n: int
    down_start: np.ndarray  # (N, K) int32
    down_end: np.ndarray    # (N, K) int32; slot inactive when end <= start

    def __post_init__(self):
        ds = np.ascontiguousarray(self.down_start, dtype=np.int32)
        de = np.ascontiguousarray(self.down_end, dtype=np.int32)
        if ds.shape != de.shape or ds.ndim != 2 or ds.shape[0] != self.n:
            raise ValueError(
                f"interval arrays must both be (n={self.n}, K); got "
                f"{ds.shape} and {de.shape}"
            )
        object.__setattr__(self, "down_start", ds)
        object.__setattr__(self, "down_end", de)

    @property
    def k(self) -> int:
        return int(self.down_start.shape[1])

    def up_at(self, nodes, ticks) -> np.ndarray:
        """Are ``nodes`` up at ``ticks``? Broadcasts like numpy."""
        nodes = np.asarray(nodes)
        t = np.asarray(ticks)[..., None]
        ds = self.down_start[nodes]
        de = self.down_end[nodes]
        return ~np.any((ds <= t) & (t < de), axis=-1)

    def up_mask(self, tick: int) -> np.ndarray:
        """(N,) bool: which nodes are up at ``tick``."""
        return self.up_at(np.arange(self.n), tick)

    def total_downtime(self, horizon: int) -> np.ndarray:
        """(N,) int64 ticks spent down within [0, horizon), interval unions
        counted once."""
        out = np.zeros(self.n, dtype=np.int64)
        for i in range(self.n):
            ivs = [
                (max(0, int(s)), min(horizon, int(e)))
                for s, e in zip(self.down_start[i], self.down_end[i])
                if e > s and e > 0 and s < horizon
            ]
            ivs.sort()
            last_end = 0
            for s, e in ivs:
                s = max(s, last_end)
                if e > s:
                    out[i] += e - s
                    last_end = e
                last_end = max(last_end, e)
        return out


def always_up(n: int) -> ChurnModel:
    """The no-churn identity (every interval slot empty)."""
    z = np.zeros((n, 1), dtype=np.int32)
    return ChurnModel(n=n, down_start=z, down_end=z.copy())


def from_intervals(n: int, intervals) -> ChurnModel:
    """Build from an explicit list of ``(node, down_start, down_end)``."""
    per_node: list[list[tuple[int, int]]] = [[] for _ in range(n)]
    for node, s, e in intervals:
        if not 0 <= node < n:
            raise ValueError(f"node {node} out of range [0, {n})")
        if e > s:
            per_node[node].append((int(s), int(e)))
    k = max((len(v) for v in per_node), default=0) or 1
    ds = np.zeros((n, k), dtype=np.int32)
    de = np.zeros((n, k), dtype=np.int32)
    for i, ivs in enumerate(per_node):
        for j, (s, e) in enumerate(ivs):
            ds[i, j] = s
            de[i, j] = e
    return ChurnModel(n=n, down_start=ds, down_end=de)


def random_churn(
    n: int,
    horizon: int,
    outage_prob: float = 0.1,
    mean_down_ticks: float = 10.0,
    max_outages: int = 1,
    seed: int = 0,
) -> ChurnModel:
    """Seeded random outage schedule: each of ``max_outages`` slots per node
    fails independently with probability ``outage_prob``, starting
    U{0, horizon-1} and lasting 1 + Geometric ticks with the given mean.
    Draws the JAX package's numbers in its order, so a seed gives the same
    intervals in both packages."""
    if not 0.0 <= outage_prob <= 1.0:
        raise ValueError(f"outage_prob must be in [0, 1], got {outage_prob}")
    k = max(1, int(max_outages))
    rng = np.random.default_rng(seed)
    active = rng.random((n, k)) < outage_prob
    start = rng.integers(0, max(horizon, 1), size=(n, k))
    dur = rng.geometric(min(1.0, 1.0 / max(mean_down_ticks, 1.0)), size=(n, k))
    ds = np.where(active, start, 0).astype(np.int32)
    de = np.where(active, np.minimum(start + dur, horizon), 0).astype(np.int32)
    return ChurnModel(n=n, down_start=ds, down_end=de)


def effective_generated(schedule, horizon: int, churn: ChurnModel | None):
    """Per-node sharesGenerated under churn: a share whose origin is down at
    its generation tick is never generated."""
    live = schedule.gen_ticks < horizon
    if churn is not None:
        live = live & churn.up_at(schedule.origins, schedule.gen_ticks)
    return np.bincount(
        schedule.origins[live], minlength=schedule.n_nodes
    ).astype(np.int64)


def to_device(churn: ChurnModel | None, device):
    """The (N, K) int32 interval pair on ``device`` (None passes through:
    the engine treats it as churn off)."""
    if churn is None:
        return None
    return (
        torch.as_tensor(churn.down_start, device=device),
        torch.as_tensor(churn.down_end, device=device),
    )


def up_mask(down_start: torch.Tensor, down_end: torch.Tensor, t: int) -> torch.Tensor:
    """(N,) bool: which nodes are up at tick ``t``."""
    return ~((down_start <= t) & (t < down_end)).any(dim=1)
