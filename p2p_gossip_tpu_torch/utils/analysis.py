"""Propagation analysis: latency percentiles and traffic redundancy, as
the JAX package's ``utils/analysis.py`` computes and prints them.

- **propagation latency**: ticks from a share's generation until it has
  reached a fraction of the network, per share, summarized across shares,
  from the per-tick coverage history (`engine.sync.run_flood_coverage`);
- **redundancy**: share-transmissions per unique delivery (flooding costs
  about the mean degree per delivery, p2pnode.cc:127).
"""

from __future__ import annotations

import dataclasses
import io

import numpy as np

from p2p_gossip_tpu_torch.utils.stats import NodeStats


@dataclasses.dataclass(frozen=True)
class PropagationReport:
    """Per-share propagation latency at several coverage fractions.

    ``latency[f]`` is an (S,) int64 array: ticks from each share's
    generation tick until coverage first reached ``ceil(f * n)`` nodes (-1
    where the share never got there within the horizon)."""

    n: int
    fractions: tuple[float, ...]
    latency: dict[float, np.ndarray]

    def summary(self, fraction: float) -> dict[str, float]:
        """median / p95 / max / reached-share over shares that reached the
        fraction (all -1 when none did)."""
        lat = self.latency[fraction]
        ok = lat >= 0
        if not ok.any():
            return {"median": -1.0, "p95": -1.0, "max": -1.0, "reached": 0.0}
        hit = lat[ok].astype(np.float64)
        return {
            "median": float(np.median(hit)),
            "p95": float(np.percentile(hit, 95)),
            "max": float(hit.max()),
            "reached": float(ok.mean()),
        }


def propagation_latency(
    coverage: np.ndarray,
    n: int,
    gen_ticks: np.ndarray | None = None,
    fractions: tuple[float, ...] = (0.5, 0.9, 0.99, 1.0),
) -> PropagationReport:
    """Latency-to-coverage per share from a (T, S) coverage history.
    ``gen_ticks`` (S,) is subtracted per share (default 0: the flood-
    coverage experiment's all-at-t=0 convention)."""
    coverage = np.asarray(coverage)
    horizon, s = coverage.shape
    gen = (
        np.zeros(s, dtype=np.int64)
        if gen_ticks is None
        else np.asarray(gen_ticks, dtype=np.int64)
    )
    latency: dict[float, np.ndarray] = {}
    for f in fractions:
        if not 0.0 < f <= 1.0:
            raise ValueError(f"fractions must be in (0, 1], got {f}")
        target = int(np.ceil(f * n))
        hit = coverage >= target
        if horizon == 0:
            first = np.full(s, -1, dtype=np.int64)
        else:
            first = np.where(hit.any(axis=0), hit.argmax(axis=0), -1)
        lat = first.astype(np.int64) - gen
        latency[f] = np.where(first >= 0, np.maximum(lat, 0), -1)
    return PropagationReport(n=n, fractions=tuple(fractions), latency=latency)


def message_redundancy(stats: NodeStats) -> dict[str, float | None]:
    """Transmissions per unique delivery: ``sends_per_delivery`` is total
    `sent` over total first-time `received` (None when nothing was
    delivered), ``wasted_fraction`` the share of transmissions that were
    duplicates at the receiver or lost."""
    t = stats.totals()
    delivered = t["received"]
    sent = t["sent"]
    return {
        "sent": float(sent),
        "delivered": float(delivered),
        "sends_per_delivery": sent / delivered if delivered else None,
        "wasted_fraction": 1.0 - delivered / sent if sent else 0.0,
    }


def format_propagation_report(
    report: PropagationReport, tick_ms: float | None = None
) -> str:
    """Latency table in ticks, plus ms when ``tick_ms`` is given."""
    out = io.StringIO()
    out.write("=== Propagation Latency ===\n")
    for f in report.fractions:
        s = report.summary(f)
        line = (
            f"{int(round(f * 100)):3d}% coverage: "
            f"median {s['median']:g}, p95 {s['p95']:g}, max {s['max']:g} ticks"
        )
        if tick_ms is not None and s["median"] >= 0:
            line += f" (median {s['median'] * tick_ms:g} ms)"
        line += f"; {s['reached'] * 100:.1f}% of shares reached\n"
        out.write(line)
    return out.getvalue()
