"""Ensemble statistics over campaign replicas (the JAX package's
``batch/stats.py``, over the port's ``utils/analysis.py``).

The reduction half of the campaign engine: per-replica counter
vectors and coverage histories (``batch.campaign.CampaignResult``) reduce
to the numbers a protocol comparison actually needs — time-to-coverage
percentiles across the seed ensemble (p50/p95/p99, the tail a single run
cannot see), confidence intervals on the counter totals, and the
distribution of the redundancy metric. Latency extraction per replica
reuses ``utils.analysis.propagation_latency``; redundancy reuses
``utils.analysis.message_redundancy`` — one definition of each metric in
the codebase.

All outputs are plain floats/lists (strict-JSON safe: no numpy scalars,
no Infinity/NaN) because ``batch.sweep`` serializes them verbatim, one
line per grid cell.
"""

from __future__ import annotations

import io
import math

import numpy as np

from p2p_gossip_tpu_torch.batch.campaign import CampaignResult
from p2p_gossip_tpu_torch.utils.analysis import message_redundancy, propagation_latency

# One-sided z at 97.5% — the normal-approximation 95% CI. R is usually
# small (8-64 seeds), so these are approximate; the spread fields carry
# the raw std for readers who want a t-correction.
_Z95 = 1.959963984540054


def ttc_matrix(
    coverage: np.ndarray,
    n: int,
    fraction: float = 0.99,
    gen_ticks: np.ndarray | None = None,
) -> np.ndarray:
    """(R, S) ticks-to-``fraction``-coverage across a campaign's coverage
    tensor (R, T, S); -1 where a share never reached it. Row r is exactly
    ``propagation_latency`` on replica r's history."""
    coverage = np.asarray(coverage)
    r_total = coverage.shape[0]
    out = np.empty(coverage.shape[::2], dtype=np.int64)  # (R, S)
    for r in range(r_total):
        gen = None if gen_ticks is None else gen_ticks[r]
        rep = propagation_latency(
            coverage[r], n, gen_ticks=gen, fractions=(fraction,)
        )
        out[r] = rep.latency[fraction]
    return out


def percentile_summary(samples: np.ndarray) -> dict[str, float] | None:
    """mean/p50/p95/p99/min/max of a 1-D sample vector (plain floats,
    linear-interpolation percentiles — ``np.percentile`` semantics, which
    the oracle tests assert). None for an empty vector."""
    samples = np.asarray(samples, dtype=np.float64).ravel()
    samples = samples[np.isfinite(samples)]
    if samples.size == 0:
        return None
    p50, p95, p99 = np.percentile(samples, [50, 95, 99])
    return {
        "mean": float(samples.mean()),
        "p50": float(p50),
        "p95": float(p95),
        "p99": float(p99),
        "min": float(samples.min()),
        "max": float(samples.max()),
        "samples": int(samples.size),
    }


def mean_ci(samples: np.ndarray) -> dict[str, float | list | None]:
    """Sample mean with a normal-approximation 95% CI. A single replica
    has no spread estimate: std/ci come back None rather than NaN (strict
    JSON) — the single-run degenerate case the campaign engine exists to
    move people off."""
    samples = np.asarray(samples, dtype=np.float64).ravel()
    if samples.size == 0:
        return {"mean": None, "std": None, "ci95": None, "n": 0}
    mean = float(samples.mean())
    if samples.size == 1:
        return {"mean": mean, "std": None, "ci95": None, "n": 1}
    std = float(samples.std(ddof=1))
    half = _Z95 * std / math.sqrt(samples.size)
    return {
        "mean": mean,
        "std": std,
        "ci95": [mean - half, mean + half],
        "n": int(samples.size),
    }


def ensemble_summary(
    result: CampaignResult, fraction: float = 0.99
) -> dict:
    """The campaign cell's headline dict: time-to-coverage distribution
    (pooled over every replica x share sample that reached the target),
    per-counter means with CIs over replicas, and the redundancy
    distribution. JSON-serializable as-is."""
    summary: dict = {
        "replicas": result.num_replicas,
        "nodes": result.n,
        "horizon": result.horizon,
        "wall_s": round(result.wall_s, 4),
        "batch_size": result.batch_size,
    }

    if result.coverage is not None:
        ttc = ttc_matrix(result.coverage, result.n, fraction)
        reached = ttc >= 0
        summary["ttc"] = {
            "fraction": fraction,
            "reached": float(reached.mean()) if ttc.size else 0.0,
            "ticks": percentile_summary(ttc[reached]),
            # Per-replica worst share — the campaign-level tail metric
            # (p99 over replicas of each replica's slowest share).
            "replica_max": percentile_summary(
                np.where(reached.all(axis=1), ttc.max(axis=1), -1)[
                    reached.all(axis=1)
                ]
            )
            if ttc.size
            else None,
        }

    totals = result.totals_per_replica()
    summary["counters"] = {
        name: mean_ci(vals) for name, vals in totals.items()
    }

    spd, wasted = [], []
    for r in range(result.num_replicas):
        red = message_redundancy(result.replica_stats(r))
        if red["sends_per_delivery"] is not None:
            spd.append(red["sends_per_delivery"])
        wasted.append(red["wasted_fraction"])
    summary["redundancy"] = {
        "sends_per_delivery": percentile_summary(np.asarray(spd)),
        "wasted_fraction": percentile_summary(np.asarray(wasted)),
    }
    return summary


def _fmt(v, nd=1) -> str:
    return "n/a" if v is None else f"{v:.{nd}f}"


def format_campaign_report(records: list[dict]) -> str:
    """Human-readable campaign table: one line per grid cell, the ensemble
    tail metrics a single-seed table cannot show. ``records`` are the
    sweep's per-cell dicts ({"cell": ..., "summary": ...})."""
    out = io.StringIO()
    out.write("=== Campaign Report ===\n")
    header = (
        f"{'protocol':>9} {'p':>7} {'loss':>5} {'churn':>5} {'fanout':>6} "
        f"{'R':>4} | {'ttc p50':>8} {'p95':>7} {'p99':>7} {'reach':>6} | "
        f"{'sends/dlv':>9} {'recv mean±ci':>18}"
    )
    out.write(header + "\n")
    for rec in records:
        cell, s = rec["cell"], rec["summary"]
        ttc = s.get("ttc") or {}
        ticks = ttc.get("ticks") or {}
        p50, p95, p99 = ticks.get("p50"), ticks.get("p95"), ticks.get("p99")
        red = (s.get("redundancy") or {}).get("sends_per_delivery") or {}
        recv = (s.get("counters") or {}).get("received") or {}
        ci = recv.get("ci95")
        half = (ci[1] - ci[0]) / 2 if ci else None
        out.write(
            f"{cell.get('protocol', 'push'):>9} "
            f"{cell.get('p', 0):>7g} "
            f"{cell.get('lossProb', 0):>5g} "
            f"{cell.get('churnProb', 0):>5g} "
            f"{cell.get('fanout', '-'):>6} "
            f"{s.get('replicas', 0):>4} | "
            f"{_fmt(p50):>8} {_fmt(p95):>7} {_fmt(p99):>7} "
            f"{100 * ttc.get('reached', 0):>5.1f}% | "
            f"{_fmt((red or {}).get('mean'), 2):>9} "
            f"{_fmt(recv.get('mean')):>10}"
            + (f" ±{half:.1f}" if half is not None else " ±n/a")
            + "\n"
        )
    return out.getvalue()
