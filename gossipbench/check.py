"""The comparison that decides ``correct``: every output of a checked
simulation against the plain reference's, exactly.

Each number compared is a count of mismatches, held to the limit 0
(integer outputs; the reference is exact):

- ``counters_bad``: per-node counter entries (generated, received,
  forwarded, sent, processed) that differ, compared as int64;
- ``ticks_bad``: checked simulations whose loop ran another number of
  ticks (entries that report them);
- ``coverage_bad``: coverage-row entries that differ (coverage entries);
- ``checked``: simulations compared, held to at least 1.
"""

from __future__ import annotations

import numpy as np

COUNTERS = ("generated", "received", "forwarded", "sent", "processed")


def _mismatch(a, b) -> int:
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        return int(max(a.size, b.size, 1))
    return int(np.count_nonzero(a.astype(np.int64) != b.astype(np.int64)))


def differences(result: dict, expected: dict, limit: int = 8) -> list[str]:
    """The first counter entries that differ, for the log."""
    out = []
    for k in COUNTERS:
        a, b = np.asarray(result["counters"][k]), np.asarray(expected[k])
        if a.shape != b.shape:
            out.append(f"{k}: shape {a.shape} against {b.shape}")
            continue
        for v in np.flatnonzero(a.astype(np.int64) != b.astype(np.int64))[:limit - len(out)]:
            out.append(f"{k}[{v}]: {int(a[v])} against {int(b[v])}")
    return out[:limit]


def compare(result: dict, expected: dict) -> dict:
    """Mismatch counts of one simulation."""
    out = {"counters_bad": sum(_mismatch(result["counters"][k], expected[k]) for k in COUNTERS)}
    if result.get("ticks") is not None:
        out["ticks_bad"] = int(int(result["ticks"]) != int(expected["ticks"]))
    if result.get("coverage") is not None:
        out["coverage_bad"] = _mismatch(result["coverage"], expected["coverage"])
    return out


def verdict(per_sim: list[dict]) -> tuple[bool, dict, int]:
    """(correct, {name: {"value", "limit"}}, simulations that failed)."""
    checks = {}
    for d in per_sim:
        for k, v in d.items():
            checks[k] = checks.get(k, 0) + v
    table = {k: {"value": v, "limit": 0} for k, v in checks.items()}
    table["checked"] = {"value": len(per_sim), "limit": ">= 1"}
    failed = sum(1 for d in per_sim if any(v for v in d.values()))
    correct = bool(per_sim) and all(v == 0 for v in checks.values())
    return correct, table, failed
