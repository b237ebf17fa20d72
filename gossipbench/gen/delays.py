"""Per-link delays of the benchmark (host NumPy): a frozen copy of the
program's log-normal draw (``models.latency.lognormal_edge_delays``), so
that a later change to the program cannot move the links a cell runs on.

The draw works on the benchmark's own CSR (`gossipbench.reference.flood.
csr_from_edges`: symmetric, deduplicated, neighbours sorted) and gives one
int32 a CSR entry, the same on both directions of a link: one value per
undirected edge (u < v), drawn in (u, v) order, clipped to [1,
``max_ticks``] after rounding. The program's CSR holds the same entries
in the same order, so the entry stages these values as they are and the
plain reference reads the same ones.

A configuration's ``delays`` block: ``{"model": "lognormal",
"mean_ticks", "sigma", "max_ticks", "seed"}`` (the program's CLI flags
``--delayMeanTicks --delaySigma --delayMaxTicks``; the seed fixed in the
configuration, so the links do not change with the run's seed).
"""

from __future__ import annotations

import numpy as np

MODELS = {"lognormal": ("mean_ticks", "sigma", "max_ticks", "seed")}


def lognormal_csr(n: int, indptr: np.ndarray, indices: np.ndarray, mean_ticks: float,
                  sigma: float, max_ticks: int, seed: int) -> np.ndarray:
    """One delay in ticks a CSR entry (int32), log-normal with mean
    ``mean_ticks`` ticks, symmetric per link."""
    indptr, indices = np.asarray(indptr, dtype=np.int64), np.asarray(indices, dtype=np.int64)
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    upper = rows < indices
    edge_keys = rows[upper] * n + indices[upper]  # sorted: CSR order is (row, column) order
    rng = np.random.default_rng(seed)
    mu = np.log(mean_ticks) - 0.5 * sigma**2
    vals = np.clip(np.round(rng.lognormal(mu, sigma, size=edge_keys.shape[0])), 1,
                   max_ticks).astype(np.int32)
    keys = np.minimum(rows, indices) * n + np.maximum(rows, indices)
    return vals[np.searchsorted(edge_keys, keys)]


def edge_delays(spec: dict, n: int, indptr: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """The delays of a configuration's ``delays`` block, which holds its
    model's keys and no others."""
    model = spec["model"]
    if set(spec) - {"model"} != set(MODELS.get(model, ())):
        raise ValueError(f"delays {model!r}: keys {sorted(spec)}")
    return lognormal_csr(n, indptr, indices, float(spec["mean_ticks"]), float(spec["sigma"]),
                         int(spec["max_ticks"]), int(spec["seed"]))
