"""Parameter-grid campaign sweeps (the JAX package's ``batch/sweep.py``).

Expands a JSON spec into a grid of cells over {protocol, p (or topology
density knob), lossProb, churnProb, fanout}, runs each cell as a seed
ensemble, and emits one JSON record per cell plus a human-readable report
(``batch.stats.format_campaign_report``).

Spec format (scalars are 1-element axes; ``example_spec()`` is runnable):

    {
      "numNodes": 256, "topology": "er",
      "p": [0.05, 0.1],              # grid axis
      "protocol": ["push", "pushk"], # grid axis
      "fanout": [2],                 # grid axis (pushk only)
      "lossProb": [0.0, 0.1],        # grid axis
      "churnProb": [0.0],            # grid axis
      "replicas": 8,                 # or explicit [seed, ...] list
      "shares": 4, "horizon": 64, "Latency": 5.0,
      "coverageFraction": 0.99, "baseSeed": 0
    }

``push`` cells run ``batch.campaign.run_coverage_campaign``, the
random-partner protocols (pushpull / pull / pushk)
``run_protocol_campaign``. A record equals the JAX package's for the same
cell apart from its wall-time fields and ``platform`` off the CPU.
"""

from __future__ import annotations

import itertools
import json
import time

import numpy as np

from p2p_gossip_tpu_torch.batch import stats as bstats
from p2p_gossip_tpu_torch.batch.campaign import (
    CampaignResult,
    flood_replicas,
    run_coverage_campaign,
    run_protocol_campaign,
)
from p2p_gossip_tpu_torch.models import topology as topo
from p2p_gossip_tpu_torch.models.linkloss import LinkLossModel
from p2p_gossip_tpu_torch.models.seeds import loss_stream_seed
from p2p_gossip_tpu_torch.telemetry.spans import span
from p2p_gossip_tpu_torch.utils import logging as p2plog
from p2p_gossip_tpu_torch.utils.device import resolve_device

log = p2plog.get_logger("Batch.Sweep")

# The grid axes a spec may vectorize, in report order.
GRID_AXES = ("protocol", "p", "lossProb", "churnProb", "fanout")

_DEFAULTS = {
    "numNodes": 256,
    "topology": "er",
    "protocol": "push",
    "p": 0.05,
    "lossProb": 0.0,
    "churnProb": 0.0,
    "fanout": 2,
    "replicas": 8,
    "shares": 4,
    "horizon": 64,
    "Latency": 5.0,
    "coverageFraction": 0.99,
    "baseSeed": 0,
    "churnDowntimeTicks": 10.0,
    "churnOutages": 1,
}


def example_spec() -> dict:
    """A small CPU-runnable campaign: 2 protocols x 2 loss rates x 8
    seeds on a 256-node graph."""
    return {
        "numNodes": 256,
        "p": 0.05,
        "protocol": ["push", "pushk"],
        "fanout": [3],
        "lossProb": [0.0, 0.1],
        "replicas": 8,
        "shares": 4,
        "horizon": 64,
    }


def expand_grid(spec: dict) -> list[dict]:
    """Spec -> list of fully-scalar cell configs (cartesian product of the
    list-valued grid axes; unknown keys are rejected loudly rather than
    silently ignored — a typoed axis must not collapse the grid)."""
    unknown = set(spec) - set(_DEFAULTS)
    if unknown:
        raise ValueError(
            f"unknown sweep keys {sorted(unknown)}; axes are "
            f"{sorted(_DEFAULTS)}"
        )
    merged = {**_DEFAULTS, **spec}
    for key in set(merged) - set(GRID_AXES):
        if isinstance(merged[key], list) and key != "replicas":
            raise ValueError(f"'{key}' cannot be a grid axis (only {GRID_AXES})")
    axes = [
        (k, merged[k] if isinstance(merged[k], list) else [merged[k]])
        for k in GRID_AXES
    ]
    cells = []
    for values in itertools.product(*(v for _, v in axes)):
        cell = {**merged, **dict(zip((k for k, _ in axes), values))}
        if cell["protocol"] != "pushk":
            # fanout only parameterizes pushk — collapse it so the grid
            # does not duplicate push/pushpull cells per fanout value.
            cell["fanout"] = _DEFAULTS["fanout"]
        cells.append(cell)
    # Dedup post-collapse duplicates, preserving order.
    seen, unique = set(), []
    for cell in cells:
        key = json.dumps(cell, sort_keys=True)
        if key not in seen:
            seen.add(key)
            unique.append(cell)
    return unique


def _cell_seeds(cell: dict) -> np.ndarray:
    reps = cell["replicas"]
    if isinstance(reps, list):
        return np.asarray(reps, dtype=np.int64)
    return np.arange(int(reps), dtype=np.int64) + int(cell["baseSeed"])


def _build_graph(cell: dict):
    kind = cell["topology"]
    n, seed = cell["numNodes"], int(cell["baseSeed"])
    if kind == "er":
        return topo.erdos_renyi(n, cell["p"], seed=seed)
    if kind == "ba":
        return topo.barabasi_albert(n, m=max(1, int(round(cell["p"]))), seed=seed)
    if kind == "ring":
        return topo.ring_graph(n)
    if kind == "complete":
        return topo.complete_graph(n)
    raise ValueError(f"sweep topology must be er|ba|ring|complete, got {kind}")


def _cell_loss(cell: dict) -> LinkLossModel | None:
    if cell["lossProb"] <= 0.0:
        return None
    # Same stream derivation as the CLI so cell results reproduce solo runs.
    return LinkLossModel(cell["lossProb"], seed=loss_stream_seed(cell["baseSeed"]))


def run_cell(
    cell: dict, batch_size: int | None = None, mesh=None, *, device=None
) -> tuple[dict, CampaignResult]:
    """Run one grid cell end to end; returns (record, result). The record
    is one strict-JSON line: the cell config, the engine and platform
    labels, and the ensemble summary. ``platform`` names the device the
    cell ran on in the JAX package's words (``cpu``, ``gpu``)."""
    device = resolve_device(device)
    seeds = _cell_seeds(cell)
    graph = _build_graph(cell)
    loss = _cell_loss(cell)
    t0 = time.perf_counter()
    if cell["protocol"] not in ("push", "pushpull", "pull", "pushk"):
        raise ValueError(f"unknown protocol {cell['protocol']!r}")
    replicas = flood_replicas(
        graph, cell["shares"], seeds, cell["horizon"],
        churn_prob=cell["churnProb"],
        mean_down_ticks=cell["churnDowntimeTicks"],
        max_outages=cell["churnOutages"],
    )
    with span(
        "cell", protocol=cell["protocol"], p=cell["p"],
        lossProb=cell["lossProb"], churnProb=cell["churnProb"],
        replicas=len(seeds),
    ):
        if cell["protocol"] == "push":
            result = run_coverage_campaign(
                graph, replicas, cell["horizon"], loss=loss,
                batch_size=batch_size, mesh=mesh, device=device,
            )
        else:
            result = run_protocol_campaign(
                graph, replicas, cell["horizon"], protocol=cell["protocol"],
                fanout=cell["fanout"], loss=loss, batch_size=batch_size,
                mesh=mesh, device=device,
            )
    wall = time.perf_counter() - t0

    summary = bstats.ensemble_summary(result, cell["coverageFraction"])
    record = {
        "cell": {
            k: cell[k]
            for k in (
                "numNodes", "topology", "protocol", "p", "lossProb",
                "churnProb", "fanout", "shares", "horizon", "Latency",
                "coverageFraction",
            )
        },
        "seeds": [int(s) for s in seeds],
        "engine": "vmap",
        "platform": "gpu" if device.type == "cuda" else device.type,
        "edges": int(graph.num_edges),
        "summary": summary,
        "wall_s": round(wall, 4),
    }
    return record, result


def run_sweep(
    spec: dict,
    batch_size: int | None = None,
    mesh=None,
    emit=None,
    *,
    device=None,
) -> list[dict]:
    """Run every cell of the grid; returns the records in grid order.
    ``emit`` (optional callable) receives each record as it lands — the
    CLI streams them as JSON lines so a long campaign is tail-able."""
    cells = expand_grid(spec)
    log.info(f"sweep: {len(cells)} cells")
    records = []
    for i, cell in enumerate(cells):
        record, _ = run_cell(cell, batch_size=batch_size, mesh=mesh, device=device)
        log.info(
            f"cell {i + 1}/{len(cells)}: {record['cell']['protocol']} "
            f"p={record['cell']['p']:g} loss={record['cell']['lossProb']:g} "
            f"({record['wall_s']:.2f}s)"
        )
        records.append(record)
        if emit is not None:
            emit(record)
    return records
