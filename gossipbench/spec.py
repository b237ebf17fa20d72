"""Finding a cell's parts by name: ``BENCHMARK.json`` at the root of the
checkout, ``configs/<config>.json`` (through the configuration's
``file``), ``traffic/<mix>.json``, ``entries/<entry>.py`` and
``metrics/<metric>.py`` under this folder."""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

#: Keys every traffic file may hold besides its entry's ``TRAFFIC_KEYS``.
TRAFFIC_KEYS = ("entry", "about", "gen", "check_sims")
#: Keys every configuration may hold besides its entry's ``CONFIG_KEYS``:
#: what it is and where it comes from, and what the generators read.
CONFIG_KEYS = ("name", "source", "deployment", "published", "reduced", "assumed", "chips",
               "guarantees", "Latency_ms", "graph", "tick_s", "simTime")


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list

    @property
    def entry(self) -> str:
        return self.traffic["entry"]


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, bench: dict | None = None, root: str = ROOT) -> Cell:
    bench = load_benchmark(root) if bench is None else bench
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = _read_json(os.path.join(root, cfg_entry["file"]))
    traffic = traffic_of(w["traffic"], root)
    mod = entry(traffic["entry"])
    _only(f"traffic {w['traffic']}", traffic, TRAFFIC_KEYS + mod.TRAFFIC_KEYS)
    _only(f"configuration {w['config']}", config, CONFIG_KEYS + mod.CONFIG_KEYS)
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config=config,
        traffic=traffic,
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
    )


def _only(what: str, d: dict, keys) -> None:
    """Refuse a key that nothing reads: a run would leave it out silently."""
    extra = sorted(set(d) - set(keys))
    if extra:
        raise ValueError(f"{what}: keys {extra} are read by nothing")


def traffic_of(mix: str, root: str = ROOT) -> dict:
    traffic = _read_json(os.path.join(root, os.path.basename(HERE), "traffic", f"{mix}.json"))
    if int(traffic.get("chunk_size", 32)) % 32:
        raise ValueError(f"traffic {mix}: chunk_size must be whole 32-share words")
    return traffic


def entry(name: str):
    return importlib.import_module(f"gossipbench.entries.{name}")


def metric_reader(name: str):
    """The ``read(rec)`` of a metric, end-to-end or per-layer: the file
    ``metrics/<quantity>.py``, where the quantity is the name up to its
    first dot (``ms_per_tick.coverage`` is ``ms_per_tick`` in the cells
    that report ``node_updates_per_s.coverage``)."""
    quantity = name.split(".", 1)[0]
    path = os.path.join(HERE, "metrics", f"{quantity}.py")
    spec = importlib.util.spec_from_file_location(f"gossipbench_metric_{quantity}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
