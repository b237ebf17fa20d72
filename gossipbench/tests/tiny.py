"""A tiny copy of the benchmark for the CPU tests: the same cells,
configurations and mixes as ``BENCHMARK.json``, with every size cut so
that a whole run takes a second or two on the CPU, and the mesh cell that
waits outside ``BENCHMARK.json`` (`PENDING`; on 2 gloo ranks).
``write_root(dir)`` lays it out as a checkout's root is laid out
(``BENCHMARK.json``, ``gossipbench/configs``, ``gossipbench/traffic``)."""

from __future__ import annotations

import copy
import json
import os

from gossipbench import spec

GRAPHS = {  # sizes over the configuration's own graph block
    "er100k": {"n": 400, "p": 0.03},
    "ba1m": {"n": 1500},
    "ba1m.mesh1x4": {"n": 1500},
}
#: The mesh cell, whose files stay under ``gossipbench/`` while the cell
#: waits outside ``BENCHMARK.json`` for the program's counters to widen.
PENDING = {
    "config": {"name": "ba1m.mesh1x4", "source": "tests", "reduced": ["mesh"], "why": "tests",
               "file": "gossipbench/configs/ba1m.mesh1x4.json"},
    "workload": {"name": "flood.ba1m.mesh1x4.coverage128k", "config": "ba1m.mesh1x4",
                 "traffic": "coverage128k", "chips": 4, "why": "tests"},
    "metrics": ("node_updates_per_s.coverage", "ms_per_tick.coverage",
                "device_idle_pct.coverage", "device_ms_per_sim.coverage",
                "tick_roofline_pct.coverage"),
    "per_layer": {"name": "exchange_ms_per_tick", "unit": "ms", "better": "lower",
                  "source": "device_trace", "layer": "sharded exchange",
                  "moves": "node_updates_per_s.coverage",
                  "workloads": ["flood.ba1m.mesh1x4.coverage128k"]},
}
MESH = {"shares": 1, "nodes": 2, "exchange": "dense", "ring_mode": "auto"}
TRAFFIC = {
    "burst32k": {"gen": {"kind": "uniform_ticks", "shares": 320, "lo": 0, "hi": 16},
                 "chunk_size": 128},
    "coverage4k": {"gen": {"kind": "uniform_ticks", "shares": 96, "lo": 0, "hi": 1}},
    "renewal": {"horizon": 100, "chunk_size": 256},
    "coverage128k": {"gen": {"kind": "uniform_ticks", "shares": 192, "lo": 0, "hi": 1},
                     "chunk_size": 192},
}
SIM_TIME, TICK_S = 5.0, 0.05  # renewal: 100 ticks, ~1.4 shares a node


def bench() -> dict:
    b = spec.load_benchmark()
    b["configs"].append(dict(PENDING["config"]))
    b["workloads"].append(dict(PENDING["workload"]))
    for m in b["end_to_end"] + b["per_layer"]:
        if m["name"] in PENDING["metrics"]:
            m["workloads"].append(PENDING["workload"]["name"])
    b["per_layer"].append(dict(PENDING["per_layer"]))
    for w in b["workloads"]:
        if w["chips"] > 1:
            w["chips"] = MESH["nodes"]
    return b


def config(name: str) -> dict:
    c = json.load(open(os.path.join(spec.HERE, "configs", f"{name}.json")))
    c["graph"] = dict(c["graph"], **GRAPHS[name])
    if "mesh" in c:
        c["mesh"] = dict(MESH)
        c["chips"] = MESH["nodes"]
    if "simTime" in c:
        c["simTime"], c["tick_s"] = SIM_TIME, TICK_S
    return c


def traffic(mix: str) -> dict:
    t = copy.deepcopy(spec.traffic_of(mix))
    t.update(copy.deepcopy(TRAFFIC[mix]))
    return t


def write_root(root: str) -> str:
    os.makedirs(os.path.join(root, "gossipbench", "configs"), exist_ok=True)
    os.makedirs(os.path.join(root, "gossipbench", "traffic"), exist_ok=True)
    b = bench()
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(b, f)
    for c in b["configs"]:
        with open(os.path.join(root, c["file"]), "w") as f:
            json.dump(config(c["name"]), f)
    for w in b["workloads"]:
        with open(os.path.join(root, "gossipbench", "traffic", f"{w['traffic']}.json"), "w") as f:
            json.dump(traffic(w["traffic"]), f)
    return root
