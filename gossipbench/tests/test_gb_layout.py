"""BENCHMARK.json and the files it names: every cell resolves to its
configuration, traffic mix, entry and metric readers by name, and the
file keeps the contract's shapes."""

import json
import os
import re

import pytest

from gossipbench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["gossipbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(spec.ROOT, "BENCHMARK.json")) <= 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_by_name(cell):
    c = spec.cell(cell)
    assert c.chips in (1, 4)
    assert os.path.exists(os.path.join(spec.HERE, "entries", f"{c.entry}.py"))
    mod = spec.entry(c.entry)
    for fn in ("prepare", "stage", "run", "ticks", "reference", "release"):
        assert callable(getattr(mod, fn))
    assert set(c.traffic) <= set(spec.TRAFFIC_KEYS + mod.TRAFFIC_KEYS)
    for m in c.per_layer + c.end_to_end:
        assert callable(spec.metric_reader(m["name"]))
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer


def test_entries_keys_and_names():
    seen = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("gossipbench/")
        cfg = json.load(open(os.path.join(spec.ROOT, c["file"])))
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert len(c["source"]) <= 200 and len(cfg["source"]) <= 200
        seen.add(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["config"] in seen and NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(pairs) // 4)
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == seen


def test_metrics_keys():
    names = []
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        names.append(m["name"])
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in names
        for cell in m.get("workloads", CELLS):
            assert cell in CELLS
            moved = [e for e in BENCH["end_to_end"] if e["name"] == m["moves"]][0]
            assert cell in moved.get("workloads", CELLS)
        layers.setdefault(m["layer"], m["name"])
        names.append(m["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    assert len(names) == len(set(names))


def _root_with(tmp_path, mix=None, config=None, gen=None, graph=None):
    """A checkout root of one cell whose files carry the given extra keys."""
    from gossipbench.tests import tiny

    root = tiny.write_root(str(tmp_path))
    t = os.path.join(root, "gossipbench", "traffic", "burst32k.json")
    c = os.path.join(root, "gossipbench", "configs", "er100k.json")
    for path, extra, inner in ((t, mix, None), (t, gen, "gen"), (c, config, None),
                               (c, graph, "graph")):
        if extra:
            d = json.load(open(path))
            (d[inner] if inner else d).update(extra)
            json.dump(d, open(path, "w"))
    return root


@pytest.mark.parametrize("extra", [{"mix": {"loss": 0.05}}, {"config": {"churn": 0.1}},
                                   {"config": {"mesh": {"nodes": 2}}}])
def test_key_read_by_nothing_is_refused(tmp_path, extra):
    """A traffic or configuration key that the entry does not read (loss,
    churn) would run without it and read correct: it is refused."""
    root = _root_with(tmp_path, **extra)
    with pytest.raises(ValueError, match="read by nothing"):
        spec.cell("flood.er100k.burst32k", root=root)


@pytest.mark.parametrize("extra", [{"gen": {"burst": 4}}, {"graph": {"m": 3}}])
def test_generator_key_read_by_nothing_is_refused(tmp_path, extra):
    from gossipbench import harness

    root = _root_with(tmp_path, **extra)
    c = spec.cell("flood.er100k.burst32k", root=root)
    with pytest.raises(ValueError):
        if "gen" in extra:
            harness.draw(c, 1, 2, 0)
        else:
            harness.graph_edges(c.config, 1, write=False)


def test_end_to_end_read_by_name():
    rec = {"updates": 6_000, "window_s": 2.0, "setup_s": 7.5, "walls": [0.1] * 19 + [0.3]}
    assert spec.metric_reader("node_updates_per_s")(rec) == 3_000.0
    assert spec.metric_reader("node_updates_per_s.coverage")(rec) == 3_000.0
    assert spec.metric_reader("setup_s")(rec) == 7.5
    assert abs(spec.metric_reader("sim_wall_p95_ms")(rec) - 110.0) < 1e-9


def test_device_ms_per_sim_reads_the_mean_busy_time():
    rec = {"on_device": True, "sims": 4, "traces": [{"busy_s": 0.2}, {"busy_s": 0.4}]}
    assert abs(spec.metric_reader("device_ms_per_sim.coverage")(rec) - 75.0) < 1e-9
    assert spec.metric_reader("device_ms_per_sim")(dict(rec, on_device=False)) is None
