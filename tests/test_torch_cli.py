"""``python -m p2p_gossip_tpu_torch`` against ``python -m p2p_gossip_tpu``:
the same flags print the same stdout. Only two lines may differ: the start
line's ``backend=...`` / ``device=...`` suffix and the wall-time line.

The port runs with ``--device cpu`` (its kernels' plain torch versions),
the JAX package on the CPU (``JAX_PLATFORMS=cpu``)."""

import json
import os
import re
import subprocess
import sys

import pytest

from p2p_gossip_tpu.utils import cli as jax_cli
from p2p_gossip_tpu_torch.utils import cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

OPTIONS = [
    "--numNodes", "60", "--simTime", "20", "--statsInterval", "5",
    "--churnProb", "0.2", "--lossProb", "0.1", "--connectAtTick", "300",
    "--delayModel", "lognormal",
]


def _engine_free(start_line: str) -> str:
    """The start line without its engine: ``backend=...`` in the JAX CLI;
    ``device=...`` (the default engine) or ``backend=...`` (event, native)
    in the port's. The graph-builder note after it stays."""
    return re.sub(r", (backend|device)=[^,]*", "", start_line, count=1)


def _assert_same_report(port: str, want: str) -> None:
    p, w = port.splitlines(), want.splitlines()
    assert len(p) == len(w), (port, want)
    start = "Starting gossip network simulation: "
    assert p[0].startswith(start) and w[0].startswith(start)
    assert _engine_free(p[0]) == _engine_free(w[0])
    assert p[-1].startswith("Simulated ") and w[-1].startswith("Simulated ")
    assert p[1:-1] == w[1:-1]


def _run_module(module, args):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", module, *args], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


def test_reference_defaults_print_the_jax_report():
    """The reference's default run: the five periodic-stats blocks (10 s
    intervals of a 60 s run), every node line and the totals."""
    port = _run_module("p2p_gossip_tpu_torch", ["--device", "cpu"])
    want = _run_module("p2p_gossip_tpu", [])
    _assert_same_report(port, want)
    blocks = [ln for ln in port.splitlines() if ln.startswith("=== Periodic Stats at ")]
    assert blocks == [f"=== Periodic Stats at {s}s ===" for s in (10, 20, 30, 40, 50)]


def _run_in_process(run, args, capsys):
    assert run(args) == 0
    return capsys.readouterr().out


@pytest.mark.parametrize("name,args", [
    ("options", OPTIONS),
    ("flood_coverage", ["--floodCoverage", "16"]),
    ("serialization", ["--numNodes", "30", "--simTime", "6", "--statsInterval", "1.5",
                       "--delayModel", "serialization", "--shareBytes", "8000",
                       "--churnProb", "0.3", "--churnDowntime", "0.5",
                       "--churnOutages", "2", "--perNodeStats"]),
    ("coverage_under_loss", ["--numNodes", "200", "--connectionProb", "0.03",
                             "--floodCoverage", "12", "--lossProb", "0.4",
                             "--churnProb", "0.3", "--coverageFraction", "0.9",
                             "--delayModel", "lognormal"]),
])
def test_option_flags_print_the_jax_report(name, args, tmp_path, capsys):
    jax_args, port_args = list(args), list(args)
    if name == "options":  # a fresh checkpoint file for each package
        jax_args += ["--checkpoint", str(tmp_path / "jax.npz")]
        port_args += ["--checkpoint", str(tmp_path / "port.npz")]
    want = _run_in_process(jax_cli.run, jax_args, capsys)
    port = _run_in_process(cli.run, port_args + ["--device", "cpu"], capsys)
    _assert_same_report(port, want)
    if name == "options":
        assert "Churn enabled: " in port
        assert port.count("=== Periodic Stats at ") == 3
        # A second run resumes from its own checkpoint past the last chunk
        # and prints the same report.
        again = _run_in_process(cli.run, port_args + ["--device", "cpu"], capsys)
        _assert_same_report(again, want)


@pytest.mark.parametrize("args", [
    ["--lossProb", "1.5"],
    ["--churnProb", "-0.1"],
    ["--connectAtTick", "-1"],
    ["--connectAtTick", "5", "--floodCoverage", "3"],
    ["--floodCoverage", "-2"],
    ["--floodCoverage", "2", "--coverageFraction", "0"],
    ["--checkpointEvery", "0"],
    ["--delayModel", "serialization", "--bandwidthMbps", "0"],
])
def test_bad_option_flags_exit_2_as_in_jax(args, capsys):
    assert jax_cli.run(args) == 2
    assert "error" in capsys.readouterr().err
    assert cli.run(args + ["--device", "cpu"]) == 2
    assert "error" in capsys.readouterr().err


# --- the protocols, topologies, generation models, --json and --anim --------

PROTOCOL = ["--numNodes", "40", "--simTime", "4", "--Latency", "50"]


def _split_tail(out: str, prefix: str):
    """(report without its last line, that line), the line starting with
    ``prefix``."""
    head, _, last = out.rstrip("\n").rpartition("\n")
    assert last.startswith(prefix), out
    return head + "\n", last


@pytest.mark.parametrize("name,args", [
    ("pushpull", PROTOCOL + ["--protocol", "pushpull", "--delayModel", "lognormal"]),
    ("pull", PROTOCOL + ["--protocol", "pull", "--churnProb", "0.3", "--lossProb", "0.2"]),
    ("pushk", PROTOCOL + ["--protocol", "pushk", "--fanout", "3", "--lossProb", "0.1"]),
    ("pushpull_coverage", PROTOCOL + ["--protocol", "pushpull", "--floodCoverage", "9",
                                      "--churnProb", "0.2", "--delayModel", "lognormal"]),
    ("pull_coverage", PROTOCOL + ["--protocol", "pull", "--floodCoverage", "7",
                                  "--lossProb", "0.3", "--coverageFraction", "0.9"]),
    ("pushk_coverage", PROTOCOL + ["--protocol", "pushk", "--fanout", "3",
                                   "--floodCoverage", "8"]),
])
def test_protocol_flags_print_the_jax_report(name, args, capsys):
    want = _run_in_process(jax_cli.run, args, capsys)
    port = _run_in_process(cli.run, args + ["--device", "cpu"], capsys)
    _assert_same_report(port, want)
    title = "Coverage (" if "coverage" in name else "Total shares sent: "
    assert title in port
    if "coverage" in name:
        assert f"=== {name.split('_')[0]} Coverage (" in port


@pytest.mark.parametrize("name,args", [
    ("ws", ["--numNodes", "50", "--topology", "ws", "--wsK", "6", "--wsBeta", "0.3",
            "--simTime", "12"]),
    ("grid", ["--numNodes", "42", "--topology", "grid", "--simTime", "12"]),
    ("torus", ["--numNodes", "48", "--topology", "torus", "--gridCols", "8",
               "--simTime", "12", "--protocol", "pushpull", "--Latency", "50"]),
    ("complete", ["--numNodes", "12", "--topology", "complete", "--simTime", "12"]),
    ("ba", ["--numNodes", "60", "--topology", "ba", "--baM", "2", "--simTime", "12",
            "--delayModel", "lognormal"]),
    ("poisson", ["--numNodes", "50", "--genModel", "poisson", "--poissonRate", "0.8",
                 "--simTime", "12", "--statsInterval", "3"]),
    ("gen_window", ["--numNodes", "30", "--genLo", "0.5", "--genHi", "1.5",
                    "--simTime", "6", "--protocol", "pushk", "--Latency", "50"]),
])
def test_topology_and_generation_flags_print_the_jax_report(name, args, capsys):
    want = _run_in_process(jax_cli.run, args, capsys)
    port = _run_in_process(cli.run, args + ["--device", "cpu"], capsys)
    _assert_same_report(port, want)


def _json_line(out: str) -> dict:
    """The --json line with its timing fields dropped and the engine keys
    (``backend`` in the JAX CLI, ``device`` too in the port's) set aside."""
    head, last = _split_tail(out, "{")
    record = json.loads(last)
    for key in ("wall_s", "node_updates_per_s"):
        record.pop(key, None)
    config = record["config"]
    assert [config.pop(key) for key in ("backend", "device") if key in config]
    return head, record


@pytest.mark.parametrize("args", [
    ["--numNodes", "30", "--simTime", "10"],
    PROTOCOL + ["--protocol", "pull"],
    PROTOCOL + ["--protocol", "pushk", "--floodCoverage", "6"],
])
def test_json_line_carries_the_jax_keys(args, capsys):
    want_head, want = _json_line(_run_in_process(jax_cli.run, args + ["--json"], capsys))
    port_head, got = _json_line(
        _run_in_process(cli.run, args + ["--json", "--device", "cpu"], capsys)
    )
    _assert_same_report(port_head, want_head)
    assert got == want


@pytest.mark.parametrize("topology", ["er", "torus"])
def test_anim_file_is_byte_equal(topology, tmp_path, capsys):
    args = ["--numNodes", "36", "--simTime", "6", "--topology", topology]
    jax_out = _run_in_process(jax_cli.run, args + ["--anim", str(tmp_path / "jax.xml")],
                              capsys)
    port_out = _run_in_process(
        cli.run, args + ["--anim", str(tmp_path / "port.xml"), "--device", "cpu"], capsys
    )
    jax_head, _ = _split_tail(jax_out, "NetAnim trace written to ")
    port_head, line = _split_tail(port_out, "NetAnim trace written to ")
    assert line.endswith("port.xml")
    _assert_same_report(port_head, jax_head)
    assert (tmp_path / "port.xml").read_bytes() == (tmp_path / "jax.xml").read_bytes()


PULL_BOUND = ["--protocol", "pull", "--numNodes", "2000", "--topology", "complete",
              "--chunkSize", "4000000", "--simTime", "1"]


@pytest.mark.parametrize("args", [
    ["--protocol", "pushk", "--fanout", "0"],
    ["--protocol", "pushk", "--fanout", "0", "--floodCoverage", "3"],
    ["--protocol", "pushpull", "--connectAtTick", "5"],
    ["--connectAtTick", "5", "--floodCoverage", "3"],
    # Degree 1,999 x a 2.2M-share chunk passes 2^32: the pull credit bound.
    PULL_BOUND + ["--genModel", "poisson", "--poissonRate", "1100"],
    PULL_BOUND + ["--floodCoverage", "2200000"],
    ["--topology", "grid", "--numNodes", "42", "--gridCols", "5"],
])
def test_shared_validations_print_the_jax_error(args, capsys):
    assert jax_cli.run(args) == 2
    want = capsys.readouterr().err
    assert cli.run(args + ["--device", "cpu"]) == 2
    got = capsys.readouterr().err
    assert got.startswith("error: ")
    assert got == want


# --- the refusals repaired, and the ones kept -----------------------------------

@pytest.mark.parametrize("args", [
    ["--numNodes", "1", "--simTime", "2"],
    ["--numNodes", "1", "--simTime", "2", "--protocol", "pushpull"],
    ["--numNodes", "1", "--simTime", "2", "--floodCoverage", "2"],
    ["--numNodes", "10", "--simTime", "-1"],
])
def test_degenerate_runs_print_the_jax_report(args, capsys):
    """One node, and a negative simulated time: the JAX CLI runs them (an
    all-zero report) and so does the port."""
    want = _run_in_process(jax_cli.run, args, capsys)
    port = _run_in_process(cli.run, args + ["--device", "cpu"], capsys)
    _assert_same_report(port, want)
    if "-1" in args:
        assert "0 shares scheduled, -200 ticks (-1s at 5ms)" in port.splitlines()[0]
    if "--floodCoverage" not in args:
        for total in ("generated", "received", "sent"):
            assert f"Total shares {total}: 0" in port.splitlines()


@pytest.mark.parametrize("args", [
    ["--numNodes", "0"],
    ["--Latency", "0"],
    ["--chunkSize", "0"],
])
def test_crashing_flags_exit_2(args, capsys):
    """Where the JAX CLI dies with a traceback, the port prints an error."""
    assert cli.run(args + ["--device", "cpu"]) == 2
    captured = capsys.readouterr()
    assert captured.err.startswith("error: ") and captured.out == ""


# --- --telemetry and --heartbeat -------------------------------------------------------

@pytest.fixture
def clean_telemetry(monkeypatch):
    from p2p_gossip_tpu import telemetry as jax_tel
    from p2p_gossip_tpu_torch import telemetry

    monkeypatch.delenv("P2P_TELEMETRY", raising=False)
    monkeypatch.delenv("P2P_HEARTBEAT", raising=False)
    for tel in (telemetry, jax_tel):
        tel.reset()
        tel.configure_heartbeat(None)
    yield
    for tel in (telemetry, jax_tel):
        tel.reset()
        tel.configure_heartbeat(None)


def _ring_and_digest_events(path):
    with open(path, encoding="utf-8") as f:
        events = [json.loads(line) for line in f]
    assert events[0]["type"] == "meta"
    return [e for e in events if e["type"] in ("ring", "digest")]


@pytest.mark.parametrize("name,args", [
    ("flood", ["--numNodes", "40", "--simTime", "6", "--chunkSize", "32",
               "--lossProb", "0.1", "--churnProb", "0.2"]),
    ("pushpull", PROTOCOL + ["--protocol", "pushpull", "--lossProb", "0.2",
                             "--delayModel", "lognormal"]),
])
def test_telemetry_stream_equals_the_jax_clis(name, args, tmp_path, capsys, clean_telemetry):
    """--telemetry leaves stdout as it was, and its ring and digest events
    equal the JAX CLI's for the same flags."""
    plain = _run_in_process(cli.run, args + ["--device", "cpu"], capsys)
    port = _run_in_process(
        cli.run, args + ["--device", "cpu", "--telemetry", str(tmp_path / "port.jsonl")],
        capsys)
    assert port.splitlines()[:-1] == plain.splitlines()[:-1]
    want = _run_in_process(jax_cli.run, args + ["--telemetry", str(tmp_path / "jax.jsonl")],
                           capsys)
    _assert_same_report(port, want)
    got_events = _ring_and_digest_events(tmp_path / "port.jsonl")
    want_events = _ring_and_digest_events(tmp_path / "jax.jsonl")
    assert got_events and got_events == want_events
    kernel = "engine.sync.run_sync_sim" if name == "flood" else "models.protocols.pushpull"
    assert {e["kernel"] for e in got_events} == {kernel}
    with open(tmp_path / "port.jsonl", encoding="utf-8") as f:
        spans = [e["name"] for e in map(json.loads, f) if e["type"] == "span"]
    assert {"build_graph", "schedule", "simulate", "dispatch", "d2h"} <= set(spans)


def test_heartbeat_flag_writes_its_file(tmp_path, capsys, clean_telemetry):
    from p2p_gossip_tpu_torch.telemetry import progress

    hb = tmp_path / "hb.json"
    out = _run_in_process(
        cli.run, ["--numNodes", "30", "--simTime", "4", "--device", "cpu",
                  "--heartbeat", str(hb)], capsys)
    assert "Total shares sent: " in out
    data = progress.read_heartbeat(str(hb))
    assert data["kernel"] == "engine.sync.run_sync_sim" and data["chunks_total"] == 1
    assert "digest_head" not in data  # telemetry off: no digests
    assert list(tmp_path.iterdir()) == [hb]


# --- --replicas, --sweep and --degreeBlock -------------------------------------------

def _assert_same_campaign(port: str, want: str) -> None:
    """A campaign report: the start line's backend/device suffix and the
    ``Campaign wall`` line may differ; a trailing --json line is compared
    as data, its engine key and wall time set aside."""
    p, w = port.splitlines(), want.splitlines()
    assert len(p) == len(w), (port, want)
    if p[-1].startswith("{"):
        got, exp = json.loads(p.pop()), json.loads(w.pop())
        for rec in (got, exp):
            rec["summary"].pop("wall_s")
            assert rec["config"].pop("backend", None) or rec["config"].pop("device", None)
        assert got == exp
    def start(line):
        return line.rsplit(", device=", 1)[0].rsplit(", backend=", 1)[0]

    assert start(p[0]) == start(w[0])
    (wall,) = [i for i, line in enumerate(w) if line.startswith("Campaign wall ")]
    assert p[wall].startswith("Campaign wall ")
    assert p[1:wall] + p[wall + 1:] == w[1:wall] + w[wall + 1:]
    assert "=== Campaign: " in port


CAMPAIGN_GOSSIP = ["--numNodes", "40", "--simTime", "0.5", "--genLo", "0.05",
                   "--genHi", "0.1", "--replicas", "3"]


@pytest.mark.parametrize("name,args", [
    ("flood_coverage", ["--numNodes", "64", "--floodCoverage", "4", "--replicas", "4",
                        "--simTime", "0.2"]),
    ("coverage_options", ["--numNodes", "64", "--floodCoverage", "5", "--replicas", "3",
                          "--simTime", "0.2", "--churnProb", "0.3", "--lossProb", "0.2",
                          "--delayModel", "lognormal", "--coverageFraction", "0.9",
                          "--degreeBlock", "16", "--json"]),
    ("gossip", CAMPAIGN_GOSSIP + ["--chunkSize", "32", "--churnProb", "0.2",
                                  "--lossProb", "0.1"]),
    ("pushpull", PROTOCOL + ["--replicas", "3", "--protocol", "pushpull", "--lossProb", "0.1",
                             "--delayModel", "lognormal", "--json"]),
    ("pull_coverage", PROTOCOL + ["--replicas", "3", "--protocol", "pull",
                                  "--floodCoverage", "6", "--churnProb", "0.2"]),
    ("pushk", PROTOCOL + ["--replicas", "2", "--protocol", "pushk", "--fanout", "3",
                          "--lossProb", "0.2", "--json"]),
])
def test_replicas_print_the_jax_campaign_report(name, args, capsys):
    want = _run_in_process(jax_cli.run, args, capsys)
    port = _run_in_process(cli.run, args + ["--device", "cpu"], capsys)
    _assert_same_campaign(port, want)
    if "--floodCoverage" in args:
        assert "coverage: mean " in port


def test_replicas_checkpoint_resumes(tmp_path, capsys):
    """--replicas with --checkpoint: a second run resumes past the last
    batch from the port's own file and prints the same report, and the
    JAX CLI resumes the port's file."""
    args = ["--numNodes", "64", "--floodCoverage", "4", "--replicas", "3", "--simTime",
            "0.2", "--checkpoint", str(tmp_path / "campaign.npz")]
    first = _run_in_process(cli.run, args + ["--device", "cpu"], capsys)
    again = _run_in_process(cli.run, args + ["--device", "cpu"], capsys)
    _assert_same_campaign(again, first)
    resumed_by_jax = _run_in_process(jax_cli.run, args, capsys)
    _assert_same_campaign(first, resumed_by_jax)


def test_sweep_prints_the_jax_records(tmp_path, capsys):
    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps({
        "numNodes": 40, "p": 0.15, "protocol": ["push", "pull"], "lossProb": [0.0, 0.2],
        "replicas": 3, "shares": 3, "horizon": 20,
    }))
    assert jax_cli.run(["--sweep", str(spec)]) == 0
    want = capsys.readouterr()
    assert cli.run(["--sweep", str(spec), "--device", "cpu"]) == 0
    got = capsys.readouterr()

    def records(out):
        recs = [json.loads(line) for line in out.splitlines()]
        for rec in recs:
            rec.pop("wall_s")
            rec["summary"].pop("wall_s")
        return recs

    assert len(records(got.out)) == 4
    assert records(got.out) == records(want.out)
    assert got.err.endswith(want.err[want.err.index("=== Campaign Report ===\n"):])


@pytest.mark.parametrize("args", [
    ["--replicas", "0"],
    ["--replicas", "2", "--anim", "x.xml"],
    ["--replicas", "2", "--genModel", "poisson"],
    ["--degreeBlock", "-1"],
    ["--degreeBlock", "-3", "--replicas", "2", "--floodCoverage", "2"],
    ["--sweep", "no-such-spec.json"],
])
def test_campaign_refusals_print_the_jax_error(args, capsys):
    assert jax_cli.run(args) == 2
    want = capsys.readouterr().err
    assert cli.run(args + ["--device", "cpu"]) == 2
    got = capsys.readouterr().err
    assert got.startswith("error: ")
    assert got == want


@pytest.mark.parametrize("content,message", [
    ("{not json", "error: --sweep "),
    ('{"bogus": 1}', "error: --sweep: unknown sweep keys ['bogus']"),
])
def test_bad_sweep_specs_exit_2(content, message, tmp_path, capsys):
    spec = tmp_path / "spec.json"
    spec.write_text(content)
    assert jax_cli.run(["--sweep", str(spec)]) == 2
    want = capsys.readouterr().err
    assert cli.run(["--sweep", str(spec), "--device", "cpu"]) == 2
    got = capsys.readouterr().err
    assert got == want and got.startswith(message)


def test_degree_block_changes_nothing(capsys):
    args = ["--numNodes", "30", "--simTime", "6"]
    plain = _run_in_process(cli.run, args + ["--device", "cpu"], capsys)
    blocked = _run_in_process(cli.run, args + ["--degreeBlock", "64", "--device", "cpu"],
                              capsys)
    assert plain.splitlines()[:-1] == blocked.splitlines()[:-1]


def test_replicas_with_telemetry_refuse_until_campaign_telemetry(tmp_path, capsys,
                                                                 clean_telemetry):
    """Campaign telemetry is ported, so --replicas with --telemetry no
    longer refuses: it runs, its report is the JAX CLI's, and its ring and
    digest events (one of each a replica, with ``replica`` and ``seed``)
    equal the JAX CLI's for the same flags."""
    args = ["--numNodes", "30", "--floodCoverage", "3", "--replicas", "2", "--simTime",
            "0.1"]
    port = _run_in_process(
        cli.run, args + ["--device", "cpu", "--telemetry", str(tmp_path / "port.jsonl")],
        capsys)
    want = _run_in_process(jax_cli.run, args + ["--telemetry", str(tmp_path / "jax.jsonl")],
                           capsys)
    _assert_same_campaign(port, want)
    got = _ring_and_digest_events(tmp_path / "port.jsonl")
    assert got and got == _ring_and_digest_events(tmp_path / "jax.jsonl")
    assert sorted((e["type"], e["replica"]) for e in got) == [
        ("digest", 0), ("digest", 1), ("ring", 0), ("ring", 1)]


# --- the host engines, graph files, the C++ builders, logs and the quirk --------

@pytest.fixture
def clean_logging():
    """Both packages' component-log rules (module globals a --log run sets)
    restored after the test."""
    from p2p_gossip_tpu.utils import logging as jax_log
    from p2p_gossip_tpu_torch.utils import logging as port_log

    def reset():
        for mod in (port_log, jax_log):
            mod._RULES.clear()
            for comp in mod._REGISTRY.values():
                comp.level = mod._DEFAULT_LEVEL
            mod.set_time_resolution(1.0)
            mod.set_stream(None)

    reset()
    yield
    reset()


@pytest.fixture
def one_thread():
    """One torch thread for the port's CPU tick engine: its (N, W) passes
    above torch's parallel grain would otherwise wait on busy cores when
    the suite runs in parallel workers (results are the same)."""
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _run_both(args, capsys, port_extra=("--device", "cpu")):
    """(port stdout, port stderr), (JAX stdout, JAX stderr), both exit 0."""
    assert jax_cli.run(list(args)) == 0
    want = capsys.readouterr()
    assert cli.run(list(args) + list(port_extra)) == 0
    got = capsys.readouterr()
    return (got.out, got.err), (want.out, want.err)


LINK_QUEUEING = ["--numNodes", "16", "--connectionProb", "0.2", "--simTime", "10",
                 "--seed", "2", "--linkQueueing", "--shareBytes", "8000"]
PARALLEL = ["--numNodes", "14", "--connectionProb", "0.12", "--simTime", "6", "--seed", "2",
            "--refParallelLinks"]


@pytest.mark.parametrize("name,args", [
    ("event_defaults", ["--backend", "event"]),
    ("native_defaults", ["--backend", "native"]),
    ("event_options", OPTIONS + ["--backend", "event"]),
    ("native_options", OPTIONS + ["--backend", "native"]),
    ("event_pushpull", PROTOCOL + ["--protocol", "pushpull", "--backend", "event"]),
    ("event_pull", PROTOCOL + ["--protocol", "pull", "--lossProb", "0.2", "--churnProb",
                               "0.3", "--backend", "event"]),
    ("native_pushk", PROTOCOL + ["--protocol", "pushk", "--fanout", "3", "--lossProb", "0.1",
                                 "--delayModel", "lognormal", "--backend", "native"]),
    ("event_link_queueing", LINK_QUEUEING + ["--backend", "event"]),
    ("native_link_queueing", LINK_QUEUEING + ["--backend", "native", "--delayModel",
                                              "lognormal"]),
    ("parallel_links", PARALLEL),
    ("event_parallel_links", PARALLEL + ["--backend", "event"]),
    ("native_builder_er", ["--numNodes", "300", "--connectionProb", "0.02", "--simTime", "4",
                           "--graphBuilder", "native"]),
    ("auto_builder_ba", ["--numNodes", "300", "--topology", "ba", "--simTime", "4",
                         "--graphBuilder", "auto", "--backend", "native"]),
])
def test_backend_and_graph_flags_print_the_jax_report(name, args, capsys, one_thread):
    """stdout and stderr equal the JAX CLI's for the host engines, FIFO link
    queueing, the parallel-link quirk and the C++ graph builders."""
    port_extra = ("--device", "cpu") if "--backend" not in args else ()
    (out, err), (want_out, want_err) = _run_both(args, capsys, port_extra)
    _assert_same_report(out, want_out)
    assert err == want_err
    first = out.splitlines()[0]
    if "--backend" in args:
        assert f"backend={args[args.index('--backend') + 1]}" in first
    if "Builder" in name or "builder" in name:
        assert first.endswith(", graph-builder=native")
    if "link_queueing" in name:
        assert "FIFO link queueing: 8000 B at 5 Mbps -> " in err
    if "parallel" in name:
        assert "parallel-link quirk: 1 doubled pair(s) across 2 node(s)" in err


@pytest.mark.parametrize("backend", ["event", "native"])
def test_host_backends_print_the_default_engines_counters(backend, capsys):
    """The reference defaults: the event and native engines print the
    per-node lines, periodic blocks and totals of the default engine."""
    assert cli.run(["--device", "cpu"]) == 0
    want = capsys.readouterr().out
    assert cli.run(["--backend", backend]) == 0
    got = capsys.readouterr().out
    assert got.splitlines()[1:-1] == want.splitlines()[1:-1]


@pytest.mark.parametrize("builder", ["python", "native"])
def test_graph_file_cold_warm_and_across_packages(builder, tmp_path, capsys, one_thread):
    """--graphFile: the cold run builds and saves, the warm run loads (the
    start line says graph-builder=cache) and prints the same report; each
    package's file serves the other's warm run."""
    args = ["--numNodes", "2000", "--connectionProb", "0.004", "--simTime", "0.5",
            "--graphBuilder", builder, "--perNodeStats"]
    port_file, jax_file = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    cold = _run_in_process(cli.run, args + ["--graphFile", port_file, "--device", "cpu"],
                           capsys)
    jax_cold = _run_in_process(jax_cli.run, args + ["--graphFile", jax_file], capsys)
    _assert_same_report(cold, jax_cold)
    assert cold.splitlines()[0].endswith(f", graph-builder={builder}")
    for graph_file in (jax_file, port_file):  # the JAX file first: across packages
        (warm, _), (jax_warm, _) = _run_both(args + ["--graphFile", graph_file], capsys)
        _assert_same_report(warm, jax_warm)
        assert warm.splitlines()[0].endswith(", graph-builder=cache")
        assert warm.splitlines()[1:-1] == cold.splitlines()[1:-1]


@pytest.mark.parametrize("case", ["other_topology", "other_builder", "corrupt",
                                  "other_nodes"])
def test_graph_file_refusals_print_the_jax_error(case, tmp_path, capsys):
    path = tmp_path / "g.npz"
    base = ["--numNodes", "30", "--simTime", "1", "--graphFile", str(path)]
    assert jax_cli.run(base + ["--seed", "2"]) == 0
    capsys.readouterr()
    args = {
        "other_topology": base + ["--seed", "2", "--topology", "ring"],
        "other_builder": base + ["--seed", "2", "--graphBuilder", "native"],
        "corrupt": base + ["--seed", "2"],
        "other_nodes": ["--numNodes", "31", "--graphFile", str(path)],
    }[case]
    if case == "corrupt":
        path.write_bytes(b"not a zip")
    assert jax_cli.run(args) == 2
    want = capsys.readouterr().err
    assert cli.run(args + ["--device", "cpu"]) == 2
    got = capsys.readouterr().err
    assert got.startswith("error: --graphFile") and got == want


@pytest.mark.parametrize("args", [
    ["--refParallelLinks", "--topology", "ring"],
    ["--refParallelLinks", "--graphBuilder", "native"],
    ["--refParallelLinks", "--protocol", "pushpull"],
    ["--refParallelLinks", "--connectAtTick", "100"],
    ["--graphBuilder", "native", "--topology", "ring"],
    ["--linkQueueing"],
    ["--linkQueueing", "--backend", "event", "--protocol", "pushpull"],
    ["--linkQueueing", "--backend", "native", "--delayModel", "serialization"],
    ["--linkQueueing", "--backend", "event", "--shareBytes", "-1"],
    ["--animMessages", "--anim", "unused.xml"],
    ["--animMessages", "--anim", "unused.xml", "--backend", "event", "--floodCoverage", "3"],
    ["--floodCoverage", "4", "--backend", "event"],
    ["--checkpoint", "unused.npz", "--backend", "native"],
    ["--protocol", "pushpull", "--backend", "event", "--delayModel", "lognormal"],
    ["--replicas", "2", "--backend", "native"],
    ["--log", "Engine.Event=loud"],
])
def test_new_flag_refusals_print_the_jax_error(args, capsys, clean_logging):
    assert jax_cli.run(args) == 2
    want = capsys.readouterr().err
    assert cli.run(args + ["--device", "cpu"]) == 2
    got = capsys.readouterr().err
    assert "error: " in got and got == want


SHARDED = {
    "flood_2_node_shards": ["--numNodes", "40", "--simTime", "1", "--genLo", "0.1",
                            "--genHi", "0.4", "--backend", "sharded", "--meshNodes", "2",
                            "--chunkSize", "64"],
    "coverage_sharded_ring": ["--numNodes", "60", "--simTime", "1", "--backend", "sharded",
                              "--meshNodes", "2", "--floodCoverage", "8",
                              "--ringMode", "sharded"],
    "options_2_share_shards": ["--numNodes", "60", "--simTime", "1", "--statsInterval", "0.25",
                               "--genLo", "0.1", "--genHi", "0.4",
                               "--backend", "sharded", "--meshNodes", "1", "--meshShares", "2",
                               "--ringMode", "replicated", "--delayModel", "lognormal",
                               "--churnProb", "0.2", "--lossProb", "0.1", "--chunkSize", "64"],
    "pushpull_2_node_shards": ["--numNodes", "40", "--simTime", "1", "--Latency", "50",
                               "--genLo", "0.1", "--genHi", "0.4", "--protocol", "pushpull",
                               "--backend", "sharded", "--meshNodes", "2", "--chunkSize", "64",
                               "--delayModel", "lognormal", "--lossProb", "0.1"],
    "pull_coverage": ["--numNodes", "40", "--simTime", "1", "--Latency", "50",
                      "--protocol", "pull", "--backend", "sharded", "--meshNodes", "2",
                      "--floodCoverage", "8", "--churnProb", "0.2"],
    "pushk_2_share_shards": ["--numNodes", "40", "--simTime", "1", "--Latency", "50",
                             "--genLo", "0.1", "--genHi", "0.4", "--protocol", "pushk",
                             "--fanout", "3", "--backend", "sharded", "--meshNodes", "1",
                             "--meshShares", "2", "--ringMode", "replicated",
                             "--chunkSize", "64"],
}


@pytest.fixture(scope="module")
def sharded_cli():
    """Each SHARDED command line's (exit code, stdout, stderr) on each of
    two spawned gloo ranks."""
    from p2p_gossip_tpu_torch.parallel import launch

    argvs = [args + ["--device", "cpu"] for args in SHARDED.values()]
    ranks = launch.spawn(launch.capture_cli, 2, argvs, timeout_s=120.0)
    return {name: [r[i] for r in ranks] for i, name in enumerate(SHARDED)}


@pytest.mark.parametrize("name", list(SHARDED))
def test_sharded_backend_prints_the_jax_report(name, sharded_cli, capsys):
    """Rank 0 prints the JAX CLI's stdout at the same mesh shape, its mesh
    line included; rank 1 prints nothing."""
    want = _run_in_process(jax_cli.run, SHARDED[name], capsys)
    (rc0, out0, _), (rc1, out1, _) = sharded_cli[name]
    assert rc0 == 0 and rc1 == 0
    _assert_same_report(out0, want)
    mesh = [ln for ln in out0.splitlines() if ln.startswith("Mesh: ")]
    shares = SHARDED[name][SHARDED[name].index("--meshShares") + 1] if (
        "--meshShares" in SHARDED[name]) else "1"
    nodes = SHARDED[name][SHARDED[name].index("--meshNodes") + 1]
    assert mesh == [f"Mesh: {shares} share-shards x {nodes} node-shards"]
    assert "Total shares generated: 0" not in out0
    assert out1 == ""


@pytest.mark.parametrize("args,message", [
    (["--meshNodes", "2"], "mesh 1x2 needs 2 ranks, have 1"),
    (["--meshShares", "0"], "--meshNodes must be >= 0 and --meshShares >= 1"),
    (["--meshNodes", "-1"], "--meshNodes must be >= 0 and --meshShares >= 1"),
])
def test_sharded_mesh_refusals_exit_2(args, message, capsys):
    """A mesh larger than the world (one rank here) and the JAX CLI's
    mesh-flag validation exit 2."""
    assert cli.run(["--backend", "sharded", "--device", "cpu", "--numNodes", "8",
                    "--simTime", "0.1"] + args) == 2
    assert message in capsys.readouterr().err


@pytest.mark.parametrize("name,args", [
    ("event_logic", ["--numNodes", "8", "--simTime", "4", "--backend", "event",
                     "--log", "*=logic"]),
    ("sync_debug", ["--numNodes", "30", "--simTime", "4", "--chunkSize", "32",
                    "--log", "*=debug"]),
    ("native_info", ["--numNodes", "12", "--simTime", "1", "--backend", "native",
                     "--log", "Engine.Event=info:*=warn"]),
])
def test_log_flag_prints_the_jax_lines(name, args, capsys, clean_logging):
    """--log: the same component lines on stderr, line for line, with the
    tick -> seconds prefixes."""
    (out, err), (want_out, want_err) = _run_both(
        args, capsys, () if "--backend" in args else ("--device", "cpu"))
    _assert_same_report(out, want_out)
    assert err.splitlines() == want_err.splitlines()
    if name == "event_logic":
        assert "[Engine.Event] INFO: starting event simulation: 8 nodes" in err
        assert "s [Engine.Event] LOGIC: Node " in err
    if name == "sync_debug":
        assert "[Engine.Sync] DEBUG: chunk 0: " in err


def test_anim_messages_file_is_byte_equal(tmp_path, capsys):
    """--animMessages with the event engine: the NetAnim file with its
    per-message <p> events equals the JAX CLI's byte for byte."""
    args = ["--numNodes", "12", "--connectionProb", "0.3", "--simTime", "5",
            "--backend", "event", "--seed", "2", "--lossProb", "0.2", "--churnProb",
            "0.3", "--animMessages"]
    (out, _), (want, _) = _run_both(
        args + ["--anim", str(tmp_path / "port.xml")], capsys, ())
    assert jax_cli.run(args + ["--anim", str(tmp_path / "jax.xml")]) == 0
    want = capsys.readouterr().out
    port_head, _ = _split_tail(out, "NetAnim trace written to ")
    jax_head, _ = _split_tail(want, "NetAnim trace written to ")
    _assert_same_report(port_head, jax_head)
    text = (tmp_path / "port.xml").read_text()
    assert text == (tmp_path / "jax.xml").read_text()
    for outcome in ("delivered", "duplicate", "lost"):
        assert f'outcome="{outcome}"' in text
