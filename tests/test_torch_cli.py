"""``python -m p2p_gossip_tpu_torch`` against ``python -m p2p_gossip_tpu``:
the same flags print the same stdout. Only two lines may differ: the start
line's ``backend=...`` / ``device=...`` suffix and the wall-time line.

The port runs with ``--device cpu`` (its kernels' plain torch versions),
the JAX package on the CPU (``JAX_PLATFORMS=cpu``)."""

import os
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


def _assert_same_report(port: str, want: str) -> None:
    p, w = port.splitlines(), want.splitlines()
    assert len(p) == len(w), (port, want)
    start = "Starting gossip network simulation: "
    assert p[0].startswith(start) and w[0].startswith(start)
    assert p[0].rsplit(", device=", 1)[0] == w[0].rsplit(", backend=", 1)[0]
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
