"""Whole runs of the command on the CPU, at the tiny sizes: the result
line's keys, the checks printed last on standard error, no JAX module
loaded, and a failed run without a card."""

import json
import os
import subprocess
import sys

import pytest

from gossipbench import spec
from gossipbench.tests import tiny

ENV = dict(os.environ, OMP_NUM_THREADS="1")
ENV.pop("JAX_PLATFORMS", None)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.write_root(str(tmp_path_factory.mktemp("tiny")))


def cli(root, *args, timeout=240):
    return subprocess.run([sys.executable, "-m", "gossipbench", "--device", "cpu", "--root", root,
                           *args], capture_output=True, text=True, cwd=spec.ROOT, env=ENV,
                          timeout=timeout)


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", ["flood.er100k.burst32k", "flood.ba1m.mesh1x4.coverage128k"])
def test_whole_run(root, cell, trace):
    out = cli(root, "--workload", cell, "--seed", str(2**31 + 99), "--seconds", "0.5",
              "--trace", str(trace))
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    assert list(line)[-1] == "checks"
    for k in ("correct", "attempted", "failed", "metrics", "device"):
        assert k in line
    c = spec.cell(cell, root=root)
    want = [m["name"] for m in (c.per_layer if trace else c.end_to_end)]
    if trace:  # on the CPU the device's readers find nothing to read
        host = {n for n in want if n.split(".")[0] in ("stage_s", "ms_per_tick")}
        assert set(line["metrics"]) == host and len(host) == 2
        assert "breakdown" in line and line["device"]["window_s"] > 0
    else:
        assert set(line["metrics"]) == set(want)
    tail = out.stderr.strip().splitlines()[-len(line["checks"]):]
    assert all(t.startswith("check ") for t in tail)
    assert "JAX modules loaded" not in out.stderr


def test_no_card_no_result(root):
    """On a machine without CUDA the default device refuses to run."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "-m", "gossipbench", "--root", root, "--workload",
                          "flood.er100k.burst32k", "--seed", "1", "--seconds", "1"],
                         capture_output=True, text=True, cwd=spec.ROOT, env=ENV, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_folder_alone_fails(tmp_path):
    """Without the program beside it the benchmark prints no result."""
    import shutil

    shutil.copytree(spec.HERE, tmp_path / "gossipbench")
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), tmp_path)
    out = subprocess.run([sys.executable, "-m", "gossipbench", "--device", "cpu", "--workload",
                          "flood.er100k.burst32k", "--seed", "1", "--seconds", "1"],
                         capture_output=True, text=True, cwd=tmp_path, env=ENV, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""
