"""The comparison fails what it has to fail. The control (the plain
reference with one lost delivery, in the program's place) comes out not
correct in every cell; so does a run with the program broken underneath
its timed path, for each fault a cell can have: a tick that returns its
state unchanged, half of the batch left out, the exchange between cards
left out (the mesh cell), an answer altered where it is produced."""

import json
import os
import subprocess
import sys

import pytest
import torch

from gossipbench import check, harness, spec
from gossipbench.tests import faulty, tiny

CPU = torch.device("cpu")
ONE_CARD = [("flood.er100k.burst32k", "burst32k", "er100k"),
            ("flood.ba1m.coverage4k", "coverage4k", "ba1m"),
            ("flood.er100k.renewal", "renewal", "er100k")]
ENV = dict(os.environ, OMP_NUM_THREADS="1")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def run_tiny(mix, cfg, seed, control=False):
    cell = spec.Cell("t", 1, tiny.config(cfg), tiny.traffic(mix), [], [])
    run = harness.run_cell(cell, seed, 0.2, False, harness.World(CPU), control=control)
    return check.verdict(run.per_sim)


@pytest.mark.parametrize("name,mix,cfg", ONE_CARD)
def test_sound_run_is_correct(name, mix, cfg):
    correct, table, failed = run_tiny(mix, cfg, 2**31 + 3)
    assert correct and failed == 0, table


@pytest.mark.parametrize("seed", [11, 2**31 + 12, 13])
@pytest.mark.parametrize("name,mix,cfg", ONE_CARD)
def test_control_is_not_correct(name, mix, cfg, seed):
    correct, table, failed = run_tiny(mix, cfg, seed, control=True)
    assert not correct and failed >= 1
    assert table["counters_bad"]["value"] >= 3  # received, forwarded, processed, sent


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("name,mix,cfg", ONE_CARD)
def test_fault_is_not_correct(name, mix, cfg, fault, monkeypatch):
    faulty.install(fault, monkeypatch)
    correct, table, _ = run_tiny(mix, cfg, 2**31 + 5)
    assert not correct, table


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.write_root(str(tmp_path_factory.mktemp("tiny")))


def mesh_run(root, fault=None, control=0, seed=2**31 + 21):
    """The mesh cell on 2 gloo ranks, both broken alike."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    args = ["--device", "cpu", "--root", root, "--workload", "flood.ba1m.mesh1x4.coverage128k",
            "--seed", str(seed), "--seconds", "0.3", "--control", str(control),
            "--port", str(port)]
    head = ["-m", "gossipbench"] if fault is None else ["-m", "gossipbench.tests.faulty", fault]
    procs = [subprocess.Popen([sys.executable, *head, *args, "--rank", str(r)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              cwd=spec.ROOT, env=ENV) for r in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs[0][1][-3000:] + outs[1][1][-3000:]
    return json.loads(outs[0][0].strip().splitlines()[-1])


@pytest.mark.parametrize("fault", ["exchange", "unchanged", "half"])
def test_mesh_fault_is_not_correct(root, fault):
    line = mesh_run(root, fault)
    assert line["correct"] is False and line["failed"] >= 1


def test_mesh_sound_and_control(root):
    assert mesh_run(root)["correct"] is True
    line = mesh_run(root, control=1)
    assert line["correct"] is False and line["checks"]["counters_bad"]["value"] >= 3
