"""The port's protocol comparison (``p2p_gossip_tpu_torch.protocol_compare``)
against the JAX package's ``scripts/protocol_compare.py`` on the CPU: on
one small graph the four runs' rows (flood, push-pull, pull, fanout push)
equal the JAX script's field for field, apart from ``wall_s`` (the rows
hold integer counters and their exact ratios); the table's shape; and the
default device is the card."""

import json
import os
import subprocess
import sys

import pytest
import torch

from p2p_gossip_tpu_torch import protocol_compare

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--nodes", "300", "--prob", "0.03", "--shares", "8", "--horizon", "24"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread in this process (its spawned ranks already run
    one): several test workers on a shared host oversubscribe the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _rows(record):
    return [{k: v for k, v in r.items() if k != "wall_s"} for r in record["results"]]


@pytest.fixture(scope="module")
def jax_record():
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "scripts/protocol_compare.py", "--cpu", "--json",
                          *SMALL], cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_rows_match_jax(jax_record, capsys):
    assert protocol_compare.main(["--device", "cpu", "--json", *SMALL]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [r["protocol"] for r in got["results"]] == ["flood", "pushpull", "pull", "pushk(k=3)"]
    assert _rows(got) == _rows(jax_record)
    assert all(r["wall_s"] >= 0 for r in got["results"])
    assert got["config"]["device"] == "cpu"
    assert {k: got["config"][k] for k in jax_record["config"] if k != "cpu"} == {
        k: v for k, v in jax_record["config"].items() if k != "cpu"}


def test_table_has_a_row_per_protocol(capsys):
    assert protocol_compare.main(["--device", "cpu", *SMALL]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("N=300 edges=") and "target=99%" in lines[0]
    assert lines[1].split() == ["protocol", "reached_fraction", "ttc_median_ticks",
                                "final_coverage_mean", "sends_per_delivery", "total_sent",
                                "p95_latency_ticks", "wall_s"]
    assert [line.split()[0] for line in lines[2:]] == ["flood", "pushpull", "pull",
                                                       "pushk(k=3)"]


def test_default_device_is_cuda():
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        protocol_compare.main(SMALL)
