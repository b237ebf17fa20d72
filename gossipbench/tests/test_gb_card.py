"""One short run of each cell on the card, at the cell's own size (the
chip: ``python3 -m pytest gossipbench/tests -m card``)."""

import json
import subprocess
import sys

import pytest

from gossipbench import spec

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(card, cell):
    import torch

    chips = spec.cell(cell).chips
    if torch.cuda.device_count() < chips:
        pytest.skip(f"{cell} needs {chips} cards")
    out = subprocess.run([sys.executable, "-m", "gossipbench", "--workload", cell,
                          "--seed", str(2**31 + 404), "--seconds", "3", "--trace", "0"],
                         capture_output=True, text=True, cwd=spec.ROOT, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == chips
