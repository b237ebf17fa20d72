"""chip_smoke.py's phase 20, rehearsed on the CPU: the static-analysis
gate's body (`chip_smoke.staticcheck_phase`) without the sync-debug mode,
the CPU audit beside itself; its ``staticcheck`` line's keys, every
kernel run by some entry; and its cross-checks,
each refusing the disagreement it names."""

import os
import sys

import pytest
import torch

from p2p_gossip_tpu_torch.ops import kernels

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread in this process: several test workers on a shared
    host oversubscribe the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def phase20():
    return chip_smoke.staticcheck_phase(CPU)


def test_staticcheck_line_keys(phase20):
    record = phase20["record"]
    assert len(record) == 43
    for entry, row in record.items():
        assert set(row) == {"host_reads_per_tick", "syncs", "launches"}, entry
        assert row["syncs"] is None  # no sync-debug mode on the CPU
    assert record["engine.sync._run_chunk_while"]["host_reads_per_tick"] == 1.0
    assert record["parallel.engine_sharded._Runner.run_pass"]["host_reads_per_tick"] == 1.0


def test_every_kernel_but_the_atomic_scatter_is_run(phase20):
    """On the CPU the launches are the plain twins the entries called: every
    kernel's."""
    assert set(phase20["launches"]) == set(kernels.launches)
    assert all(n > 0 for n in phase20["launches"].values())


def _entry(**kw):
    row = dict(entry="e", host_reads_per_tick=1.0, host_reads=9, h2d=3, syncs=None,
               kernels={"gather_or": 8})
    row.update(kw)
    return row


@pytest.mark.parametrize("fault,on_card", [
    ("reads", False), ("syncs", True), ("kernels", False), ("missing", False)])
def test_check_staticcheck_refuses(fault, on_card):
    cpu = dict(entries=[_entry()])
    card = dict(entries=[_entry(syncs=12 if on_card else None)])
    assert chip_smoke.check_staticcheck(cpu, card, on_card) == []
    if fault == "reads":
        card["entries"][0]["host_reads_per_tick"] = 2.0
    elif fault == "syncs":
        card["entries"][0]["syncs"] = 13  # budget: 9 reads + 3 stagings
    elif fault == "kernels":
        card["entries"][0]["kernels"] = {"gather_or": 8, "tick_digest": 8}
    else:
        card["entries"][0]["entry"] = "f"
    assert chip_smoke.check_staticcheck(cpu, card, on_card)
