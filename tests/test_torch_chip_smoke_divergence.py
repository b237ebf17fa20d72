"""chip_smoke.py's phase 18, rehearsed on the CPU at small sizes: (a) the
divergence bisector at its defaults, every pair clean and its two streams
equal on both sides (here both sides are the CPU), the injected fault at
tick 4 located on every pair and the tick-7 reports equal; (b) every pair
clean at the rehearsal's "full" sizes, one wall a pair; (c) the protocol
comparison's rows equal on both sides at N = 2,000 apart from ``wall_s``,
and its table at the rehearsal's large configuration. The CPU launches no
kernel, which the phase's launch checks require here.

One world of 4 spawned gloo ranks runs the phase's sharded pairs once;
the tests read the phase's records."""

import os
import sys

import pytest
import torch

from p2p_gossip_tpu_torch import divergence

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

SMALL_FULL = {
    "native-sync": dict(n=200, p=0.03, shares=16, horizon=16, chunk=16),
    "sync-campaign": dict(n=1000, p=0.01, shares=256, horizon=16, chunk=256),
    "pushpull-campaign": dict(n=1000, p=0.01, shares=128, horizon=16, chunk=128),
}
SMALL_SHARDED = dict(n=1000, p=0.01, shares=64, horizon=16, chunk=64)
SMALL_COMPARE = dict(nodes=3000, prob=0.003, shares=16, horizon=24, fanout=3)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread in this process (its spawned ranks already run
    one): several test workers on a shared host oversubscribe the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def records():
    saved = (chip_smoke.BISECT_FULL, chip_smoke.BISECT_SHARDED_FULL, chip_smoke.COMPARE_FULL)
    chip_smoke.BISECT_FULL = SMALL_FULL
    chip_smoke.BISECT_SHARDED_FULL = SMALL_SHARDED
    chip_smoke.COMPARE_FULL = SMALL_COMPARE
    try:
        cpu = torch.device("cpu")
        yield chip_smoke.bisect_phase(cpu), chip_smoke.compare_phase(cpu)
    finally:
        (chip_smoke.BISECT_FULL, chip_smoke.BISECT_SHARDED_FULL,
         chip_smoke.COMPARE_FULL) = saved


@pytest.mark.parametrize("name", divergence.PAIRS)
def test_every_pair_is_clean_at_the_defaults(name, records):
    pair = records[0]["pairs_a"][name]
    assert pair["compared"] > 0 and min(pair["ticks"]) > chip_smoke.BISECT_FAULT_TICK
    # At tick 7 the flood campaigns' streams (ticks 0-6) miss it, as in the
    # JAX script; every other pair locates it.
    assert pair["late_located"] == (name not in ("sync-campaign", "sharded-campaign"))


def test_full_width_walls_cover_every_pair(records):
    rec = records[0]
    assert set(rec["walls_b_s"]) == set(divergence.PAIRS)
    assert all(w > 0 for w in rec["walls_b_s"].values())
    assert rec["sizes_b"]["sharded"] == SMALL_SHARDED


def test_comparison_rows_and_table(records):
    rec = records[1]
    for side in ("card", "cpu"):
        assert [r["protocol"] for r in rec["rows_2000"][side]] == [
            "flood", "pushpull", "pull", "pushk(k=3)"]
    assert rec["rows_full"][0]["reached_fraction"] == 1.0
    assert rec["rows_full"][0]["final_coverage_mean"] == SMALL_COMPARE["nodes"]


def test_a_kernel_launch_on_the_cpu_fails_the_check():
    with pytest.raises(RuntimeError, match="expected 0"):
        chip_smoke.check_kernel_launches("x", {"gather_or": 1}, ("gather_or",), False)
    with pytest.raises(RuntimeError, match="expected > 0"):
        chip_smoke.check_kernel_launches("x", {"gather_or": 0}, ("gather_or",), True)


def test_a_divergent_pair_fails_naming_pair_and_tick():
    with pytest.raises(RuntimeError, match="pair sync-hub diverged at tick 5"):
        chip_smoke.check_clean("phase 18 (b)", "sync-hub",
                               dict(diverged=True, tick=5, compared=11))
    with pytest.raises(RuntimeError, match="pair sync-hub stream b .* at tick 3"):
        chip_smoke.check_same_streams("sync-hub", ({0: 1}, {2: 1, 3: 5}),
                                      ({0: 1}, {2: 1, 3: 4}))
