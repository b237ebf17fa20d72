"""`parallel.launch.spawn`'s deadline: it counts from the world's last
progress, so a world that reports progress runs as long as it needs, and
one in which no rank reports is stopped; a rank's start (its imports,
slow on a loaded host) does not count against it, nor against the other
ranks' rendezvous; a rank that raises still raises with its traceback.

The workers are module-level functions of this torch-only module, so the
spawned ranks can import them."""

import time

import pytest
import torch.distributed as dist

import torch_launch_lag
from p2p_gossip_tpu_torch.parallel import launch

# Gloo's timeout (a rank's rendezvous waits on the other rank's start)
# and the grace past it: a world is stopped TIMEOUT_S + GRACE_S seconds
# after its last progress.
TIMEOUT_S = 15.0
GRACE_S = 1.0
PATIENCE_S = TIMEOUT_S + GRACE_S


def _steady(steps, pause):
    """Each step well inside the deadline, all of them past it."""
    for _ in range(steps):
        time.sleep(pause)
        launch.progress()
    return dist.get_rank()


def _one_stalls(pause):
    """Rank 1 sleeps outside any collective and reports nothing."""
    if dist.get_rank() == 1:
        time.sleep(pause)
    return dist.get_rank()


def _one_raises():
    if dist.get_rank() == 1:
        raise ValueError("rank one gives up")
    return dist.get_rank()


def test_a_world_that_reports_progress_outlives_the_deadline():
    steps, pause = 36, 0.5
    assert steps * pause > PATIENCE_S
    t0 = time.monotonic()
    assert launch.spawn(_steady, 2, steps, pause, timeout_s=TIMEOUT_S,
                        grace=GRACE_S) == [0, 1]
    assert time.monotonic() - t0 > PATIENCE_S


def test_a_silent_rank_times_out():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match=r"ranks \[1\] of 2"):
        launch.spawn(_one_stalls, 2, 600.0, timeout_s=TIMEOUT_S, grace=GRACE_S)
    # Rank 0's result was the world's last progress; the deadline counts
    # from it, not from rank 1's 600 s sleep.
    assert time.monotonic() - t0 < 120.0


def test_a_failing_rank_raises_with_its_traceback():
    with pytest.raises(RuntimeError, match=r"(?s)rank 1 of 2 failed:.*"
                                           r"ValueError: rank one gives up"):
        launch.spawn(_one_raises, 2, timeout_s=TIMEOUT_S, grace=GRACE_S)


def test_a_rank_that_starts_late_still_raises_the_workers_error(tmp_path, monkeypatch):
    """One rank starts TIMEOUT_S + 5 s after the other: the first waits at
    the start barrier, not in gloo's rendezvous, so the world fails with
    the worker's ValueError and not with gloo's ``Wait timeout``."""
    monkeypatch.setenv(torch_launch_lag.MARKER_ENV, str(tmp_path / "lagging"))
    monkeypatch.setenv(torch_launch_lag.SECONDS_ENV, str(TIMEOUT_S + 5))
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=r"(?s)rank 1 of 2 failed:.*"
                                           r"ValueError: rank one gives up") as err:
        launch.spawn(torch_launch_lag.one_raises, 2, timeout_s=TIMEOUT_S, grace=GRACE_S)
    assert "Wait timeout" not in str(err.value)
    assert (tmp_path / "lagging").exists()  # one rank did sleep
    assert time.monotonic() - t0 > TIMEOUT_S + 5


def test_progress_outside_a_spawned_rank_does_nothing():
    launch.progress()
