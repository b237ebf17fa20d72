"""A worker module for tests/test_torch_launch.py whose import is slow in
one spawned rank: the rank that first claims the marker file named by
``$P2P_TEST_LAG_MARKER`` sleeps ``$P2P_TEST_LAG_S`` seconds while it
imports this module (as a rank that is slow to import torch does), the
others import it at once. Without the variables it imports at once."""

import os
import time

import torch.distributed as dist

MARKER_ENV = "P2P_TEST_LAG_MARKER"
SECONDS_ENV = "P2P_TEST_LAG_S"

if os.environ.get(MARKER_ENV):
    try:
        fd = os.open(os.environ[MARKER_ENV], os.O_CREAT | os.O_EXCL | os.O_WRONLY)
    except FileExistsError:
        pass
    else:
        os.close(fd)
        time.sleep(float(os.environ[SECONDS_ENV]))


def one_raises():
    if dist.get_rank() == 1:
        raise ValueError("rank one gives up")
    return dist.get_rank()
