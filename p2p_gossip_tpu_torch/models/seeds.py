"""Seed-stream derivation: every stochastic model derives its stream from
the run seed with a fixed prime offset, so one ``--seed`` reproduces every
coin of a run while the streams stay decorrelated. The offsets are the JAX
package's (its ``models/seeds.py``), so both packages draw the same loss
coins and churn intervals from the same ``--seed``.

- link-loss erasure coins:   ``seed + LOSS_SEED_OFFSET``  (104729)
- churn downtime sampling:   ``seed + CHURN_SEED_OFFSET`` (7919)
- replica r of a campaign:   replica seed ``seed + r``, its loss stream
  ``loss_stream_seed(seed + r)``: a solo run with the replica's seeds
  reproduces the replica.
"""

from __future__ import annotations

#: Offset of the link-loss erasure stream from the run seed.
LOSS_SEED_OFFSET = 104729

#: Offset of the churn downtime-sampling stream from the run seed.
CHURN_SEED_OFFSET = 7919


def loss_stream_seed(seed) -> int:
    """The link-loss stream seed a run derives from its seed."""
    return int(seed) + LOSS_SEED_OFFSET


def churn_stream_seed(seed) -> int:
    """The churn-sampling stream seed derived from a run seed."""
    return int(seed) + CHURN_SEED_OFFSET


def replica_loss_seeds(seeds) -> list[int]:
    """Per-replica loss stream seeds for a campaign's replica seed list:
    ``loss_stream_seed(s)`` for each replica seed ``s``."""
    return [loss_stream_seed(s) for s in seeds]
