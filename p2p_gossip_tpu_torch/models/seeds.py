"""Seed-stream derivation: every stochastic model derives its stream from
the run seed with a fixed prime offset, so one ``--seed`` reproduces every
coin of a run while the streams stay decorrelated. The offsets are the JAX
package's (its ``models/seeds.py``), so both packages draw the same loss
coins and churn intervals from the same ``--seed``.

- link-loss erasure coins:   ``seed + LOSS_SEED_OFFSET``  (104729)
- churn downtime sampling:   ``seed + CHURN_SEED_OFFSET`` (7919)
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
