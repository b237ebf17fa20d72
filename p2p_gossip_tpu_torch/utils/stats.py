"""Per-node statistics and the reference's report format.

Mirrors the reference's counter set (p2pnode.h:40-43) and the field layout
of `PrintStatistics` (p2pnetwork.cc:253-285), so outputs diff line for line
against the reference and the JAX package.
"""

from __future__ import annotations

import dataclasses
import io
from typing import Any

import numpy as np


@dataclasses.dataclass
class NodeStats:
    """Per-node counter vectors — one array per reference counter."""

    generated: np.ndarray  # sharesGenerated  (p2pnode.cc:118)
    received: np.ndarray   # sharesReceived   (p2pnode.cc:157)
    forwarded: np.ndarray  # sharesForwarded  (p2pnode.cc:163)
    sent: np.ndarray       # sharesSent       (p2pnode.cc:145)
    processed: np.ndarray  # processedShares.size() (p2pnode.cc:241)
    degree: np.ndarray     # peers.size()
    extra: dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def n(self) -> int:
        return int(self.generated.shape[0])

    def totals(self) -> dict[str, int]:
        return {
            "generated": int(self.generated.sum()),
            "received": int(self.received.sum()),
            "forwarded": int(self.forwarded.sum()),
            "sent": int(self.sent.sum()),
            "processed": int(self.processed.sum()),
            "connections": int(self.degree.sum()),
        }

    def check_conservation(self) -> None:
        """Invariants implied by the reference semantics: every receive is
        forwarded, processed = generated + received, and every processed
        share is sent once to each peer (and once more to each duplicated
        peer-list entry under the parallel-link quirk,
        `with_parallel_links`). Raises AssertionError."""
        if not (self.received == self.forwarded).all():
            raise AssertionError("received != forwarded")
        if not (self.processed == self.generated + self.received).all():
            raise AssertionError("processed != generated + received")
        fan = self.degree + self.extra.get("peer_extra", 0)
        if not (self.sent == (self.generated + self.forwarded) * fan).all():
            raise AssertionError("sent != (generated + forwarded) * degree")

    def with_parallel_links(self, peer_extra: np.ndarray) -> "NodeStats":
        """Counters under the reference's parallel-link REGISTER quirk
        (`models.topology.parallel_link_extra`). The quirk leaves the
        gossip dynamics unchanged (the duplicate copy arrives the same tick
        and is dropped by the seen-set, p2pnode.cc:189-193), so it is a
        reporting transform: each broadcast charges one extra ``sent`` per
        duplicated peer-list entry (p2pnode.cc:129-146), and "Peer count"
        prints ``peers.size()`` with the duplicates while "Socket
        connections" stays deduplicated (p2pnode.cc:248)."""
        peer_extra = np.asarray(peer_extra, dtype=self.sent.dtype)
        if peer_extra.shape != self.sent.shape:
            raise ValueError("peer_extra must have one entry per node")
        out = NodeStats(
            generated=self.generated,
            received=self.received,
            forwarded=self.forwarded,
            sent=self.sent + (self.generated + self.forwarded) * peer_extra,
            processed=self.processed,
            degree=self.degree,
            extra=dict(self.extra),
        )
        out.extra["peer_extra"] = peer_extra
        return out

    def __add__(self, other: "NodeStats") -> "NodeStats":
        """Chunk-wise accumulation (shares are independent, counters add).
        Scalar ``extra`` entries present on both sides are summed; an entry
        on one side only is kept; array entries on both sides are dropped.
        ``peer_extra`` is a property of the graph, not a counter: it must
        be equal on both sides and is kept, never summed."""
        if not np.array_equal(self.degree, other.degree):
            raise ValueError("stats from different graphs")
        out = NodeStats(
            generated=self.generated + other.generated,
            received=self.received + other.received,
            forwarded=self.forwarded + other.forwarded,
            sent=self.sent + other.sent,
            processed=self.processed + other.processed,
            degree=self.degree,
        )
        for key in set(self.extra) | set(other.extra):
            a, b = self.extra.get(key), other.extra.get(key)
            if key == "peer_extra" and (
                a is None or b is None or not np.array_equal(a, b)
            ):
                raise ValueError(
                    "peer_extra differs between operands: stats of different "
                    "parallel-link transforms cannot be summed"
                )
            if a is not None and b is not None:
                if key == "peer_extra":
                    out.extra[key] = a
                elif np.isscalar(a) and np.isscalar(b):
                    out.extra[key] = a + b
            else:
                out.extra[key] = a if a is not None else b
        return out

    def equal_counts(self, other: "NodeStats") -> bool:
        return bool(
            (self.generated == other.generated).all()
            and (self.received == other.received).all()
            and (self.forwarded == other.forwarded).all()
            and (self.sent == other.sent).all()
            and (self.processed == other.processed).all()
        )


def format_final_statistics(stats: NodeStats, per_node: bool = True) -> str:
    """The `PrintStatistics` report (p2pnetwork.cc:253-285)."""
    out = io.StringIO()
    out.write("=== P2P Gossip Network Simulation Statistics ===\n")
    # Peer count = peers.size(), with the parallel-link quirk's duplicates
    # when modeled; socket connections = the deduplicated peersockets map.
    peer_count = stats.degree + stats.extra.get("peer_extra", 0)
    if per_node:
        for i in range(stats.n):
            out.write(
                f"Node {i}: Generated {stats.generated[i]}"
                f", Received {stats.received[i]}"
                f", Forwarded {stats.forwarded[i]}"
                f", Total sent {stats.sent[i]}"
                f", Total processed {stats.processed[i]}"
                f", Peer count {peer_count[i]}"
                f", Socket connections {stats.degree[i]}\n"
            )
    t = stats.totals()
    out.write(f"Total shares generated: {t['generated']}\n")
    out.write(f"Total shares received: {t['received']}\n")
    out.write(f"Total shares forwarded: {t['forwarded']}\n")
    out.write(f"Total shares sent: {t['sent']}\n")
    out.write(f"Total socket connections: {t['connections']}\n")
    return out.getvalue()


def format_periodic_stats(stats: NodeStats, sim_time: float) -> str:
    """The `PrintPeriodicStats` report (p2pnetwork.cc:231-250)."""
    t = stats.totals()
    avg = t["processed"] // max(stats.n, 1)
    return (
        f"=== Periodic Stats at {sim_time:g}s ===\n"
        f"Total shares generated: {t['generated']}\n"
        f"Average shares per node: {avg}\n"
        f"Total socket connections: {t['connections']}\n"
    )
