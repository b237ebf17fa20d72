"""Digest-stream alignment — the divergence bisector's comparison core.

Every engine family emits one ``digest`` event per (kernel, chunk /
replica / shard) stream: a uint32 value per executed tick of that
stream's state (telemetry/digest.py). Two engines configured
identically produce bit-identical streams, so the FIRST index where two
aligned streams differ is the first divergent tick — no re-run, no
bisection search; the recorder already holds the whole history.

The alignment is standard library only: it reads digest events out of
a sink event list, aligns streams on their tick indices, and reports the
first divergence. The streams may come from either package: the port
emits the JAX package's kernel names, slicing and provenance keys, so a
port stream and a JAX stream of the same run line up tick for tick.
`capture_event_digests` builds the host side of such a comparison: the
port's event engine (engine/event.py) digested after every tick through
its ``on_tick`` hook, with the numpy twin of the device digest.

Alignment semantics: streams carry absolute tick indices (``t0`` +
offset). Only ticks PRESENT IN BOTH streams are compared — a kernel
that stops at quiescence writes fewer ticks than one that runs to the
horizon, and trailing identity ticks are not divergence.
The compared-tick count rides the report so "zero divergence" over an
empty overlap is visibly vacuous rather than silently green.
"""

from __future__ import annotations

from dataclasses import dataclass, field


def digest_streams(events, kernel: str | None = None) -> dict:
    """Collect ``digest`` events into {stream_key: {tick: value}}.

    ``stream_key`` is (kernel, chunk, replica, shard) with absent
    provenance fields as None — one entry per independent digest stream.
    ``kernel`` (substring match) restricts the sweep. Multiple events
    with the same key merge by tick index (checkpoint-resumed runs emit
    per-pass)."""
    streams: dict = {}
    for e in events:
        if e.get("type") != "digest":
            continue
        if kernel is not None and kernel not in e.get("kernel", ""):
            continue
        key = (
            e.get("kernel"), e.get("chunk"), e.get("replica"),
            e.get("shard"),
        )
        tickmap = streams.setdefault(key, {})
        t0 = int(e.get("t0", 0))
        for i, v in enumerate(e.get("values", ())):
            tickmap[t0 + i] = int(v)
    return streams


def select_stream(
    streams: dict,
    kernel: str | None = None,
    chunk=None,
    replica=None,
    shard=None,
) -> dict:
    """The one {tick: value} stream matching the given coordinates.

    A None filter accepts any value for that field. Raises KeyError when
    nothing matches and ValueError when the match is ambiguous — a
    comparison against "some stream" is not a comparison."""
    hits = []
    for (k, c, r, s), tickmap in sorted(
        streams.items(), key=lambda kv: str(kv[0])
    ):
        if kernel is not None and kernel not in (k or ""):
            continue
        if chunk is not None and c != chunk:
            continue
        if replica is not None and r != replica:
            continue
        if shard is not None and s != shard:
            continue
        hits.append(((k, c, r, s), tickmap))
    if not hits:
        raise KeyError(
            f"no digest stream matches kernel={kernel!r} chunk={chunk!r} "
            f"replica={replica!r} shard={shard!r} "
            f"(have: {sorted(streams)})"
        )
    if len(hits) > 1:
        raise ValueError(
            f"ambiguous digest stream selection: {[h[0] for h in hits]}"
        )
    return hits[0][1]


@dataclass
class Divergence:
    """One stream comparison. ``tick`` None means no divergent tick was
    found across ``compared`` common ticks."""

    tick: int | None
    compared: int
    a_value: int | None = None
    b_value: int | None = None
    only_a: int = 0           # ticks present only in stream a
    only_b: int = 0
    matched_head: int = 0     # common ticks agreeing before the divergence

    @property
    def diverged(self) -> bool:
        return self.tick is not None

    def as_dict(self) -> dict:
        return {
            "diverged": self.diverged,
            "tick": self.tick,
            "compared": self.compared,
            "a_value": self.a_value,
            "b_value": self.b_value,
            "only_a": self.only_a,
            "only_b": self.only_b,
            "matched_head": self.matched_head,
        }


def first_divergence(a: dict, b: dict) -> Divergence:
    """First common tick where two {tick: value} streams disagree."""
    common = sorted(set(a) & set(b))
    matched = 0
    for t in common:
        if int(a[t]) != int(b[t]):
            return Divergence(
                tick=int(t), compared=len(common),
                a_value=int(a[t]), b_value=int(b[t]),
                only_a=len(set(a) - set(b)), only_b=len(set(b) - set(a)),
                matched_head=matched,
            )
        matched += 1
    return Divergence(
        tick=None, compared=len(common),
        only_a=len(set(a) - set(b)), only_b=len(set(b) - set(a)),
        matched_head=matched,
    )


def inject_fault(stream: dict, tick: int, bit: int = 0) -> dict:
    """Copy of ``stream`` with one bit flipped at ``tick`` — the
    bisector's self-test: after injection, `first_divergence` against
    the original must name exactly ``tick``."""
    if tick not in stream:
        raise ValueError(
            f"fault tick {tick} not present in stream "
            f"(ticks {min(stream, default=None)}..{max(stream, default=None)})"
        )
    out = dict(stream)
    out[tick] = int(out[tick]) ^ (1 << (bit % 32))
    return out


@dataclass
class TickCapture:
    """Host-side per-tick state capture around a window: the frontier
    snapshots the bisector dumps once it has named the divergent tick."""

    digests: dict = field(default_factory=dict)      # {tick: uint32}
    received: dict = field(default_factory=dict)     # {tick: (n,) int64 copy}
    seen_counts: dict = field(default_factory=dict)  # {tick: (n,) int64}


def capture_event_digests(graph, schedule, horizon_ticks: int,
                          window: tuple[int, int] | None = None,
                          **event_kwargs) -> TickCapture:
    """Run the port's event engine and digest every post-tick state with
    the numpy twin of the device digest (`telemetry.digest.tick_digest_np`):
    the host side of an event-vs-tick-engine comparison (the JAX
    package's ``capture_event_digests``, value for value).

    The digest folds the (seen, received, sent) triple the sync flood's
    kernel folds, ``seen`` packed to the schedule's share count (the
    digest does not depend on the word count). ``window=(lo, hi)`` also
    snapshots each node's received total and seen-set size for the ticks
    in [lo, hi]: the frontier dump around a named divergence.
    ``event_kwargs`` go to `engine.event.run_event_sim`."""
    import numpy as np

    from p2p_gossip_tpu_torch.engine.event import run_event_sim
    from p2p_gossip_tpu_torch.ops import bitmask
    from p2p_gossip_tpu_torch.telemetry import digest as tel_digest

    s = int(schedule.num_shares)
    w = bitmask.num_words(max(s, 1))
    cap = TickCapture()

    def on_tick(t, seen, received, sent):
        member = np.zeros((graph.n, max(s, 1)), dtype=bool)
        for i, shares in enumerate(seen):
            live = [sh for sh in shares if sh < s]
            member[i, live] = True
        cap.digests[t] = tel_digest.tick_digest_np(
            tel_digest.pack_seen_np(member, w), received, sent)
        if window is not None and window[0] <= t <= window[1]:
            cap.received[t] = np.asarray(received, dtype=np.int64).copy()
            cap.seen_counts[t] = np.asarray([len(shares) for shares in seen],
                                            dtype=np.int64)

    run_event_sim(graph, schedule, horizon_ticks, on_tick=on_tick, **event_kwargs)
    return cap
