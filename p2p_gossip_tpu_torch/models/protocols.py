"""The random-partner gossip protocols on PyTorch: push-pull and pull
anti-entropy, and fanout-limited push.

The counterpart of the JAX package's ``models/protocols.py``: the same
graph, schedule, seed and option models give bitwise the same per-node
counters and coverage rows. The reference floods (`engine.sync`); these
are the classic low-bandwidth alternatives (BASELINE.json config 5 is
push-pull with log-normal per-edge delays).

The graph is staged as its CSR on the device (`PartnerGraph`): indptr,
indices, per-entry delays or the one uniform delay, degree. Each round
every node with a neighbour picks one (push-pull, pull) or ``fanout``
(fanout push) uniform-random neighbours by the counter-based hash of
`models.partnersel`, keyed only by (seed, round), so share chunks see the
same exchanges and counters add across chunks; pick k of node v is CSR
entry ``indptr[v] + k``. Both directions of
an exchange read the sender's state as it was ``delay`` rounds ago, from a
ring of past rows: ``seen`` for push-pull and pull, the frontier (``newly
| generated``) for fanout push; the slot is ``(t - delay) mod D`` with the
picked edge's own delay, the one uniform delay, or 1 under
``partners_override``. The picks, loss coins and churn masks of 16 rounds
are drawn in one pass (`_draw_rounds`), and with them each round's pull
rows and the block's push plan (the pushes sorted by destination,
`ops.kernels.scatter_or_plan`). One round on the device:

- one `ops.kernels.scatter_or` call writes the new ring row: ``seen``
  (slot t-1) ORed with the partner's row behind the pull coin
  ``drop(partner, node, t)`` and the rows pushed to the node behind the
  push coin — or, for fanout push, the frontier ``pushed & ~seen`` — all
  read straight out of the ring;
- the round's generations added into that row, and its popcount from the
  ``popcount_rows`` kernel into a (D, N) ring beside it: the digest
  sizes later rounds charge to ``sent`` and, at the chunk's end, the
  ``received`` counts; with ``record_coverage`` the ``coverage_per_slot``
  kernel on ``seen``.

Spans (`telemetry.span`): ``stage.partners`` [edges, bytes] around the
staging; in `_run_chunk` each round's enqueue ``round`` holds ``draw``
[rounds] (a block's draw, every PICK_BLOCK rounds), ``exchange`` (the
`scatter_or` call) and ``count`` (generations, ``popcount_rows``,
``coverage_per_slot``); the entry's ``inputs``, ``d2h`` and ``stats`` as
the flood's.

With telemetry's rings on, each round also writes a metric row and a
state digest (`_RoundTelemetry`), harvested once a chunk as the JAX
package's ``ring`` and ``digest`` events; with them off a round launches
nothing extra.

A Monte-Carlo campaign (`batch.campaign.run_protocol_campaign`) runs B
replicas through the same rounds (``replicas`` of `_run_chunk`): their
rows are stacked, the ring is (D, B*N, W) and ring row ``slot*B*N + r*N +
node`` is replica r's; picks and coins hash node ids with the replica's
own partner and loss seeds, and one `ops.kernels.scatter_or` call a round
covers every replica.

Counter mapping (anti-entropy has no per-share forwarding): ``received``
and ``forwarded`` count newly acquired shares; ``sent`` counts shares
transmitted in digests. ``received`` is int32 and wraps as the JAX
package's does (the host sums chunks in int64). The JAX package keeps
``sent`` as a uint32 (lo, hi) pair; the port keeps one int64 per node on
the device, equal to that pair's ``combine_u64`` below 2^63.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from p2p_gossip_tpu_torch.engine.sync import DEFAULT_CHUNK_SIZE, MIN_CHUNK_SHARES
from p2p_gossip_tpu_torch.models import churn as churn_mod
from p2p_gossip_tpu_torch.models.churn import effective_generated
from p2p_gossip_tpu_torch.models.generation import Schedule
from p2p_gossip_tpu_torch.models.linkloss import drop_mask_np, drop_mask_torch
from p2p_gossip_tpu_torch.models.partnersel import (
    pick_from_key,
    pick_index_np,
    pick_key,
)
from p2p_gossip_tpu_torch.models.topology import Graph
from p2p_gossip_tpu_torch.ops import bitmask, kernels
from p2p_gossip_tpu_torch.telemetry import digest as tel_digest
from p2p_gossip_tpu_torch.telemetry import progress as tel_progress
from p2p_gossip_tpu_torch.telemetry import rings as tel_rings
from p2p_gossip_tpu_torch.telemetry import sink as tel_sink
from p2p_gossip_tpu_torch.telemetry.spans import span
from p2p_gossip_tpu_torch.utils.checkpoint import (
    checkpointed_chunks,
    make_checkpointer,
)
from p2p_gossip_tpu_torch.utils.device import resolve_device
from p2p_gossip_tpu_torch.utils.stats import NodeStats

_U32 = 0xFFFFFFFF


class PullCreditBoundError(ValueError):
    """Pull mode's per-round responder credit could pass 2^32 for this
    graph and chunk width. A distinct type, so the CLI can print exactly
    this precondition as an error."""


def _check_pull_credit_bound(graph: Graph, chunk_size: int, schedule) -> None:
    """The JAX package's precondition for pull mode: a responder's credit
    in one round is at most degree x chunk width, which its uint32 scatter
    accumulator must hold. The port adds credits in int64 and could not
    wrap, but refuses the same runs at the same bound, so both packages
    accept and reject alike."""
    eff_chunk = min(chunk_size, max(MIN_CHUNK_SHARES, schedule.num_shares))
    check_pull_credit_width(graph, bitmask.num_words(eff_chunk) * bitmask.WORD_BITS)


def check_pull_credit_width(graph: Graph, eff_chunk: int) -> None:
    """The bound itself, for a caller that knows its pass width."""
    if int(graph.max_degree) * eff_chunk >= 1 << 32:
        raise PullCreditBoundError(
            "pull-mode per-round sent credit may overflow uint32: "
            f"max degree {graph.max_degree} x chunk {eff_chunk} >= 2^32 — "
            "reduce chunk_size"
        )


@dataclasses.dataclass
class PartnerGraph:
    """The random-partner protocols' staging: the graph's CSR on the
    device. A pick ``k`` of node v reads entry ``indptr[v] + k``: its
    neighbour ``indices[...]`` and, with per-edge delays, that link's
    ``edge_delay[...]``. The CSR row is the ELL row of ``Graph.ell()`` (the
    ELL is filled from ``csr_rows_pos``), so the picks are the full-width
    ELL's; no (N, dmax) array is built on the host or the device.

    ``indices`` and ``edge_delay`` hold one sentinel entry past the last,
    neighbour 0 and delay 1 (the ELL's padding): the pick of the last row
    when it has no neighbour reads it. A degree-0 row never exchanges, so
    what its pick reads only has to be a valid row."""

    n: int
    indptr: torch.Tensor               # (N+1,) int64
    indices: torch.Tensor              # (E+1,) int32
    edge_delay: torch.Tensor | None    # (E+1,) int32; None: one delay on every link
    degree: torch.Tensor               # (N,) int32
    ring_size: int                     # D = max delay + 1
    uniform_delay: int | None
    delay_range: tuple                 # (least, largest) delay a pick can carry

    @property
    def device(self) -> torch.device:
        return self.degree.device

    @property
    def num_entries(self) -> int:
        return int(self.indices.shape[0]) - 1

    @property
    def nbytes(self) -> int:
        staged = (self.indptr, self.indices, self.edge_delay, self.degree)
        return sum(t.nbytes for t in staged if t is not None)

    @staticmethod
    def build(graph: Graph, delays=None, constant_delay: int = 1, *,
              device=None) -> "PartnerGraph":
        """Stage ``graph`` with ``delays``: None (``constant_delay`` on every
        link), one int per CSR entry (``models.latency.
        lognormal_edge_delays``), or the (N, dmax) ELL layout the flood
        takes, whose ring size keeps the JAX staging's rule (its largest
        entry, padding included, + 1)."""
        device = resolve_device(device)
        e = int(graph.indices.shape[0])
        with span("stage.partners", edges=e) as sp:
            if delays is None:
                per_entry = np.full(e, constant_delay, dtype=np.int32)
                dmax = constant_delay
            else:
                delays = np.asarray(delays)
                if delays.ndim == 2:
                    dmax = int(delays.max()) if delays.size else 1
                    rows, pos = graph.csr_rows_pos()
                    per_entry = delays[rows, pos]
                elif delays.shape == (e,):
                    per_entry = delays
                    dmax = int(delays.max()) if e else 1
                else:
                    raise ValueError(f"delays must be ({e},) per CSR entry or (N, dmax), "
                                     f"got {delays.shape}")
            lo, hi = (int(per_entry.min()), int(per_entry.max())) if e else (1, 1)
            uniform = lo if e and lo == hi else None

            def i32(a, tail):
                a = np.concatenate([np.asarray(a, dtype=np.int32), np.int32([tail])])
                return torch.as_tensor(a, device=device)

            pg = PartnerGraph(
                n=graph.n,
                indptr=torch.as_tensor(graph.indptr.astype(np.int64), device=device),
                indices=i32(graph.indices, 0),
                edge_delay=None if uniform is not None else i32(per_entry, 1),
                degree=torch.as_tensor(graph.degree.astype(np.int32), device=device),
                ring_size=dmax + 1,
                uniform_delay=uniform,
                delay_range=(lo, hi),
            )
            sp.set(bytes=pg.nbytes)
        return pg

    def canonical_delays(self) -> np.ndarray:
        """Per-edge delays in CSR order, or the one uniform delay: the
        checkpoint fingerprint's input, equal to `engine.sync.
        _canonical_delays` of a `DeviceGraph` of the same delays."""
        if self.uniform_delay is not None:
            return np.asarray([self.uniform_delay], dtype=np.int64)
        return self.edge_delay[:-1].cpu().numpy()


def partner_graph_bytes(degree: np.ndarray, per_edge_delay: bool = False) -> int:
    """Bytes of the `PartnerGraph` of a graph of this degree array:
    ``indptr`` (int64), ``indices`` and, with per-edge delays,
    ``edge_delay`` (int32, one sentinel entry each), ``degree`` (int32)."""
    n = int(np.asarray(degree).shape[0])
    entries = int(np.asarray(degree, dtype=np.int64).sum()) + 1
    return 8 * (n + 1) + 4 * entries * (2 if per_edge_delay else 1) + 4 * n


def _stage(graph, delays, constant_delay, device_graph, device) -> PartnerGraph:
    """The protocols' CSR staging (`PartnerGraph.build`), or the one given."""
    device = resolve_device(device)
    if device_graph is None:
        device_graph = PartnerGraph.build(graph, delays, constant_delay, device=device)
    if not isinstance(device_graph, PartnerGraph):
        raise ValueError(
            "random-partner protocols take a PartnerGraph (PartnerGraph.build: the "
            "CSR their picks index), not the flood's DeviceGraph, bucketed=False or not"
        )
    if device_graph.device != device:
        raise ValueError(f"device_graph lives on {device_graph.device}, not {device}")
    if device_graph.ring_size * device_graph.n >= 1 << 31:
        raise ValueError("ring slots x nodes must stay below 2^31 (int32 ring rows)")
    return device_graph


# Rounds whose picks, loss coins and churn masks are drawn in one pass:
# drawn a round at a time they were ~40 small launches a round, and the
# card sat idle most of the run waiting for the host (PERF.md).
PICK_BLOCK = 16


def _draw_rounds(dg, key, override, churn, loss, t0: int, t1: int, mode: str,
                 coins: bool = False, replicas: int = 1):
    """The exchanges of rounds t0..t1-1, drawn in one pass, each (B, N, c)
    with B = t1 - t0: ``partners`` int32; ``src`` the sender's ring row
    ``slot * N + node`` and, for pull, ``served`` the partner's, int32;
    ``attempted`` bool; and ``up`` (B, N) bool under churn (else None).
    With ``replicas`` R > 1 the N rows are the R*N stacked rows r*N + node
    (and ``partners`` stacked rows too): ``key`` is (R*N, c), ``churn``
    (R*N, K) and the loss seed broadcasts against (B, R*N, c); the picks
    and coins hash node ids.
    ``coins`` (telemetry on) also keeps ``served`` for push-pull and the
    coins apart, ``pull_ok`` and ``push_ok`` (B, N, c) bool, for the
    metric row's ``loss_dropped``.
    What the round's `kernels.scatter_or` call reads: for push-pull and
    pull, ``pull_row`` (B, N) int32, the partner's ring row at the picked
    edge's delay where the pull coin ``drop(partner, node, t)`` keeps it,
    else -1; for push-pull and fanout push, ``plan``, the block's pushes
    (behind the coin ``drop(node, partner, t)``) sorted by round and
    destination, round i's offsets at ``[i * N, (i + 1) * N]``."""
    ring, dev = dg.ring_size, dg.device
    n = replicas * dg.n
    b = t1 - t0
    ticks = torch.arange(t0, t1, dtype=torch.int64, device=dev)[:, None, None]
    rows = torch.arange(n, dtype=torch.int64, device=dev)[None, :, None]
    node, degree = rows, dg.degree[None, :, None]
    if replicas > 1:
        node = rows % dg.n
        degree = dg.degree[node]
    if override is not None:
        node_partners = partners = override[t0:t1].reshape(b, n, -1)
        slot = torch.remainder(ticks - 1, ring)
    else:
        pos = dg.indptr[node] + pick_from_key(key, ticks, degree)  # the pick's CSR entry
        node_partners = partners = dg.indices[pos]
        if replicas > 1:
            partners = partners + (rows - node)  # the partner's stacked row
        if dg.uniform_delay is not None:
            slot = torch.remainder(ticks - dg.uniform_delay, ring)
        else:
            slot = torch.remainder(ticks - dg.edge_delay[pos], ring)
    draw = dict(partners=partners, up=None)
    draw["src"] = (slot * n + rows).expand(partners.shape).to(torch.int32).contiguous()
    attempted = degree > 0  # a degree-0 row never exchanges
    if churn is not None:
        down_start, down_end = churn
        up = ~((down_start <= ticks) & (ticks < down_end)).any(dim=-1)  # (B, N)
        up_partner = up.gather(1, partners.reshape(b, -1).to(torch.int64))
        attempted = attempted & up[:, :, None] & up_partner.view(partners.shape)
        draw["up"] = up
    attempted = attempted.expand(partners.shape).contiguous()
    draw["attempted"] = attempted
    if mode != "pushk":
        served = slot * n + partners
        pull_ok = attempted
        if loss is not None:
            pull_ok = attempted & ~drop_mask_torch(node_partners, node, ticks, *loss)
        draw["pull_row"] = torch.where(pull_ok, served, -1).to(torch.int32).reshape(b, n)
        if mode == "pull" or coins:
            draw["served"] = served.to(torch.int32)
        if coins:
            draw["pull_ok"] = pull_ok
    if mode != "pull":
        push_ok = attempted
        if loss is not None:
            push_ok = attempted & ~drop_mask_torch(node, node_partners, ticks, *loss)
        draw["plan"] = _push_plan(partners, draw["src"], push_ok, n, ring)
        if coins:
            draw["push_ok"] = push_ok
    return draw


def _push_plan(partners, src, push_ok, n: int, ring: int):
    """The (offsets, entries) of a block of B rounds' pushes, each (B, N,
    c): the sender's ring row ``src`` to ``partners`` where ``push_ok``,
    sorted by round and destination in one `kernels.scatter_or_plan`
    call; round i's offsets are ``offsets[i * N:(i + 1) * N + 1]``."""
    b = partners.shape[0]
    rnd = torch.arange(b, dtype=torch.int64, device=partners.device)[:, None, None] * n
    return kernels.scatter_or_plan(
        partners.reshape(-1), src.reshape(-1), push_ok.reshape(-1), n, ring * n,
        key_offset=rnd.expand(partners.shape).reshape(-1), rounds=b,
    )


def _check_ring_slots(dg: PartnerGraph, override) -> None:
    """Round t writes ring slot t mod D in the same `kernels.scatter_or`
    call that reads slots (t - d) mod D; none of those is slot t when
    every delay a pick can carry lies in [1, D - 1]. Checked once a chunk
    (on the per-entry delays' range, taken at staging), so the kernel's
    precondition (no read row is a row it writes) holds."""
    lo, hi = (1, 1) if override is not None else dg.delay_range
    if not 1 <= lo <= hi <= dg.ring_size - 1:
        raise ValueError(f"delays [{lo}, {hi}] do not fit a ring of {dg.ring_size} slots")


def _gen_events(origins: np.ndarray, gen_ticks: np.ndarray, horizon: int, w: int, dev,
                chunk_size: int | None = None):
    """A chunk's generation events that fire before ``horizon``, sorted by
    tick: each event's bitmask word (``origin * W + slot // 32``), its bit
    as the int32 pattern, and its origin, on the device; and for each
    tick with events, its (start, end) range. A campaign batch passes its
    replicas' events stacked, ``origins`` as rows r*N + origin, event i
    holding share slot ``i % chunk_size``."""
    live = np.flatnonzero(gen_ticks < horizon)
    order = live[np.argsort(gen_ticks[live], kind="stable")]  # the events
    share = order if chunk_size is None else order % chunk_size  # their slots
    ticks = gen_ticks[order]
    org = origins[order].astype(np.int64)
    word = org * w + share // 32
    bit = (np.uint32(1) << (share % 32).astype(np.uint32)).view(np.int32)
    spans = {}
    for t in np.unique(ticks):
        spans[int(t)] = (int(np.searchsorted(ticks, t)),
                         int(np.searchsorted(ticks, t, side="right")))
    as_dev = functools.partial(torch.as_tensor, device=dev)
    return as_dev(word), as_dev(bit), as_dev(org), spans


def _run_chunk(
    dg: PartnerGraph,
    origins: np.ndarray,      # (S,) chunk origins
    gen_ticks: np.ndarray,    # (S,) int32; >= horizon never fires
    key: torch.Tensor,        # (N, c) `pick_key` of every (node, pick)
    override: torch.Tensor | None,  # (horizon, N[, c]) int32 pinned partners
    churn: tuple | None,
    loss: tuple | None,
    *,
    mode: str,
    chunk_size: int,
    horizon: int,
    n_cov: int | None,
    plain: bool,
    rings: tuple | None = None,
    replicas: int = 1,
):
    """``horizon`` rounds of one share chunk from t = 0 (the JAX package's
    ``_pushpull_scan`` and ``_pushk_scan``). A node makes c exchanges a
    round: c = 1 for push-pull and pull, the fanout for fanout push.
    Returns (received int32, sent int64, coverage (B, horizon, n_cov)
    int32 or None, the (D, N, W) ring as the last round left it), on the
    device. ``rings`` (telemetry on): a fresh (metric ring, digest ring)
    pair whose row t each round writes (`_RoundTelemetry`).

    ``replicas`` B > 1 runs a campaign batch (JAX ``_run_pushpull_replicas``
    / ``_run_pushk_replicas``): ``origins`` and ``gen_ticks`` hold the B
    replicas' events stacked (rows r*N + origin), ``key`` is (B*N, c),
    ``churn`` (B*N, K), and every N above is B*N; the counters come back
    (B*N,). B = 1 is the solo chunk.

    For push-pull and pull the ring holds ``seen`` itself: round t reads
    its ``seen`` from slot t-1 and writes the new one into slot t, so no
    separate copy is kept. A generation's bit is added into its origin's
    new row, which is an exact OR: no node holds a share before its
    generation tick. So a node's ``received`` over the chunk is its final
    ``seen`` popcount less the generations that fired at it — the sum of
    the rounds' ``popcount(incoming & ~seen)`` (below 2^31: at most the
    chunk's shares)."""
    n, dev = replicas * dg.n, dg.device
    w = bitmask.num_words(chunk_size)
    ring = dg.ring_size
    words, bits, gen_org, spans = _gen_events(
        origins, gen_ticks, horizon, w, dev, chunk_size if replicas > 1 else None
    )
    hist = torch.zeros((ring, n, w), dtype=torch.int32, device=dev)
    hcnt = torch.zeros((ring, n), dtype=torch.int32, device=dev)  # rows' popcounts
    flat, flat_cnt = hist.view(ring * n, w), hcnt.view(-1)
    seen = hist[ring - 1]  # slot t-1 at t = 0: zero
    if mode == "pushk":
        seen = torch.zeros((n, w), dtype=torch.int32, device=dev)
    fired = torch.zeros((n,), dtype=torch.int32, device=dev)
    sent = torch.zeros((n,), dtype=torch.int64, device=dev)
    cov = None
    if n_cov is not None:
        cov = torch.zeros((replicas, horizon, n_cov), dtype=torch.int32, device=dev)
    cov_w = bitmask.num_words(n_cov or 0)
    tel = None
    if rings is not None:
        tel = _RoundTelemetry(rings, mode, hcnt, loss is not None, plain)

    _check_ring_slots(dg, override)
    for t in range(horizon):
        with span("round"):
            i = t % PICK_BLOCK
            if i == 0:
                b = min(t + PICK_BLOCK, horizon) - t
                with span("draw", rounds=b):
                    draw = _draw_rounds(dg, key, override, churn, loss, t, t + b, mode,
                                        coins=tel is not None, replicas=replicas)
            partners, attempted = draw["partners"][i], draw["attempted"][i]
            offsets = entries = None
            if "plan" in draw:
                offsets, entries = draw["plan"]
                offsets = offsets[i * n:(i + 1) * n + 1]
            pull_row = draw["pull_row"][i] if "pull_row" in draw else None
            row = hist[t % ring]
            if tel is not None:  # msgs_gathered: the round's arrivals, before the OR with seen
                tel.gather(flat, offsets, entries, pull_row)
            # The new ring row in one pass: push-pull and pull seen | pulled |
            # pushed, fanout push the frontier pushed & ~seen.
            with span("exchange"):
                kernels.scatter_or(flat, offsets, entries, pull_row=pull_row, base=seen,
                                   andnot=mode == "pushk", out=row, plain=plain)
            if mode == "pull":
                # The responder transmits: each attempted pull credits the
                # partner with the size of the row it served, before the coin.
                served = torch.where(attempted, flat_cnt[draw["served"][i]], 0)
                sent.index_add_(0, partners.view(-1).to(torch.int64),
                                served.view(-1).to(torch.int64))
                or_work = served
            else:
                # The sender counts every attempted send. The JAX package sums
                # a node's picks in int32 and adds the sum as a uint32: the
                # same value mod 2^32.
                digest = torch.where(attempted, flat_cnt[draw["src"][i]], 0)
                or_work = digest.sum(dim=1, dtype=torch.int64) & _U32
                sent += or_work

            with span("count"):
                if t in spans:
                    lo, hi = spans[t]
                    vals, org = bits[lo:hi], gen_org[lo:hi]
                    fire = torch.ones_like(vals)
                    if draw["up"] is not None:
                        fire = draw["up"][i][org].to(torch.int32)
                        vals = vals * fire
                    row.view(-1).index_add_(0, words[lo:hi], vals)
                    fired.index_add_(0, org, fire)
                bitmask.popcount_rows(row, out=hcnt[t % ring], plain=plain)
                if mode == "pushk":
                    seen |= row
                else:
                    seen = row
                if cov is not None:
                    cov[:, t] = bitmask.coverage_per_slot(
                        seen.view(replicas, dg.n, w)[:, :, :cov_w], n_cov, plain=plain
                    )
            if tel is not None:
                tel.round(t, draw, i, fired, or_work, seen, sent)
    final = bitmask.popcount_rows(seen, plain=plain) if mode == "pushk" else hcnt[
        (horizon - 1) % ring]
    return final - fired, sent, cov, hist


class _RoundTelemetry:
    """A chunk's per-round metric rows and digests (telemetry on), the JAX
    package's ``_pushpull_scan`` / ``_pushk_scan`` rows value for value,
    from what the round loop keeps:

    - ``frontier_bits`` per node from the count ring: push-pull and pull
      ``hcnt[t] - hcnt[t-1]`` (the ring holds ``seen``), fanout push
      ``hcnt[t]`` (the ring holds the frontier); ``frontier_nodes`` the
      nodes where it is above 0;
    - ``received`` every round (the loop itself forms it only at the
      chunk's end): ``seen``'s popcount less the generations fired so
      far, ``seen``'s popcount being ``hcnt[t]`` (push-pull, pull) or the
      running sum of the frontier rows' counts (fanout push: they are
      disjoint); ``newly_infected`` its growth this round;
    - ``msgs_gathered``: the bits of the round's arrivals before they meet
      ``seen`` — one more `kernels.scatter_or` call on the round's plan and
      pull rows, with no base, into a scratch (N, W) buffer;
    - ``or_work``: the bits the round charges to ``sent``;
    - ``loss_dropped``: the bits of the attempted pulls (push-pull, pull)
      and pushes (push-pull, fanout push) that the coin dropped, sized by
      the count ring (the JAX package's ``pc_remote`` and ``popcount
      (my_old)``);
    - the digest of (``seen``, ``received``, ``sent`` as its low and high
      words).

    A campaign batch's (B, capacity, ...) rings take every replica's row and
    digest from the same launches, each total a reduction over a (B, N)
    view of the stacked rows."""

    def __init__(self, rings, mode: str, hcnt, lossy: bool, plain: bool):
        self.met, self.dig = rings
        self.mode, self.hcnt, self.lossy, self.plain = mode, hcnt, lossy, plain
        self.b = tel_rings.ring_replicas(self.met)
        self.received = torch.zeros_like(hcnt[0])
        self.seen_cnt = torch.zeros_like(hcnt[0])  # fanout push
        self.scratch = self.gathered = None

    def gather(self, flat, offsets, entries, pull_row) -> None:
        if self.scratch is None:
            self.scratch = flat.new_empty((self.hcnt.shape[1], flat.shape[1]))
        kernels.scatter_or(flat, offsets, entries, pull_row=pull_row,
                           out=self.scratch, plain=self.plain)
        self.gathered = tel_rings.total_bits(self.scratch, self.b, plain=self.plain)

    def round(self, t, draw, i, fired, or_work, seen, sent) -> None:
        hcnt, ring = self.hcnt, self.hcnt.shape[0]
        cnt = hcnt[t % ring]
        if self.mode == "pushk":
            frontier = cnt
            self.seen_cnt += cnt
            received = self.seen_cnt - fired
        else:
            frontier = cnt - hcnt[(t - 1) % ring]
            received = cnt - fired
        newly = received - self.received
        self.received = received
        dropped = 0
        if self.lossy:
            flat_cnt = hcnt.view(-1)
            attempted = draw["attempted"][i]
            if self.mode != "pushk":
                lost = attempted & ~draw["pull_ok"][i]
                dropped = tel_rings.u32sum(torch.where(lost, flat_cnt[draw["served"][i]], 0),
                                           self.b)
            if self.mode != "pull":
                lost = attempted & ~draw["push_ok"][i]
                pushed = tel_rings.u32sum(torch.where(lost, flat_cnt[draw["src"][i]], 0),
                                          self.b)
                dropped = (dropped + pushed) & _U32  # a uint32 add, as in JAX
        tel_rings.row(
            self.met, t,
            frontier_bits=tel_rings.u32sum(frontier, self.b),
            frontier_nodes=tel_rings.u32sum(frontier > 0, self.b),
            newly_infected=tel_rings.u32sum(newly, self.b),
            msgs_gathered=self.gathered,
            or_work=tel_rings.u32sum(or_work, self.b),
            loss_dropped=dropped,
        )
        tel_digest.write(self.dig, t, seen, received, *tel_digest.split_u64(sent),
                         plain=self.plain)


def _run_partnered_sim(
    mode: str,
    fanout: int,
    fingerprint_extra: tuple,
    graph: Graph,
    schedule: Schedule,
    horizon_ticks: int,
    ell_delays,
    constant_delay,
    seed,
    record_coverage,
    partners_override,
    device_graph,
    chunk_size,
    churn,
    loss,
    checkpoint_path,
    checkpoint_every,
    stop_after_chunks,
    device,
    plain,
):
    """The chunk loop of both protocols (the JAX package's
    ``_run_partnered_sim``): stage, chunk, checkpoint, run each chunk's
    rounds and add the counters. ``fingerprint_extra`` (protocol name and
    its static knobs) keys the checkpoint, part for part as the JAX
    package's, so a checkpoint either package writes, the other resumes."""
    dg = _stage(graph, ell_delays, constant_delay, device_graph, device)
    dev = dg.device
    chunk_size = min(chunk_size, max(MIN_CHUNK_SHARES, schedule.num_shares))
    chunk_size = bitmask.num_words(chunk_size) * bitmask.WORD_BITS
    seed = int(seed) & _U32
    with span("inputs", shares=schedule.num_shares):
        nodes = torch.arange(dg.n, dtype=torch.int64, device=dev)
        picks = torch.arange(fanout, dtype=torch.int64, device=dev)
        key = pick_key(nodes[:, None], picks[None, :], seed)  # pick 0 for push-pull
        override = None
        if partners_override is not None:
            override = torch.as_tensor(
                np.asarray(partners_override, dtype=np.int32), device=dev
            )
        churn_dev = churn_mod.to_device(churn, dev)
        loss_cfg = None
        if loss is not None and loss.threshold > 0:
            loss_cfg = loss.static_cfg

    received = np.zeros(graph.n, dtype=np.int64)
    sent = np.zeros(graph.n, dtype=np.int64)
    checkpointer = make_checkpointer(
        checkpoint_path, checkpoint_every, record_coverage,
        lambda: (
            "partnered_sim", *fingerprint_extra, graph.n, graph.edges(),
            schedule.origins, schedule.gen_ticks, horizon_ticks, chunk_size,
            dg.canonical_delays(), dg.uniform_delay, dg.ring_size, seed,
            partners_override,
            churn.down_start if churn is not None else None,
            churn.down_end if churn is not None else None,
            *([np.asarray(loss.static_cfg, dtype=np.int64)] if loss is not None else []),
        ),
        {"received": received, "sent": sent},
    )
    tel = tel_sink.rings_enabled()
    name = f"models.protocols.{fingerprint_extra[0]}"
    cov_chunks = []
    rounds = 0
    chunks = schedule.chunk(chunk_size) or [schedule]
    for ci, chunk in checkpointed_chunks(chunks, checkpointer, stop_after_chunks):
        with span("inputs", shares=chunk.num_shares, chunk=ci):
            origins, gen_ticks = chunk.padded(chunk_size, horizon_ticks)
        rings = tel_rings.chunk_rings(horizon_ticks, dev) if tel else None
        rounds += horizon_ticks
        with span("dispatch", kernel=name, chunk=ci):
            r, s, cov, _ = _run_chunk(
                dg, origins, gen_ticks, key, override, churn_dev, loss_cfg,
                mode=mode, chunk_size=chunk_size, horizon=horizon_ticks,
                n_cov=chunk.num_shares if record_coverage else None, plain=plain,
                rings=rings,
            )
        with span("d2h", chunk=ci, bytes=r.nbytes + s.nbytes + (
                cov[0].nbytes if record_coverage else 0)):
            received += r.cpu().numpy().astype(np.int64)
            sent += s.cpu().numpy()
            if record_coverage:
                cov_chunks.append(cov[0].cpu().numpy())
        digest_head = None
        if tel:
            met, dig = rings
            tel_rings.emit_ring(name, met, t0=0, ticks=horizon_ticks, chunk=ci)
            dvals = dig.cpu().numpy()
            tel_digest.emit_digest(name, dvals, t0=0, ticks=horizon_ticks, chunk=ci)
            if dvals.size:
                digest_head = int(dvals[-1])
        tel_progress.emit_progress(
            name, chunk=ci, chunks_total=len(chunks),
            ticks_done=horizon_ticks * (ci + 1), digest_head=digest_head,
        )

    with span("stats"):
        generated = effective_generated(schedule, horizon_ticks, churn)
        stats = NodeStats(
            generated=generated,
            received=received,
            forwarded=received.copy(),
            sent=sent,
            processed=generated + received,
            degree=graph.degree.astype(np.int64),
        )
        stats.extra["rounds_executed"] = rounds
        cov = np.concatenate(cov_chunks, axis=1) if record_coverage else None
    return stats, cov


def run_pushpull_sim(
    graph: Graph,
    schedule: Schedule,
    horizon_ticks: int,
    ell_delays: np.ndarray | None = None,
    constant_delay: int = 1,
    seed: int = 0,
    record_coverage: bool = False,
    partners_override: np.ndarray | None = None,
    device_graph: PartnerGraph | None = None,
    chunk_size: int = DEFAULT_CHUNK_SIZE,
    churn=None,
    loss=None,
    checkpoint_path: str | None = None,
    checkpoint_every: int = 1,
    stop_after_chunks: int | None = None,
    mode: str = "pushpull",
    *,
    device=None,
    plain: bool = False,
):
    """Push-pull anti-entropy for ``horizon_ticks`` rounds; ``mode="pull"``
    runs pull-only anti-entropy (a node ORs in its partner's past state and
    pushes nothing; ``sent`` credits the responder with the popcount of the
    state it served, lost in flight or not). The JAX package's
    ``run_pushpull_sim``, with identical counters and coverage rows.
    Returns (stats, coverage or None); coverage is (horizon, S) int32 node
    counts per round.

    ``ell_delays``: per-edge delays, one per CSR entry (`models.latency.
    lognormal_edge_delays`) or in the flood's (N, dmax) ELL layout; None
    puts ``constant_delay`` on every link. ``device_graph``: a
    `PartnerGraph` staged once (`PartnerGraph.build`), else one is staged.
    ``stats.extra["rounds_executed"]``: the rounds run, horizon x chunks.

    ``partners_override`` (horizon, N) pins each round's partners (with a
    one-round delay), for the numpy oracles. ``churn``: an exchange with a
    down endpoint never happens and down nodes skip generations. ``loss``:
    each direction of an attempted exchange is lost independently to the
    per-link coin; the sender still counts its digest.
    ``checkpoint_path``/``checkpoint_every``/``stop_after_chunks`` as in
    `engine.sync.run_sync_sim` (not with ``record_coverage``).

    ``device=None`` means CUDA and raises without it; ``device="cpu"`` runs
    the kernels' plain versions, as does ``plain=True`` on any device."""
    if mode not in ("pushpull", "pull"):
        raise ValueError(f"unknown anti-entropy mode {mode!r}")
    if mode == "pull":
        _check_pull_credit_bound(graph, chunk_size, schedule)
    return _run_partnered_sim(
        mode, 1, (mode,), graph, schedule, horizon_ticks, ell_delays,
        constant_delay, seed, record_coverage, partners_override, device_graph,
        chunk_size, churn, loss, checkpoint_path, checkpoint_every,
        stop_after_chunks, device, plain,
    )


def run_pushk_sim(
    graph: Graph,
    schedule: Schedule,
    horizon_ticks: int,
    fanout: int = 2,
    ell_delays: np.ndarray | None = None,
    constant_delay: int = 1,
    seed: int = 0,
    record_coverage: bool = False,
    partners_override: np.ndarray | None = None,
    device_graph: PartnerGraph | None = None,
    chunk_size: int = DEFAULT_CHUNK_SIZE,
    churn=None,
    loss=None,
    checkpoint_path: str | None = None,
    checkpoint_every: int = 1,
    stop_after_chunks: int | None = None,
    *,
    device=None,
    plain: bool = False,
):
    """Fanout-limited push ("rumor mongering") for ``horizon_ticks`` rounds:
    each node pushes its frontier — the shares it newly acquired or
    generated ``delay`` rounds ago — to ``fanout`` uniform-random
    neighbour picks a round (with replacement; duplicate picks are
    independent sends). ``sent`` counts the pushed frontier's popcount per
    attempted pick (a pick lost in flight still counts).
    ``partners_override`` is (horizon, N, fanout). The JAX package's
    ``run_pushk_sim``; the rest as in `run_pushpull_sim`."""
    if fanout < 1:
        raise ValueError(f"fanout must be >= 1, got {fanout}")
    return _run_partnered_sim(
        "pushk", fanout, ("pushk", fanout), graph, schedule, horizon_ticks,
        ell_delays, constant_delay, seed, record_coverage, partners_override,
        device_graph, chunk_size, churn, loss, checkpoint_path,
        checkpoint_every, stop_after_chunks, device, plain,
    )


# --- numpy oracles (the JAX package's, copied) -------------------------------

def seeded_partners(
    graph: Graph, horizon: int, seed: int, fanout: int | None = None
) -> np.ndarray:
    """The partners a seeded run picks, from the counter-based hash on the
    host: (horizon, N) for push-pull, (horizon, N, fanout) for fanout
    push. Fed to the oracles they reproduce a seeded run with a one-round
    uniform delay."""
    ell_idx, _ = graph.ell()
    deg = graph.degree
    rows = np.arange(graph.n)
    ticks = np.arange(horizon)
    if fanout is None:
        k = pick_index_np(rows[None, :], ticks[:, None], 0, deg[None, :], seed)
        return ell_idx[rows[None, :], k].astype(np.int32)
    picks = np.arange(fanout)
    k = pick_index_np(
        rows[None, :, None],
        ticks[:, None, None],
        picks[None, None, :],
        deg[None, :, None],
        seed,
    )
    return ell_idx[rows[None, :, None], k].astype(np.int32)


def pushpull_oracle(
    graph: Graph,
    schedule: Schedule,
    horizon_ticks: int,
    partners: np.ndarray,
    churn=None,
    loss=None,
    mode: str = "pushpull",
) -> NodeStats:
    """Plain-numpy specification of one-round-delay push-pull (or pull,
    ``mode="pull"``) with pinned partners, under the same churn and loss
    gating and counter rules as the engines."""
    n = graph.n
    s = schedule.num_shares
    seen = np.zeros((n, s), dtype=bool)
    hist = [np.zeros((n, s), dtype=bool) for _ in range(2)]
    received = np.zeros(n, dtype=np.int64)
    sent = np.zeros(n, dtype=np.int64)
    rows = np.arange(n)
    for t in range(horizon_ticks):
        old = hist[(t - 1) % 2]
        p = partners[t]
        attempted = graph.degree > 0
        if churn is not None:
            up = churn.up_mask(t)
            attempted = attempted & up & up[p]
        pull_ok = push_ok = attempted
        if loss is not None:
            pull_ok = attempted & ~drop_mask_np(p, rows, t, loss.threshold, loss.seed)
            push_ok = attempted & ~drop_mask_np(rows, p, t, loss.threshold, loss.seed)
        incoming = old[p] & pull_ok[:, None]  # pull
        if mode == "pull":
            np.add.at(sent, p, np.where(attempted, old[p].sum(axis=1), 0))
        else:
            for i in range(n):  # push
                if push_ok[i]:
                    incoming[p[i]] = incoming[p[i]] | old[i]
            sent += np.where(attempted, old.sum(axis=1), 0)
        newly = incoming & ~seen
        received += newly.sum(axis=1)
        seen |= newly
        gen_now = schedule.gen_ticks == t
        if churn is not None:
            gen_now = gen_now & up[schedule.origins]
        seen[schedule.origins[gen_now], np.flatnonzero(gen_now)] = True
        hist[t % 2] = seen.copy()
    generated = effective_generated(schedule, horizon_ticks, churn)
    return NodeStats(
        generated=generated,
        received=received,
        forwarded=received.copy(),
        sent=sent,
        processed=generated + received,
        degree=graph.degree.astype(np.int64),
    )


def pushk_oracle(
    graph: Graph,
    schedule: Schedule,
    horizon_ticks: int,
    partners: np.ndarray,
    churn=None,
    loss=None,
) -> NodeStats:
    """Plain-numpy specification of one-round-delay fanout push with
    pinned (horizon, N, k) picks, under the engines' churn and loss gating."""
    n = graph.n
    s = schedule.num_shares
    k = partners.shape[2]
    seen = np.zeros((n, s), dtype=bool)
    hist = [np.zeros((n, s), dtype=bool) for _ in range(2)]
    received = np.zeros(n, dtype=np.int64)
    sent = np.zeros(n, dtype=np.int64)
    rows = np.arange(n)
    for t in range(horizon_ticks):
        front_old = hist[(t - 1) % 2]
        p = partners[t]
        attempted = np.broadcast_to((graph.degree > 0)[:, None], (n, k)).copy()
        if churn is not None:
            up = churn.up_mask(t)
            attempted = attempted & up[:, None] & up[p]
        push_ok = attempted
        if loss is not None:
            push_ok = attempted & ~drop_mask_np(
                rows[:, None], p, t, loss.threshold, loss.seed
            )
        incoming = np.zeros((n, s), dtype=bool)
        for i in range(n):
            for j in range(k):
                if push_ok[i, j]:
                    incoming[p[i, j]] |= front_old[i]
        sent += front_old.sum(axis=1) * attempted.sum(axis=1)
        newly = incoming & ~seen
        received += newly.sum(axis=1)
        front = newly.copy()
        gen_now = schedule.gen_ticks == t
        if churn is not None:
            gen_now = gen_now & up[schedule.origins]
        front[schedule.origins[gen_now], np.flatnonzero(gen_now)] = True
        seen |= front
        hist[t % 2] = front
    generated = effective_generated(schedule, horizon_ticks, churn)
    return NodeStats(
        generated=generated,
        received=received,
        forwarded=received.copy(),
        sent=sent,
        processed=generated + received,
        degree=graph.degree.astype(np.int64),
    )


# --- audit specs (staticcheck/: the op audit runs these tiny cases) ---------
# The JAX package's ``_audit_spec_solo`` / ``_audit_spec_replicas``: ER(48,
# 0.2) staged as its CSR, 32 shares, 8 rounds, coverage recorded, the loss
# coin on; the campaign form stacks B = 2 replicas with their own pick and loss seeds.
# The round loop reads nothing on the host; a chunk stages its generation
# events once (`_gen_events`: word, bit and origin, three host constants).

_PROTOCOLS = "p2p_gossip_tpu_torch/models/protocols.py"
_AUDIT_ROUNDS = 8


def _audit_spec(mode: str, telemetry: bool = False, replicas: int = 1):
    from p2p_gossip_tpu_torch.staticcheck import specs
    from p2p_gossip_tpu_torch.staticcheck.registry import AuditSpec

    chunk, horizon = 32, _AUDIT_ROUNDS
    dg, origins, gen_ticks = specs.partnered_inputs(chunk, horizon)
    dev, b = dg.device, replicas
    c = 2 if mode == "pushk" else 1
    nodes = torch.arange(b * dg.n, dtype=torch.int64, device=dev) % dg.n
    picks = torch.arange(c, dtype=torch.int64, device=dev)
    loss = (1 << 20, 7)
    if b == 1:
        key = pick_key(nodes[:, None], picks[None, :], 42)
    else:
        origins = (origins[None, :].astype(np.int64)
                   + np.arange(b)[:, None] * dg.n).reshape(-1)
        gen_ticks = np.tile(gen_ticks, b)
        row_seeds = specs.tensor(np.arange(b), np.int32).repeat_interleave(dg.n)
        key = pick_key(nodes[:, None], picks[None, :], row_seeds[:, None])
        loss = (1 << 20, specs.tensor(np.arange(b) + 11, np.int32)
                .repeat_interleave(dg.n)[None, :, None])
    kwargs = dict(mode=mode, chunk_size=chunk, horizon=horizon, n_cov=chunk, plain=False,
                  replicas=b)
    if telemetry:
        kwargs["rings"] = tel_rings.chunk_rings(horizon, dev, b if b > 1 else None)
    return AuditSpec(
        args=(dg, origins, gen_ticks, key, None, None, loss), kwargs=kwargs,
        integer_only=True, bitmask_words=1, bitmask_outputs=(3,),
        # received, sent (the JAX package's two uint32 halves), coverage, ring
        out_dtypes=("int32", "int64", "int32", "int32"),
        counterpart_outputs=(1, (2, 3), 4, 0),
        ticks=horizon, h2d=3, off_kwargs=dict(kwargs, rings=None),
    )


from p2p_gossip_tpu_torch.staticcheck.registry import register_entry  # noqa: E402

for _mode, _jax in (("pushpull", "_run_pushpull"), ("pushk", "_run_pushk")):
    for _b, _tag, _jname in ((1, _mode, _jax), (2, f"{_mode}-replicas", f"{_jax}_replicas")):
        _bodies = (f"{_PROTOCOLS}:_run_chunk[loop]", f"{_PROTOCOLS}:_draw_rounds",
                   f"{_PROTOCOLS}:_push_plan")
        register_entry(f"models.protocols._run_chunk[{_tag}]", _run_chunk,
                       spec=lambda m=_mode, b=_b: _audit_spec(m, replicas=b),
                       counterpart=f"models.protocols.{_jname}", tick_bodies=_bodies)
        register_entry(f"models.protocols._run_chunk[{_tag}][telemetry]", _run_chunk,
                       spec=lambda m=_mode, b=_b: _audit_spec(m, telemetry=True, replicas=b),
                       counterpart=f"models.protocols.{_jname}[telemetry]",
                       tick_bodies=_bodies + (f"{_PROTOCOLS}:_RoundTelemetry.gather",
                                              f"{_PROTOCOLS}:_RoundTelemetry.round"))
