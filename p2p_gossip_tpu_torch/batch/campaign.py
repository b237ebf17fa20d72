"""Monte-Carlo campaigns: R independent replicas of a simulation through the
port's engines and kernels, the counterpart of the JAX package's
``batch/campaign.py``.

A batch of B replicas is one run of the solo tick (or round) loop over
their state stacked along the rows: ``seen`` (B*N, W), the frontier ring
(D, B*N, W), the counters (B*N,). Every kernel launch covers the whole
batch (``gather_or`` once per degree bucket with the replica on grid y,
``coverage_per_slot`` once a tick into (B, S) counts, ``scatter_or`` once a
protocol round), and the batch shares one tick counter: a replica past its
own quiescence has an empty frontier, so its further ticks change
nothing, and the batch runs until its slowest replica settles. Replica r
is bitwise the solo run with its own seeds (the JAX package's contract).

What varies per replica: the generation schedule (origins + gen ticks)
and the churn intervals, sampled on the host from the replica's seed with
the CLI's stream offsets (`models.seeds`); for the protocols the partner
picks, keyed by the replica's seed; and, with ``loss_seeds``, the
link-loss stream (one uint32 seed a replica, which the gather kernel and
the protocols' coins hash with node ids). The graph and delays are shared.

Replicas run in batches of ``batch_size``; the last batch is padded with
sentinel replicas (gen ticks == horizon) that generate nothing. Long
campaigns checkpoint at batch boundaries in the JAX package's file format
and fingerprint, so a campaign checkpoint either package writes, the
other resumes.

With telemetry's rings on, a batch carries one metric ring and one digest
lane a replica ((B, horizon, NUM_METRICS) and (B, horizon)), written by the
same launches a tick as one replica's; each live replica's ``ring`` and
``digest`` events carry its ``replica`` index and ``seed`` (the JAX
package's events, value for value), and the batch's ``progress`` beat its
``digest_head``. Sentinel replicas emit nothing.

With ``mesh`` (a `parallel.mesh` mesh of ``torch.distributed`` ranks,
every rank calling the runner), a batch's replica axis splits over every
rank of the mesh (the JAX package's sharding over the flattened mesh):
the batch rounds up to a multiple of the rank count (sentinel padding),
each rank runs its B / ranks replicas through the same batch engine on
its own device, and the results are all_gathered to every rank, so every
rank returns the whole campaign. `batch.campaign_sharded` shards each
replica's graph rows instead.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from p2p_gossip_tpu_torch.engine.sync import (
    MIN_CHUNK_SHARES,
    DeviceGraph,
    TickOptions,
    _canonical_delays,
    _run_chunk_coverage,
    _run_chunk_while,
    _stage,
)
from p2p_gossip_tpu_torch.models import protocols
from p2p_gossip_tpu_torch.models.churn import ChurnModel, effective_generated, random_churn
from p2p_gossip_tpu_torch.models.generation import Schedule, uniform_renewal_schedule
from p2p_gossip_tpu_torch.models.partnersel import pick_key
from p2p_gossip_tpu_torch.models.seeds import churn_stream_seed
from p2p_gossip_tpu_torch.models.topology import Graph
from p2p_gossip_tpu_torch.ops import bitmask
from p2p_gossip_tpu_torch.telemetry import digest as tel_digest
from p2p_gossip_tpu_torch.telemetry import progress as tel_progress
from p2p_gossip_tpu_torch.telemetry import rings as tel_rings
from p2p_gossip_tpu_torch.telemetry import sink as tel_sink
from p2p_gossip_tpu_torch.telemetry.spans import span
from p2p_gossip_tpu_torch.utils import logging as p2plog
from p2p_gossip_tpu_torch.utils.checkpoint import (
    ChunkCheckpointer,
    checkpointed_chunks,
    fingerprint,
)
from p2p_gossip_tpu_torch.utils.stats import NodeStats

log = p2plog.get_logger("Batch.Campaign")


@dataclasses.dataclass(frozen=True)
class ReplicaSet:
    """Host-side per-replica inputs of one campaign cell.

    ``origins``/``gen_ticks`` are (R, S) int32 — every replica padded to a
    common share count S with the never-fires sentinel (gen_tick ==
    horizon). ``churn`` stacks each replica's downtime intervals into a
    pair of (R, N, K) int32 arrays (None = no churn anywhere).
    """

    n: int
    origins: np.ndarray
    gen_ticks: np.ndarray
    seeds: np.ndarray  # (R,) int64 — provenance of each replica
    churn: tuple[np.ndarray, np.ndarray] | None = None

    def __post_init__(self):
        if self.origins.shape != self.gen_ticks.shape or self.origins.ndim != 2:
            raise ValueError(
                f"origins/gen_ticks must be matching (R, S) arrays, got "
                f"{self.origins.shape} and {self.gen_ticks.shape}"
            )
        if self.seeds.shape[0] != self.origins.shape[0]:
            raise ValueError("one seed per replica required")

    @property
    def num_replicas(self) -> int:
        return int(self.origins.shape[0])

    @property
    def shares_per_replica(self) -> int:
        return int(self.origins.shape[1])

    def replica_schedule(self, r: int, horizon: int) -> Schedule:
        """Replica ``r``'s schedule with sentinel padding stripped — what a
        solo engine run of this replica takes."""
        live = self.gen_ticks[r] < horizon
        return Schedule(self.n, self.origins[r][live], self.gen_ticks[r][live])

    def replica_churn(self, r: int) -> ChurnModel | None:
        if self.churn is None:
            return None
        return ChurnModel(n=self.n, down_start=self.churn[0][r], down_end=self.churn[1][r])


def _stack_churn(
    n: int, horizon: int, seeds, churn_prob: float,
    mean_down_ticks: float, max_outages: int,
) -> tuple[np.ndarray, np.ndarray] | None:
    """Per-replica churn intervals, sampled with the CLI's churn stream
    offset (models/seeds.py) so replica seeds reproduce solo
    ``--churnProb`` runs."""
    if churn_prob <= 0.0:
        return None
    models = [
        random_churn(
            n, horizon, outage_prob=churn_prob,
            mean_down_ticks=mean_down_ticks, max_outages=max_outages,
            seed=churn_stream_seed(s),
        )
        for s in seeds
    ]
    return (
        np.stack([m.down_start for m in models]),
        np.stack([m.down_end for m in models]),
    )


def flood_replicas(
    graph: Graph,
    shares_per_replica: int,
    seeds,
    horizon: int,
    churn_prob: float = 0.0,
    mean_down_ticks: float = 10.0,
    max_outages: int = 1,
) -> ReplicaSet:
    """Seed ensemble for the flood coverage-time experiment: each replica
    floods S shares from seed-sampled random origins at t=0 — the same
    origin stream as the CLI's ``--floodCoverage`` (``default_rng(seed)
    .integers(0, n, S)``), so a solo run with the same seed is the exact
    reference for each replica."""
    seeds = np.asarray(seeds, dtype=np.int64).reshape(-1)
    origins = np.stack(
        [
            np.random.default_rng(int(s))
            .integers(0, graph.n, shares_per_replica)
            .astype(np.int32)
            for s in seeds
        ]
    )
    gen_ticks = np.zeros_like(origins)
    return ReplicaSet(
        n=graph.n, origins=origins, gen_ticks=gen_ticks, seeds=seeds,
        churn=_stack_churn(
            graph.n, horizon, seeds, churn_prob, mean_down_ticks, max_outages
        ),
    )


def gossip_replicas(
    graph: Graph,
    sim_time: float,
    tick_dt: float,
    seeds,
    horizon: int,
    gen_lo: float = 2.0,
    gen_hi: float = 5.0,
    churn_prob: float = 0.0,
    mean_down_ticks: float = 10.0,
    max_outages: int = 1,
) -> ReplicaSet:
    """Seed ensemble for the reference gossip workload: each replica
    samples its own uniform-renewal generation schedule (the reference's
    U(genLo, genHi) process). Schedules have different lengths across
    seeds; all are padded to the longest with the never-fires sentinel."""
    seeds = np.asarray(seeds, dtype=np.int64).reshape(-1)
    scheds = [
        uniform_renewal_schedule(graph.n, sim_time, tick_dt, gen_lo, gen_hi, seed=int(s))
        for s in seeds
    ]
    s_max = max(s.num_shares for s in scheds)
    origins = np.zeros((len(scheds), s_max), dtype=np.int32)
    gen_ticks = np.full((len(scheds), s_max), horizon, dtype=np.int32)
    for r, sched in enumerate(scheds):
        origins[r, : sched.num_shares] = sched.origins
        gen_ticks[r, : sched.num_shares] = sched.gen_ticks
    return ReplicaSet(
        n=graph.n, origins=origins, gen_ticks=gen_ticks, seeds=seeds,
        churn=_stack_churn(
            graph.n, horizon, seeds, churn_prob, mean_down_ticks, max_outages
        ),
    )


@dataclasses.dataclass
class CampaignResult:
    """Per-replica outputs of one campaign cell, plus provenance.

    ``coverage`` is (R, horizon, S) per-tick node counts (None for gossip
    campaigns, which track counters only); counter arrays are (R, N).
    """

    n: int
    seeds: np.ndarray
    generated: np.ndarray
    received: np.ndarray
    sent: np.ndarray
    degree: np.ndarray
    horizon: int
    wall_s: float
    batch_size: int
    coverage: np.ndarray | None = None
    #: Run-level reports that don't fit the per-replica arrays —
    #: mirrors ``NodeStats.extra``.
    extra: dict = dataclasses.field(default_factory=dict)

    @property
    def num_replicas(self) -> int:
        return int(self.seeds.shape[0])

    def replica_stats(self, r: int) -> NodeStats:
        """Replica ``r``'s counters as a NodeStats — the bridge into
        ``utils.analysis`` (redundancy, conservation checks)."""
        received = self.received[r]
        return NodeStats(
            generated=self.generated[r],
            received=received,
            forwarded=received.copy(),
            sent=self.sent[r],
            processed=self.generated[r] + received,
            degree=self.degree,
        )

    def totals_per_replica(self) -> dict[str, np.ndarray]:
        """(R,) totals of each counter — the samples the ensemble CIs and
        redundancy distributions in ``batch.stats`` reduce over."""
        return {
            "generated": self.generated.sum(axis=1),
            "received": self.received.sum(axis=1),
            "sent": self.sent.sum(axis=1),
            "processed": (self.generated + self.received).sum(axis=1),
        }


def _iter_batches(
    replicas: ReplicaSet, batch_size: int, horizon: int, loss_seeds=None
):
    """Slice the replica axis into static-size batches. The last batch is
    padded with sentinel replicas (gen_ticks == horizon everywhere): they
    generate nothing, converge immediately, and their rows are dropped on
    the host side. Yields ``(lo, live, origins, gen_ticks, churn, seeds,
    lseeds)`` — ``seeds`` the replicas' own seeds masked to uint32 (the
    partner-pick streams of the protocol campaigns), ``lseeds`` the
    per-replica loss seeds (None when ``loss_seeds`` is None); both
    zero-padded like the schedules."""
    r_total = replicas.num_replicas
    seeds_u32 = (replicas.seeds & 0xFFFFFFFF).astype(np.uint32)
    lseeds_u32 = (
        None
        if loss_seeds is None
        else (np.asarray(loss_seeds, dtype=np.int64) & 0xFFFFFFFF).astype(np.uint32)
    )
    for lo in range(0, r_total, batch_size):
        hi = min(lo + batch_size, r_total)
        live = hi - lo
        origins = replicas.origins[lo:hi]
        gen_ticks = replicas.gen_ticks[lo:hi]
        seeds = seeds_u32[lo:hi]
        lseeds = None if lseeds_u32 is None else lseeds_u32[lo:hi]
        churn = (
            None
            if replicas.churn is None
            else (replicas.churn[0][lo:hi], replicas.churn[1][lo:hi])
        )
        if live < batch_size:
            pad = batch_size - live
            origins = np.concatenate(
                [origins, np.zeros((pad, origins.shape[1]), dtype=np.int32)]
            )
            gen_ticks = np.concatenate(
                [gen_ticks, np.full((pad, gen_ticks.shape[1]), horizon, dtype=np.int32)]
            )
            seeds = np.concatenate([seeds, np.zeros(pad, dtype=np.uint32)])
            if lseeds is not None:
                lseeds = np.concatenate([lseeds, np.zeros(pad, dtype=np.uint32)])
            if churn is not None:
                zpad = np.zeros((pad,) + churn[0].shape[1:], dtype=np.int32)
                churn = (
                    np.concatenate([churn[0], zpad]),
                    np.concatenate([churn[1], zpad.copy()]),
                )
        yield lo, live, origins, gen_ticks, churn, seeds, lseeds


def _resolve_loss(loss, loss_seeds, r_total: int):
    """The one conversion point between the loss model and the batched
    kernels: returns ``(static_cfg, lseed_array)``.

    - no loss:            ``(None, None)`` — coins off.
    - shared (cell) loss: ``((threshold, seed), None)``.
    - per-replica loss:   ``((threshold, None), (R,) int64 seeds)`` — each
      replica draws its own erasure stream (a solo run with
      ``LinkLossModel(prob, seed=loss_seeds[r])`` reproduces replica r
      bitwise).
    """
    if loss_seeds is not None:
        if loss is None:
            raise ValueError("loss_seeds requires a loss model")
        arr = np.asarray(loss_seeds, dtype=np.int64).reshape(-1)
        if arr.shape[0] != r_total:
            raise ValueError(
                f"loss_seeds must have one seed per replica ({r_total}), "
                f"got {arr.shape[0]}"
            )
        return (loss.threshold, None), arr
    return (loss.static_cfg if loss is not None else None), None


def _campaign_checkpointer(
    checkpoint_path, checkpoint_every, kind: str, graph, replicas: ReplicaSet,
    horizon: int, chunk: int, dg, batch_size: int,
    loss_cfg, loss_seed_arr, arrays: dict, extra: tuple = (), writer: bool = True,
):
    """Batch-boundary checkpointing shared by every campaign runner: the
    accumulated per-replica arrays (counters, and coverage rows — a
    completed batch's coverage is whole) keyed by the JAX package's
    fingerprint, part for part, over the replica seed list and everything
    else that determines the run (``batch_size`` included: it fixes the
    batches the resume index counts)."""
    if checkpoint_path is None:
        return None
    fp = fingerprint(
        "campaign", kind, graph.n, graph.edges(), replicas.origins,
        replicas.gen_ticks, replicas.seeds, horizon, chunk,
        dg.canonical_delays() if isinstance(dg, protocols.PartnerGraph) else
        _canonical_delays(dg), dg.uniform_delay, dg.ring_size, batch_size,
        replicas.churn[0] if replicas.churn is not None else None,
        replicas.churn[1] if replicas.churn is not None else None,
        *(["loss", loss_cfg[0], loss_cfg[1]] if loss_cfg else []),
        *(["lseeds", loss_seed_arr] if loss_seed_arr is not None else []),
        *extra,
    )
    if not writer:  # a mesh rank other than the first: resumes, never writes
        from p2p_gossip_tpu_torch.parallel.engine_sharded import _ReadOnlyCheckpointer

        return _ReadOnlyCheckpointer(checkpoint_path, fp, arrays, checkpoint_every)
    return ChunkCheckpointer(checkpoint_path, fp, arrays, checkpoint_every)


def _resolve_batch(replicas: ReplicaSet, batch_size: int | None, mesh) -> int:
    """The batch size, rounded up to a multiple of the mesh's rank count
    when a ``mesh`` splits the replica axis (sentinel replicas fill it)."""
    if batch_size is None:
        batch_size = replicas.num_replicas
    if batch_size < 1:
        raise ValueError(f"batch_size must be >= 1, got {batch_size}")
    if mesh is not None:
        n = len(mesh.ranks)
        batch_size += (-batch_size) % n
    return batch_size


class _ReplicaSplit:
    """A batch's replica axis over every rank of a ``mesh`` (each rank its
    own contiguous B / ranks replicas, in mesh order), or, without one,
    the whole batch on this process."""

    def __init__(self, mesh, batch_size: int):
        self.mesh = mesh
        self.n, self.i = 1, 0
        if mesh is not None:
            import torch.distributed as dist

            if mesh.coordinate is None:
                raise ValueError("this rank is not in the mesh")
            self.n, self.i = len(mesh.ranks), mesh.ranks.index(dist.get_rank())
        self.size = batch_size // self.n

    @property
    def first(self) -> bool:
        """This process writes the checkpoints and emits the events."""
        return self.mesh is None or self.mesh.is_first

    def part(self, a):
        """This rank's replicas of a (B, ...) array (or a tuple of them)."""
        if a is None:
            return None
        if isinstance(a, tuple):
            return tuple(self.part(x) for x in a)
        return a[self.i * self.size:(self.i + 1) * self.size]

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's (B / ranks, ...) tensor, in batch order: (B, ...)."""
        if self.mesh is None:
            return t
        from p2p_gossip_tpu_torch.parallel.mesh import all_gather_rows

        out = torch.empty((self.n * t.shape[0],) + tuple(t.shape[1:]), dtype=t.dtype,
                          device=t.device)
        all_gather_rows(out, t.contiguous(), self.mesh.group)
        return out


def _emit_replica_telemetry(
    name: str, rings, lo: int, live: int, seeds: np.ndarray, *, t0: int,
    horizon: int, last_head: bool = False, **provenance,
) -> int | None:
    """Harvest a batch's rings (one copy each) into one ``ring`` and one
    ``digest`` event per live replica, with its ``replica`` index and
    ``seed`` (sentinel replicas emit nothing), and return the batch's
    ``digest_head``: replica 0's last nonzero digest, or with ``last_head``
    its last digest (the JAX package's protocol campaign), None without a
    live replica."""
    met, dig = (ring.cpu().numpy() for ring in rings)
    for i in range(live):
        tags = dict(provenance, replica=lo + i, seed=int(seeds[lo + i]))
        tel_rings.emit_ring(name, met[i], t0=t0, **tags)
        tel_digest.emit_digest(name, dig[i], t0=t0, ticks=horizon - t0, **tags)
    if not live:
        return None
    head = dig[0].astype(np.int64) & 0xFFFFFFFF
    if last_head:
        return int(head[-1])
    nz = np.flatnonzero(head)
    return int(head[nz[-1]]) if nz.size else None


def _campaign_generated(replicas: ReplicaSet, horizon: int) -> np.ndarray:
    """(R, N) effective per-node generated counters (churn-aware) — pure
    host arithmetic shared by every campaign flavour."""
    return np.stack(
        [
            effective_generated(
                replicas.replica_schedule(r, horizon), horizon,
                replicas.replica_churn(r),
            )
            for r in range(replicas.num_replicas)
        ]
    )


def _packed_chunk(chunk_size: int | None, s: int) -> int:
    """The pass width of the coverage and protocol campaigns: the caller's,
    or the shares word-rounded with a 128-share floor (the JAX package's
    choice off the TPU; results do not depend on the pad width, and a
    batch of replicas fills the card without the solo 4,096-share pad)."""
    floor = min(MIN_CHUNK_SHARES, 128) if chunk_size is None else chunk_size
    return bitmask.num_words(max(s, floor)) * bitmask.WORD_BITS


def _u32_tensor(values: np.ndarray, dev) -> torch.Tensor:
    """uint32 values as the int32 bit-pattern tensor the kernels read."""
    return torch.as_tensor(
        np.ascontiguousarray(np.asarray(values, dtype=np.uint32).view(np.int32)),
        device=dev,
    )


class _Batch:
    """One replica batch staged for the tick engine: the events as stacked
    rows (row r*N + origin), the per-row degree, churn and loss seeds."""

    def __init__(self, dg, origins, gen_ticks, churn, lseeds, loss_cfg):
        b = origins.shape[0]
        dev = dg.device
        self.size = b
        self.rows = (origins.astype(np.int64) + np.arange(b)[:, None] * dg.n).reshape(-1)
        self.gen_ticks = np.ascontiguousarray(gen_ticks.reshape(-1))
        self.churn = None
        if churn is not None:
            self.churn = tuple(
                torch.as_tensor(np.ascontiguousarray(c.reshape(b * dg.n, -1)), device=dev)
                for c in churn
            )
        self.loss = None
        if loss_cfg is not None:
            seed = loss_cfg[1] if lseeds is None else _u32_tensor(lseeds, dev)
            self.loss = (loss_cfg[0], seed)
        self.degree = dg.degree

    def tick_options(self) -> TickOptions:
        return TickOptions(churn=self.churn, loss=self.loss, replicas=self.size,
                           degree=self.degree.repeat(self.size))

    def events(self, dev):
        """The (B*S,) stacked origins (int64) and gen ticks (int32) on
        ``dev``."""
        return (torch.as_tensor(self.rows, device=dev),
                torch.as_tensor(self.gen_ticks, device=dev))


def run_coverage_campaign(
    graph: Graph,
    replicas: ReplicaSet,
    horizon: int,
    ell_delays: np.ndarray | None = None,
    constant_delay: int = 1,
    loss=None,
    loss_seeds=None,
    batch_size: int | None = None,
    chunk_size: int | None = None,
    block: int | None = None,
    device_graph: DeviceGraph | None = None,
    mesh=None,
    checkpoint_path: str | None = None,
    checkpoint_every: int = 1,
    stop_after_batches: int | None = None,
    *,
    device=None,
    plain: bool = False,
) -> CampaignResult:
    """Coverage-recording campaign: every replica runs the flood/coverage
    experiment (``engine.sync.run_flood_coverage`` semantics — arbitrary
    gen ticks allowed) and records its per-tick coverage history.

    Returns per-replica counters plus a (R, horizon, S) coverage tensor.
    Bitwise contract: row r equals the solo engine's output for replica
    r's schedule/churn under the same loss model. Results do not depend on
    the share pad width; ``chunk_size=None`` pads to a multiple of 32
    shares, at least 128.

    ``loss_seeds`` (one per replica) switches the erasure coin to
    per-replica streams; ``checkpoint_path``/``checkpoint_every`` enable
    batch-boundary snapshots and resume (``stop_after_batches`` ends the
    call early). ``block`` (the JAX degree block) is accepted and unused:
    the CUDA gather has no degree block. ``device=None`` means CUDA;
    ``plain=True`` runs the kernels' plain versions. ``mesh`` splits each
    batch's replicas over the mesh's ranks (every rank calls the runner;
    the mesh's device is the run's), and every rank returns the whole
    campaign.
    """
    batch_size = _resolve_batch(replicas, batch_size, mesh)
    split = _ReplicaSplit(mesh, batch_size)
    s = replicas.shares_per_replica
    dg = _stage(graph, ell_delays, constant_delay, device_graph,
                device if mesh is None else mesh.device)
    chunk = _packed_chunk(chunk_size, s)
    loss_cfg, lseed_arr = _resolve_loss(loss, loss_seeds, replicas.num_replicas)
    r_total = replicas.num_replicas
    log.info(
        f"coverage campaign: {r_total} replicas x {graph.n} nodes x {s} "
        f"shares, batch {batch_size}, horizon {horizon}"
    )

    received = np.zeros((r_total, graph.n), dtype=np.int64)
    sent = np.zeros((r_total, graph.n), dtype=np.int64)
    coverage = np.zeros((r_total, horizon, s), dtype=np.int32)
    checkpointer = _campaign_checkpointer(
        checkpoint_path, checkpoint_every, "coverage", graph, replicas,
        horizon, chunk, dg, batch_size, loss_cfg, lseed_arr,
        {"received": received, "sent": sent, "coverage": coverage}, writer=split.first,
    )
    name = "batch.campaign.run_coverage_campaign"
    tel = tel_sink.rings_enabled()
    batches = list(_iter_batches(replicas, batch_size, horizon, lseed_arr))
    t0 = time.perf_counter()
    for bi, batch in checkpointed_chunks(batches, checkpointer, stop_after_batches):
        lo, live, origins, gen_ticks, churn, _seeds, lseeds = batch
        pad_o = np.zeros((split.size, chunk), dtype=np.int32)
        pad_g = np.full((split.size, chunk), horizon, dtype=np.int32)
        pad_o[:, :s] = split.part(origins)
        pad_g[:, :s] = split.part(gen_ticks)
        staged = _Batch(dg, pad_o, pad_g, split.part(churn), split.part(lseeds), loss_cfg)
        rows, ticks = staged.events(dg.device)
        fire = staged.gen_ticks[staged.gen_ticks < horizon]
        rings = tel_rings.chunk_rings(horizon, dg.device, split.size) if tel else None
        with span("dispatch", kernel="batch.campaign._run_coverage_batch", batch=bi):
            _, r, snt, cov = _run_chunk_coverage(
                dg, rows, ticks, chunk_size=chunk, horizon=horizon,
                last_gen=int(fire.max()) if fire.size else 0,
                coverage_slots=s, opts=staged.tick_options(), rings=rings, plain=plain,
            )
        r, snt = (split.gather(x.view(split.size, -1)) for x in (r, snt))
        cov = split.gather(cov)
        rings = None if rings is None else tuple(split.gather(x) for x in rings)
        with span("d2h", batch=bi):
            received[lo : lo + live] = r[:live].cpu().numpy()
            sent[lo : lo + live] = snt[:live].cpu().numpy()
            coverage[lo : lo + live] = cov[:live].cpu().numpy()
        head = None
        if tel and split.first:
            head = _emit_replica_telemetry(name, rings, lo, live, replicas.seeds, t0=0,
                                           horizon=horizon)
        if split.first:
            tel_progress.emit_progress(name, chunk=bi, chunks_total=len(batches),
                                       digest_head=head)
    wall = time.perf_counter() - t0

    return CampaignResult(
        n=graph.n,
        seeds=replicas.seeds,
        generated=_campaign_generated(replicas, horizon),
        received=received,
        sent=sent,
        degree=graph.degree.astype(np.int64),
        horizon=horizon,
        wall_s=wall,
        batch_size=batch_size,
        coverage=coverage,
    )


def run_gossip_campaign(
    graph: Graph,
    replicas: ReplicaSet,
    horizon: int,
    ell_delays: np.ndarray | None = None,
    constant_delay: int = 1,
    loss=None,
    loss_seeds=None,
    batch_size: int | None = None,
    chunk_size: int = 4096,
    block: int | None = None,
    device_graph: DeviceGraph | None = None,
    mesh=None,
    checkpoint_path: str | None = None,
    checkpoint_every: int = 1,
    stop_after_batches: int | None = None,
    *,
    device=None,
    plain: bool = False,
) -> CampaignResult:
    """Counter-only campaign of the full gossip workload: R replicas of
    the reference simulation (per-replica generation schedules, arbitrary
    share counts) chunked over the share axis like the solo engine —
    counters are additive across chunks per replica. Per-replica counters
    are bitwise-identical to solo ``run_sync_sim`` with the same seed.
    A chunk runs from the batch's first live generation tick to its
    last; a replica whose own window is narrower runs identity ticks at
    the edges. The rest as in `run_coverage_campaign` (checkpoints land
    at replica-batch boundaries, each batch running all its chunks)."""
    batch_size = _resolve_batch(replicas, batch_size, mesh)
    split = _ReplicaSplit(mesh, batch_size)
    s_max = replicas.shares_per_replica
    chunk = min(chunk_size, max(MIN_CHUNK_SHARES, s_max))
    chunk = bitmask.num_words(chunk) * bitmask.WORD_BITS
    dg = _stage(graph, ell_delays, constant_delay, device_graph,
                device if mesh is None else mesh.device)
    loss_cfg, lseed_arr = _resolve_loss(loss, loss_seeds, replicas.num_replicas)
    r_total = replicas.num_replicas
    n_chunks = max(1, -(-s_max // chunk))
    log.info(
        f"gossip campaign: {r_total} replicas x {graph.n} nodes, up to "
        f"{s_max} shares in {n_chunks} chunk(s) of {chunk}, batch "
        f"{batch_size}, horizon {horizon}"
    )

    received = np.zeros((r_total, graph.n), dtype=np.int64)
    sent = np.zeros((r_total, graph.n), dtype=np.int64)
    checkpointer = _campaign_checkpointer(
        checkpoint_path, checkpoint_every, "gossip", graph, replicas,
        horizon, chunk, dg, batch_size, loss_cfg, lseed_arr,
        {"received": received, "sent": sent}, writer=split.first,
    )
    name = "batch.campaign.run_gossip_campaign"
    tel = tel_sink.rings_enabled()
    batches = list(_iter_batches(replicas, batch_size, horizon, lseed_arr))
    t0 = time.perf_counter()
    for bi, batch in checkpointed_chunks(batches, checkpointer, stop_after_batches):
        lo, live, origins, gen_ticks, churn, _seeds, lseeds = batch
        for ci in range(n_chunks):
            o_slice = origins[:, ci * chunk : (ci + 1) * chunk]
            g_slice = gen_ticks[:, ci * chunk : (ci + 1) * chunk]
            if not (g_slice < horizon).any():
                continue
            pad_o = np.zeros((batch_size, chunk), dtype=np.int32)
            pad_g = np.full((batch_size, chunk), horizon, dtype=np.int32)
            pad_o[:, : o_slice.shape[1]] = o_slice
            pad_g[:, : g_slice.shape[1]] = g_slice
            # The whole batch's first and last live ticks, on every rank.
            live_ticks = pad_g[pad_g < horizon]
            t_start = int(live_ticks.min())
            staged = _Batch(dg, split.part(pad_o), split.part(pad_g), split.part(churn),
                            split.part(lseeds), loss_cfg)
            rows, ticks = staged.events(dg.device)
            rings = tel_rings.chunk_rings(horizon, dg.device, split.size) if tel else None
            with span("dispatch", kernel="batch.campaign._run_while_batch",
                      batch=bi, chunk=ci):
                _, r, snt, _, _ = _run_chunk_while(
                    dg, rows, ticks, t_start, int(live_ticks.max()),
                    chunk_size=chunk, horizon=horizon, opts=staged.tick_options(),
                    rings=rings, plain=plain,
                )
            r, snt = (split.gather(x.view(split.size, -1)) for x in (r, snt))
            rings = None if rings is None else tuple(split.gather(x) for x in rings)
            with span("d2h", batch=bi, chunk=ci):
                received[lo : lo + live] += r[:live].cpu().numpy()
                sent[lo : lo + live] += snt[:live].cpu().numpy()
            head = None
            if tel and split.first:
                head = _emit_replica_telemetry(name, rings, lo, live, replicas.seeds,
                                               t0=t_start, horizon=horizon, chunk=ci)
            if split.first:
                tel_progress.emit_progress(name, chunk=bi, chunks_total=len(batches),
                                           digest_head=head)
    wall = time.perf_counter() - t0

    return CampaignResult(
        n=graph.n,
        seeds=replicas.seeds,
        generated=_campaign_generated(replicas, horizon),
        received=received,
        sent=sent,
        degree=graph.degree.astype(np.int64),
        horizon=horizon,
        wall_s=wall,
        batch_size=batch_size,
        coverage=None,
    )


def run_protocol_campaign(
    graph: Graph,
    replicas: ReplicaSet,
    horizon: int,
    protocol: str = "pushpull",
    fanout: int = 2,
    ell_delays: np.ndarray | None = None,
    constant_delay: int = 1,
    loss=None,
    loss_seeds=None,
    batch_size: int | None = None,
    chunk_size: int | None = None,
    device_graph: protocols.PartnerGraph | None = None,
    record_coverage: bool = True,
    mesh=None,
    checkpoint_path: str | None = None,
    checkpoint_every: int = 1,
    stop_after_batches: int | None = None,
    *,
    device=None,
    plain: bool = False,
) -> CampaignResult:
    """Replica campaign of the random-partner protocols: ``pushpull`` /
    ``pull`` anti-entropy and ``pushk`` fanout push (``models/protocols.py``),
    B replicas a batch through one round loop (one ``scatter_or`` launch a
    round for the batch).

    Bitwise contract: row r of every output equals a solo
    ``run_pushpull_sim``/``run_pushk_sim`` run with ``seed=replicas.seeds[r]``
    and replica r's schedule/churn under the same loss model, coverage
    history included. ``loss_seeds`` gives each replica its own erasure
    stream (solo reference: ``LinkLossModel(prob, seed=loss_seeds[r])``);
    without it the cell's one loss seed applies to every replica.

    ``chunk_size=None`` pads a pass to a multiple of 32 shares, at least
    128; shares beyond one pass run in chunks with exactly additive
    counters. Checkpoints land at replica-batch boundaries, as in
    `run_coverage_campaign`. The graph is staged as the solo protocols
    stage it, its CSR (`models.protocols.PartnerGraph`; ``ell_delays`` one
    delay per CSR entry or the (N, dmax) ELL), or ``device_graph`` is that
    staging. ``extra["rounds_executed"]``: the rounds run, horizon x passes
    x batches. Spans ``inputs``, ``d2h`` and ``stats`` as the flood
    entries'.
    """
    if protocol not in ("pushpull", "pull", "pushk"):
        raise ValueError(f"protocol must be pushpull|pull|pushk, got {protocol!r}")
    if protocol == "pushk" and fanout < 1:
        raise ValueError(f"fanout must be >= 1, got {fanout}")
    batch_size = _resolve_batch(replicas, batch_size, mesh)
    split = _ReplicaSplit(mesh, batch_size)
    dg = protocols._stage(graph, ell_delays, constant_delay, device_graph,
                          device if mesh is None else mesh.device)
    if dg.ring_size * split.size * dg.n >= 1 << 31:
        raise ValueError("ring slots x replicas x nodes must stay below 2^31 "
                         "(int32 ring rows): lower batch_size")
    s = replicas.shares_per_replica
    if chunk_size is None:
        chunk_size = min(max(s, 1), min(MIN_CHUNK_SHARES, 128))
    chunk = bitmask.num_words(max(chunk_size, 1)) * bitmask.WORD_BITS
    if protocol == "pull":
        protocols.check_pull_credit_width(graph, chunk)
    loss_cfg, lseed_arr = _resolve_loss(loss, loss_seeds, replicas.num_replicas)
    loss_thr = loss_cfg[0] if loss_cfg is not None else 0
    if lseed_arr is None:
        # The cell's one loss seed rides the per-replica seed array, as in
        # the JAX package (the same coins as the solo path).
        shared = loss_cfg[1] if loss_cfg is not None else 0
        lseed_arr = np.full(replicas.num_replicas, shared, dtype=np.int64)
    r_total = replicas.num_replicas
    n_chunks = max(1, -(-max(s, 1) // chunk))
    log.info(
        f"{protocol} campaign: {r_total} replicas x {graph.n} nodes x {s} "
        f"shares in {n_chunks} chunk(s) of {chunk}, batch {batch_size}, "
        f"horizon {horizon}"
    )

    received = np.zeros((r_total, graph.n), dtype=np.int64)
    sent = np.zeros((r_total, graph.n), dtype=np.int64)
    coverage = np.zeros((r_total, horizon, s), dtype=np.int32) if record_coverage else None
    arrays = {"received": received, "sent": sent}
    if record_coverage:
        arrays["coverage"] = coverage
    checkpointer = _campaign_checkpointer(
        checkpoint_path, checkpoint_every, "protocol", graph, replicas,
        horizon, chunk, dg, batch_size, loss_cfg, lseed_arr, arrays,
        extra=(protocol, fanout if protocol == "pushk" else None), writer=split.first,
    )
    dev = dg.device
    c = fanout if protocol == "pushk" else 1
    b = split.size
    nodes = torch.arange(b * dg.n, dtype=torch.int64, device=dev) % dg.n
    picks = torch.arange(c, dtype=torch.int64, device=dev)
    name = f"batch.campaign.run_protocol_campaign[{protocol}]"
    tel = tel_sink.rings_enabled()
    batches = list(_iter_batches(replicas, batch_size, horizon, lseed_arr))
    t0 = time.perf_counter()
    rounds = 0
    for bi, batch in checkpointed_chunks(batches, checkpointer, stop_after_batches):
        with span("inputs", shares=s * b, batch=bi):
            lo, live, origins, gen_ticks, churn, seeds, lseeds = batch
            origins, gen_ticks, churn, seeds, lseeds = (
                split.part(x) for x in (origins, gen_ticks, churn, seeds, lseeds))
            row_seeds = _u32_tensor(seeds, dev).repeat_interleave(dg.n)
            key = pick_key(nodes[:, None], picks[None, :], row_seeds[:, None])
            loss_dev = None
            if loss_thr > 0:
                loss_dev = (loss_thr,
                            _u32_tensor(lseeds, dev).repeat_interleave(dg.n)[None, :, None])
            staged = _Batch(dg, origins, gen_ticks, churn, None, None)
        for ci in range(n_chunks):
            with span("inputs", shares=chunk * b, batch=bi, chunk=ci):
                lo_s, hi_s = ci * chunk, min((ci + 1) * chunk, s)
                live_s = hi_s - lo_s
                pad_o = np.zeros((b, chunk), dtype=np.int64)
                pad_g = np.full((b, chunk), horizon, dtype=np.int32)
                rows = staged.rows.reshape(b, s)
                pad_o[:, :live_s] = rows[:, lo_s:hi_s]
                pad_g[:, :live_s] = gen_ticks[:, lo_s:hi_s]
            rings = tel_rings.chunk_rings(horizon, dev, b) if tel else None
            rounds += horizon
            with span("dispatch", kernel=f"batch.campaign.{protocol}_replicas",
                      batch=bi, chunk=ci):
                r, snt, cov = protocols._run_chunk(
                    dg, pad_o.reshape(-1), pad_g.reshape(-1), key, None, staged.churn,
                    loss_dev, mode=protocol, chunk_size=chunk, horizon=horizon,
                    n_cov=live_s if record_coverage else None, plain=plain,
                    rings=rings, replicas=b,
                )[:3]  # the pass's ring is freed before the next pass allocates its own
            r, snt = (split.gather(x.view(b, -1)) for x in (r, snt))
            if record_coverage:
                cov = split.gather(cov)
            rings = None if rings is None else tuple(split.gather(x) for x in rings)
            with span("d2h", batch=bi, chunk=ci):
                received[lo : lo + live] += r[:live].cpu().numpy()
                sent[lo : lo + live] += snt[:live].cpu().numpy()
                if record_coverage:
                    coverage[lo : lo + live, :, lo_s:hi_s] = cov[:live].cpu().numpy()
            head = None
            if tel and split.first:
                head = _emit_replica_telemetry(name, rings, lo, live, replicas.seeds, t0=0,
                                               horizon=horizon, last_head=True, chunk=ci)
            if split.first:
                tel_progress.emit_progress(name, chunk=bi, chunks_total=len(batches),
                                           digest_head=head)
    wall = time.perf_counter() - t0

    with span("stats"):
        result = CampaignResult(
            n=graph.n,
            seeds=replicas.seeds,
            generated=_campaign_generated(replicas, horizon),
            received=received,
            sent=sent,
            degree=graph.degree.astype(np.int64),
            horizon=horizon,
            wall_s=wall,
            batch_size=batch_size,
            coverage=coverage,
        )
        result.extra["rounds_executed"] = rounds
    return result


# --- audit specs (staticcheck/: the op audit runs these tiny cases) ---------
# A campaign batch is the tick engine's loop with B replicas stacked along
# the rows: the JAX package's ``_audit_spec_batch`` (B = 2, the loss coin on,
# one loss seed a replica) through `engine.sync._audit_spec`.

from p2p_gossip_tpu_torch.engine import sync as _sync  # noqa: E402
from p2p_gossip_tpu_torch.staticcheck.registry import register_entry  # noqa: E402

for _kind, _fn, _jax in (("while", _sync._run_chunk_while, "batch.campaign._run_while_batch"),
                         ("coverage", _sync._run_chunk_coverage,
                          "batch.campaign._run_coverage_batch")):
    register_entry(f"engine.sync.{_fn.__name__}[replicas]", _fn,
                   spec=lambda k=_kind: _sync._audit_spec(k, replicas=2), counterpart=_jax,
                   host_reads_per_tick=1, tick_bodies=_sync._TICK_BODIES)
    register_entry(f"engine.sync.{_fn.__name__}[replicas][telemetry]", _fn,
                   spec=lambda k=_kind: _sync._audit_spec(k, telemetry=True, replicas=2),
                   counterpart=f"{_jax}[telemetry]", host_reads_per_tick=1,
                   tick_bodies=_sync._TICK_BODIES + _sync._TELEMETRY_BODIES)
