"""Campaigns x shards: R replicas of a node-sharded graph over a factorized
``(replicas, nodes)`` mesh of ``torch.distributed`` ranks, the counterpart
of the JAX package's ``batch/campaign_sharded.py``.

`batch.campaign` batches replicas of the single-device engines (graphs
that fit one card); `parallel.engine_sharded` and
`parallel.protocols_sharded` shard one run's graph rows over the mesh, one
seed at a time. Here the mesh's first axis carries replica shards (pure
data parallelism: no traffic between them but the mesh-wide stop flag of
the flood) and its second the node shards (the frontier exchange rides
inside each replica shard); each rank runs its replica shard's
``local_replicas`` rb replicas stacked along the rows of the same runner
(`_Runner(..., replicas=rb)`), every kernel launch and every collective
covering the local batch. Every rank of the mesh calls the same runner.

Bitwise contract: replica r equals the solo ``run_sharded_sim`` /
``run_sharded_flood_coverage`` / ``run_sharded_partnered_sim`` run with
replica r's schedule, churn and seeds on a nodes-only mesh (and so the
single-device engines), for every axis split, ring mode and exchange:
loss coins and partner picks hash global node ids with the replica's own
seed, and the ticks a replica runs past its own quiescence (the batch
stops at its slowest replica, mesh-wide) are identities. Counters,
coverage rows, ``extra['ring' | 'mesh' | 'exchange']``, telemetry events
and checkpoints (the JAX package's ``"campaign_sharded"`` fingerprint:
either package resumes the other's) equal the JAX package's.

The delta exchange keeps each replica's own overflow flag a slot; a slot
flagged in any local replica is read dense for the whole local batch (the
values a gather reads are equal either way), while the achieved counters
in ``extra['exchange']`` count each replica's own flags, as JAX's select
under vmap does.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from p2p_gossip_tpu_torch.batch.campaign import (
    CampaignResult,
    ReplicaSet,
    _campaign_generated,
    _iter_batches,
    _resolve_loss,
    _u32_tensor,
)
from p2p_gossip_tpu_torch.models.protocols import _check_pull_credit_bound
from p2p_gossip_tpu_torch.models.topology import Graph
from p2p_gossip_tpu_torch.ops import bitmask
from p2p_gossip_tpu_torch.parallel.engine_sharded import (
    _achieved_exchange_report,
    _agree,
    _plan,
    _ReadOnlyCheckpointer,
    _Runner,
    stage_sharded_graph,
)
from p2p_gossip_tpu_torch.parallel.mesh import NODES_AXIS, REPLICAS_AXIS
from p2p_gossip_tpu_torch.parallel import protocols_sharded as ps
from p2p_gossip_tpu_torch.telemetry import digest as tel_digest
from p2p_gossip_tpu_torch.telemetry import progress as tel_progress
from p2p_gossip_tpu_torch.telemetry import rings as tel_rings
from p2p_gossip_tpu_torch.telemetry import sink as tel_sink
from p2p_gossip_tpu_torch.telemetry.spans import span
from p2p_gossip_tpu_torch.utils.checkpoint import (
    ChunkCheckpointer,
    checkpointed_chunks,
    fingerprint,
)

_U32 = 0xFFFFFFFF


def _campaign_mesh_dims(mesh) -> tuple[int, int]:
    """(replica_shards, node_shards) of a factorized campaign mesh."""
    if REPLICAS_AXIS not in mesh.shape or NODES_AXIS not in mesh.shape:
        raise ValueError(
            "sharded campaigns need a (replicas, nodes) mesh — build it "
            "with parallel.mesh.make_mesh(replicas=...)"
        )
    if mesh.coordinate is None:
        raise ValueError("this rank is not in the mesh")
    return int(mesh.shape[REPLICAS_AXIS]), int(mesh.shape[NODES_AXIS])


def _resolve_campaign_batch(replicas: ReplicaSet, batch_size: int | None,
                            replica_shards: int) -> int:
    """Batch size rounded UP to a multiple of the replica-shard count, so a
    batch splits evenly over the replica axis; sentinel replicas fill the
    overhang."""
    if batch_size is None:
        batch_size = replicas.num_replicas
    if batch_size < 1:
        raise ValueError(f"batch_size must be >= 1, got {batch_size}")
    if batch_size % replica_shards:
        batch_size += replica_shards - batch_size % replica_shards
    return batch_size


def _campaign_chunk(shares: int, chunk_size: int | None) -> int:
    """The single share-pass width: every replica's whole padded schedule
    rides one pass. The JAX package's rule off the TPU (the word-rounded
    share count, no lane floor), on the CPU and the card alike: the width
    sets ``extra['exchange']``'s word counts and the checkpoint
    fingerprint."""
    if chunk_size is None:
        chunk_size = shares
    if chunk_size < shares:
        raise ValueError(
            f"sharded campaigns run one share pass per replica: chunk_size "
            f"({chunk_size}) must cover shares_per_replica ({shares})"
        )
    return bitmask.num_words(max(1, chunk_size)) * bitmask.WORD_BITS


def _pad_batch_churn(churn, batch: int, n_padded: int):
    """(B, N, K) churn intervals padded to the graph's node rows (padding
    rows have start == end: never down); None when churn is off."""
    if churn is None:
        return None
    cs, ce = churn
    pad = n_padded - cs.shape[1]
    if pad:
        cs = np.pad(cs, ((0, 0), (0, pad), (0, 0)))
        ce = np.pad(ce, ((0, 0), (0, pad), (0, 0)))
    return (np.ascontiguousarray(cs, dtype=np.int32), np.ascontiguousarray(ce, dtype=np.int32))


def _campaign_loss_seeds(loss_cfg, lseed_arr, r_total: int):
    """A loss model always runs with one loss seed a replica: the
    per-replica seeds, or the cell's one seed for every replica (the same
    coins as the static seed). Returns ``(static (threshold, None), seeds)``
    or ``(None, None)``."""
    if loss_cfg is None:
        return None, None
    thr, static_seed = loss_cfg
    if lseed_arr is None:
        lseed_arr = np.full(r_total, int(static_seed) & _U32, dtype=np.int64)
    return (thr, None), lseed_arr


def _pad_batch_schedule(origins, gen_ticks, chunk: int, horizon: int):
    """(B, S) schedules padded to the pass width with the never-fires
    sentinel."""
    b, s = origins.shape
    pad_o = np.zeros((b, chunk), dtype=np.int32)
    pad_g = np.full((b, chunk), horizon, dtype=np.int32)
    pad_o[:, :s] = origins
    pad_g[:, :s] = gen_ticks
    return pad_o, pad_g


def _checkpointer(mesh, path, every, arrays, *parts):
    if path is None:
        return None
    cls = ChunkCheckpointer if mesh.is_first else _ReadOnlyCheckpointer
    return cls(path, fingerprint(*parts), arrays, every)


def _emit(name, rings, t0, lo, live, seeds, protocol: bool):
    """One ``ring`` and one ``digest`` event per live replica of a batch
    (with its ``replica`` and ``seed``), the JAX package's slicing; returns
    the batch's ``digest_head``."""
    mets, digs = rings
    digs = digs.astype(np.int64) & _U32
    for i in range(live):
        tags = dict(replica=lo + i, seed=int(seeds[lo + i]))
        if protocol:
            tel_rings.emit_ring(name, mets[i], t0=0, ticks=mets.shape[1], **tags)
            tel_digest.emit_digest(name, digs[i], t0=0, ticks=digs.shape[1], **tags)
            continue
        tel_rings.emit_ring(name, mets[i], t0=t0, **tags)
        nz = np.flatnonzero(digs[i])
        tel_digest.emit_digest(name, digs[i], t0=t0,
                               ticks=int(nz[-1]) + 1 - t0 if nz.size else 0, **tags)
    if protocol:
        return int(digs[0][-1]) if live else None
    nz = np.flatnonzero(digs[0])
    return int(digs[0][nz[-1]]) if nz.size else None


def _local(batch_arr, q: int, rb: int):
    return None if batch_arr is None else batch_arr[q * rb:(q + 1) * rb]


def run_sharded_campaign(
    graph: Graph,
    replicas: ReplicaSet,
    horizon: int,
    mesh,
    ell_delays: np.ndarray | None = None,
    constant_delay: int = 1,
    loss=None,
    loss_seeds=None,
    batch_size: int | None = None,
    chunk_size: int | None = None,
    block: int | None = None,
    record_coverage: bool = False,
    checkpoint_path: str | None = None,
    checkpoint_every: int = 1,
    stop_after_batches: int | None = None,
    ring_mode: str = "auto",
    bucket_min_rows: int = 2048,
    exchange: str = "dense",
    async_k: int = 2,
    hub_rows: int | None = None,
    aux_cache: tuple | None = None,
    *,
    sharded_graph=None,
    plain: bool = False,
) -> CampaignResult:
    """Seed-ensemble flood campaign over a (replicas, nodes) mesh
    (``parallel.mesh.make_mesh(replicas=...)``), called by every rank of
    the mesh: the JAX package's ``run_sharded_campaign``, argument for
    argument. Replica r's counters (and coverage, with
    ``record_coverage``) are bitwise those of the solo sharded flood with
    replica r's schedule, churn and loss seed.

    ``loss``/``loss_seeds`` as in `batch.campaign` (a shared model, or one
    erasure stream a replica). ``exchange`` "dense" / "delta" / "auto" /
    "hub" and the async spellings with ``async_k`` resolve as in
    `run_sharded_sim`: the delta capacity and the hub split are planned
    once from the graph's cut and shared by every replica. Checkpoints
    land at batch boundaries (the first rank writes, every rank reads).
    ``result.extra`` holds ``ring``, ``mesh``, ``exchange`` (the achieved
    report on delta and hub) and ``resident_bytes`` (this rank's modeled
    peak). ``sharded_graph`` (from `stage_sharded_graph` on this mesh)
    skips the host staging; ``plain=True`` runs the kernels' plain
    versions."""
    replica_shards, node_shards = _campaign_mesh_dims(mesh)
    r_total = replicas.num_replicas
    s = replicas.shares_per_replica
    batch_size = _resolve_campaign_batch(replicas, batch_size, replica_shards)
    rb = batch_size // replica_shards
    chunk = _campaign_chunk(s, chunk_size)
    if sharded_graph is None:
        sharded_graph = stage_sharded_graph(graph, mesh, ell_delays, constant_delay, block,
                                            bucket_min_rows)
    plan, need, hub = _plan(sharded_graph, mesh, chunk, ring_mode, exchange, async_k,
                            hub_rows, aux_cache)
    loss_cfg, lseed_arr = _resolve_loss(loss, loss_seeds, r_total)
    static_loss, lseed_arr = _campaign_loss_seeds(loss_cfg, lseed_arr, r_total)
    tel = _agree(mesh, tel_sink.rings_enabled())
    runner = _Runner(plan, mesh, sharded_graph, need, hub, None, static_loss, 0, tel, plain,
                     replicas=rb)
    n_padded, n_loc, q, lo_row = plan.n_padded, plan.n_loc, runner.q, runner.row_offset
    cov_slots = s if record_coverage else None

    received = np.zeros((r_total, n_padded), dtype=np.int64)
    sent = np.zeros((r_total, n_padded), dtype=np.int64)
    coverage = np.zeros((r_total, horizon, s), dtype=np.int64) if record_coverage else None
    arrays = {"received": received, "sent": sent}
    if record_coverage:
        arrays["coverage"] = coverage
    checkpointer = _checkpointer(
        mesh, checkpoint_path, checkpoint_every, arrays,
        "campaign_sharded", "flood", graph.n, graph.edges(), replicas.origins,
        replicas.gen_ticks, replicas.seeds, horizon, chunk, replica_shards, node_shards,
        batch_size, ell_delays if ell_delays is not None else constant_delay,
        plan.ring_mode, plan.mode, int(record_coverage),
        *(["async", plan.async_k] if plan.async_k else []),
        replicas.churn[0] if replicas.churn is not None else None,
        replicas.churn[1] if replicas.churn is not None else None,
        *(["loss", static_loss[0]] if static_loss else []),
        *(["lseeds", lseed_arr] if lseed_arr is not None else []),
    )

    name = "batch.campaign_sharded.run_sharded_campaign"
    # Used entries, overflow ticks, fallbacks, ticks, over the live replicas.
    exch_totals = np.zeros(4, dtype=np.int64)
    batches = list(_iter_batches(replicas, batch_size, horizon, lseed_arr))
    t0 = time.perf_counter()
    for bi, batch in checkpointed_chunks(batches, checkpointer, stop_after_batches):
        lo, live, origins_b, gen_b, churn_b, _seeds, lseeds_b = batch
        pad_o, pad_g = _pad_batch_schedule(origins_b, gen_b, chunk, horizon)
        live_ticks = pad_g[pad_g < horizon]
        if live_ticks.size == 0:
            continue  # every replica in the batch is sentinel padding
        # The batch's first and last live generation ticks: a replica with
        # a narrower window runs identity ticks at the edges.
        t_start, last_gen = int(live_ticks.min()), int(live_ticks.max())
        churn = _pad_batch_churn(churn_b, batch_size, n_padded)
        if churn is not None:
            churn = tuple(
                torch.as_tensor(np.ascontiguousarray(
                    c[q * rb:(q + 1) * rb, lo_row:lo_row + n_loc].reshape(rb * n_loc, -1)),
                    device=runner.dev) for c in churn)
        seeds_dev = None
        if static_loss is not None:
            seeds_dev = _u32_tensor(_local(lseeds_b, q, rb), runner.dev)
        with span("dispatch", kernel="parallel.engine_sharded.flood_runner[campaign]",
                  batch=bi):
            out = runner.run_pass(_local(pad_o, q, rb), _local(pad_g, q, rb), t_start,
                                  last_gen, horizon, [], cov_slots=cov_slots, churn=churn,
                                  loss_seeds=seeds_dev)
        with span("d2h", batch=bi):
            c = out["counters"].astype(np.int64)
            received[lo:lo + live] = c[:live, 0]
            sent[lo:lo + live] = c[:live, 1]
            if record_coverage:
                coverage[lo:lo + live] = out["coverage"][:live, :, :s]
        exch_totals += out["exchange_per"][:live].sum(axis=0)
        if mesh.is_first:
            head = None
            if tel:
                head = _emit(name, out["rings"], t_start, lo, live, replicas.seeds, False)
            tel_progress.emit_progress(name, chunk=bi, chunks_total=len(batches),
                                       digest_head=head)
    wall = time.perf_counter() - t0

    extra = {
        "ring": plan.ring_extra,
        "mesh": {"replica_shards": replica_shards, "node_shards": node_shards,
                 "local_replicas": rb},
        "exchange": plan.exchange_extra,
    }
    if plan.delta:
        used, ovf, fallbacks, ticks = (int(v) for v in exch_totals)
        extra["exchange"] = _achieved_exchange_report(
            plan.exchange_extra, (used, ovf, fallbacks), ticks, node_shards, n_loc, plan.w,
            plan.capacity, hub_count=plan.hub_count)
    extra["resident_bytes"] = runner.resident_bytes(horizon, cov_slots)
    return CampaignResult(
        n=graph.n, seeds=replicas.seeds, generated=_campaign_generated(replicas, horizon),
        received=received[:, :graph.n], sent=sent[:, :graph.n],
        degree=graph.degree.astype(np.int64), horizon=horizon, wall_s=wall,
        batch_size=batch_size, coverage=coverage, extra=extra,
    )


def run_sharded_protocol_campaign(
    graph: Graph,
    replicas: ReplicaSet,
    horizon: int,
    mesh,
    protocol: str = "pushpull",
    fanout: int = 2,
    ell_delays: np.ndarray | None = None,
    constant_delay: int = 1,
    loss=None,
    loss_seeds=None,
    batch_size: int | None = None,
    chunk_size: int | None = None,
    record_coverage: bool = False,
    checkpoint_path: str | None = None,
    checkpoint_every: int = 1,
    stop_after_batches: int | None = None,
    ring_mode: str = "auto",
    exchange: str = "dense",
    async_k: int = 2,
    hub_rows: int | None = None,
    *,
    plain: bool = False,
) -> CampaignResult:
    """Seed-ensemble random-partner campaign over a (replicas, nodes) mesh,
    called by every rank of the mesh: the JAX package's
    ``run_sharded_protocol_campaign``, argument for argument, the campaign
    counterpart of `run_sharded_partnered_sim`. Replica r is bitwise its
    solo partnered run with ``seed=replicas.seeds[r]`` (and its schedule,
    churn and loss seed), under the async spellings too (anti-entropy
    only, delays clamped to max(d, K)); "hub" plans the degree split once
    for every replica. ``result.extra`` as in `run_sharded_campaign`."""
    if protocol not in ps.PROTOCOLS:
        raise ValueError(f"unknown protocol {protocol!r}")
    replica_shards, node_shards = _campaign_mesh_dims(mesh)
    r_total = replicas.num_replicas
    s = replicas.shares_per_replica
    batch_size = _resolve_campaign_batch(replicas, batch_size, replica_shards)
    rb = batch_size // replica_shards
    chunk = _campaign_chunk(s, chunk_size)
    if protocol == "pull":
        for r in range(r_total):
            _check_pull_credit_bound(graph, chunk, replicas.replica_schedule(r, horizon))
    plan, (ell_idx, delays, degree, hub_plan), ring_extra, exchange_extra = (
        ps.stage_partnered(graph, mesh, protocol, fanout, ell_delays, constant_delay, chunk,
                           ring_mode, exchange, async_k, hub_rows))
    loss_cfg, lseed_arr = _resolve_loss(loss, loss_seeds, r_total)
    static_loss, lseed_arr = _campaign_loss_seeds(loss_cfg, lseed_arr, r_total)
    tel = _agree(mesh, tel_sink.rings_enabled())
    runner = ps._Runner(plan, mesh, ell_idx, delays, degree, hub_plan, None, loss, 0, tel,
                        plain, replicas=rb)
    n_padded, q = plan.n_padded, runner.q

    received = np.zeros((r_total, n_padded), dtype=np.int64)
    sent = np.zeros((r_total, n_padded), dtype=np.int64)
    coverage = np.zeros((r_total, horizon, s), dtype=np.int64) if record_coverage else None
    arrays = {"received": received, "sent": sent}
    if record_coverage:
        arrays["coverage"] = coverage
    checkpointer = _checkpointer(
        mesh, checkpoint_path, checkpoint_every, arrays,
        "campaign_sharded", protocol, fanout if protocol == "pushk" else 1,
        graph.n, graph.edges(), replicas.origins, replicas.gen_ticks, replicas.seeds,
        horizon, chunk, replica_shards, node_shards, batch_size,
        ell_delays if ell_delays is not None else constant_delay,
        ring_extra["mode"], plan.transport, int(record_coverage),
        *(["async", plan.async_k] if plan.async_k else []),
        replicas.churn[0] if replicas.churn is not None else None,
        replicas.churn[1] if replicas.churn is not None else None,
        *(["loss", static_loss[0]] if static_loss else []),
        *(["lseeds", lseed_arr] if lseed_arr is not None else []),
    )

    name = "batch.campaign_sharded.run_sharded_protocol_campaign"
    exch_totals = np.zeros(4, dtype=np.int64)
    batches = list(_iter_batches(replicas, batch_size, horizon, lseed_arr))
    t0 = time.perf_counter()
    for bi, batch in checkpointed_chunks(batches, checkpointer, stop_after_batches):
        lo, live, origins_b, gen_b, churn_b, seeds_b, lseeds_b = batch
        pad_o, pad_g = _pad_batch_schedule(origins_b, gen_b, chunk, horizon)
        churn = _pad_batch_churn(churn_b, batch_size, n_padded)
        runner.set_replicas(_local(seeds_b, q, rb),
                            None if churn is None else tuple(_local(c, q, rb) for c in churn),
                            _local(lseeds_b, q, rb))
        with span("dispatch", kernel=f"parallel.protocols_sharded.{protocol}_runner[campaign]",
                  batch=bi):
            out = runner.run_pass(_local(pad_o, q, rb), _local(pad_g, q, rb), horizon,
                                  record_coverage)
        with span("d2h", batch=bi):
            received[lo:lo + live] = out["counters"][:live, 0]
            sent[lo:lo + live] = out["counters"][:live, 1]
            if record_coverage:
                coverage[lo:lo + live] = out["coverage"][:live, :, :s]
        exch_totals += out["exchange_per"][:live].sum(axis=0)
        if mesh.is_first:
            head = None
            if tel:
                head = _emit(name, out["rings"], 0, lo, live, replicas.seeds, True)
            tel_progress.emit_progress(name, chunk=bi, chunks_total=len(batches),
                                       digest_head=head)
    wall = time.perf_counter() - t0

    if plan.delta:
        used, ovf, fallbacks, ticks = (int(v) for v in exch_totals)
        exchange_extra = _achieved_exchange_report(
            exchange_extra, (used, ovf, fallbacks), ticks, node_shards, plan.n_loc, plan.w,
            plan.capacity, hub_count=plan.hub_count)
    extra = {
        "ring": ring_extra,
        "mesh": {"replica_shards": replica_shards, "node_shards": node_shards,
                 "local_replicas": rb},
        "exchange": exchange_extra,
        "resident_bytes": runner.resident_bytes(horizon, record_coverage),
    }
    return CampaignResult(
        n=graph.n, seeds=replicas.seeds, generated=_campaign_generated(replicas, horizon),
        received=received[:, :graph.n], sent=sent[:, :graph.n],
        degree=graph.degree.astype(np.int64), horizon=horizon, wall_s=wall,
        batch_size=batch_size, coverage=coverage, extra=extra,
    )
