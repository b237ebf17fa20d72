#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``p2p_gossip_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU (an H100):

    python3 chip_smoke.py

(``python3 chip_smoke.py --north-star CACHE`` runs only phase 12's
million-node steps on the north-star graph cached by ``python -m
p2p_gossip_tpu_torch.scale --cache CACHE``; ``python3 chip_smoke.py
--phase 16`` runs phase 16 alone, with phase 11's campaigns as its
references; ``python3 chip_smoke.py --phase 14a`` runs phases 14 (a) and
16 (a) alone, the exchange kernels' checks and timings; ``python3
chip_smoke.py --phase 17`` runs phase 17 alone, the server on a mesh and
``scale.py --mesh``; ``python3 chip_smoke.py --phase 18`` runs phase 18
alone, the divergence bisector and the protocol comparison; ``python3
chip_smoke.py --phase 19`` runs the port's benchmark entry point whole,
``python -m p2p_gossip_tpu_torch.bench``, in a subprocess; ``python3
chip_smoke.py --phase 20`` runs phase 20 alone, the static-analysis gate on
the card; ``python3 chip_smoke.py --phase 21`` runs phase 21 alone, the
tick update kernel's checks and timings; ``python3 chip_smoke.py --phase
22`` runs phase 22 alone, the gather masked by seen; ``python3 chip_smoke.py
--phase 3n`` runs phase 3's ``scatter_or`` checks (ragged shapes, narrow rows) alone.)

Phases (any failure raises and the script exits nonzero):

1. Print the card's name and power limit (``nvidia-smi``); no CUDA -> exit 1.
2. Build the CUDA kernels from ``p2p_gossip_tpu_torch/csrc`` (``nvcc``).
3. Hold each kernel against its plain torch version on the card at the
   main path's shapes (bitwise: every op is integer), and time both with
   CUDA events beside the least time the bytes allow at 3.35 TB/s:
   gather_or and sector_occupancy on random (dense) rings and on rings
   captured from the engine's own tick at tick 10 of the main-path flood
   (uniform delay, and lognormal per-edge delays with D = 6), with the
   captured ring's measured sector occupancy; coverage_per_slot on dense
   words and on the coverage run's tick-2 frontier; and every kernel on
   ragged shapes.
   gather_or also with the engine's options: the link-loss coin and a
   destination up mask, on ragged shapes and on the captured rings.
4. Run the engine twice on small graphs, with the kernels and with the
   plain versions, and require equal counters and executed ticks, also
   with churn, loss, the connect window and snapshots on, and a run
   stopped after one chunk and resumed from its checkpoint; run the CLI
   on the card and on the CPU (the plain versions) and require the same
   report, at the reference defaults and with the option flags.
5. The main path at full size: ``bench.py``'s flood configuration —
   100K-node Erdős–Rényi p=0.001, 8,192 shares over a 16-tick window,
   horizon 64, one 8,192-share chunk — one warm run, one timed run.
6. ``run_flood_coverage`` on the same graph with 4,096 origins.
7. The options path: phases 5 and 6 again under churn and link loss, with
   snapshot boundaries; kernel == plain.
8. Flood runs under ``torch.profiler``, without and with the options:
   device time by kernel and the device's busy share of the run's wall
   time.
9. The random-partner protocols at full size, on the phase-5 graph staged
   as its CSR (`PartnerGraph`): push-pull with log-normal per-edge delays (max 5 ticks,
   D = 6), pull with a uniform delay, fanout push (k = 2, uniform delay)
   and a push-pull coverage run with 4,096 origins; one warm and one timed
   run each, every run against its plain run (counters and coverage
   rows), and the push-pull run under ``torch.profiler``.
10. Telemetry (every phase above runs with it off): the ``tick_digest``
   kernel against its plain version on ragged shapes, on dense random
   words at 100,000 x 256 and on the phase-5 flood's own tick-10 state,
   timed beside its bound; the phase-5 flood + coverage and the phase-9
   push-pull (D = 6) with telemetry on, in turns with it off (off, on,
   on, off): equal counters, the rings reconcile with them, one digest
   launch per executed tick (round), and the last digest equals the plain
   digest of the final state; and small-graph runs of the flood and the
   three protocols under churn and loss whose ring and digest streams are
   equal on the kernel and the plain path. The telemetry-on flood and
   push-pull also run under ``torch.profiler``.
11. Monte-Carlo campaigns (``p2p_gossip_tpu_torch.batch``), R = 8 replicas
   stacked along the rows of one state: ``gather_or`` with its replica
   axis (B = 3 and 8, per-replica loss seeds, up mask) on ragged shapes
   against its plain version and against B solo calls, and on the ring
   the campaign tick built by tick 10 of campaign (b) and tick 2 of (a);
   ``coverage_per_slot`` with B = 8 on dense words and on (a)'s tick-2
   frontier, each timed beside its bound; small campaigns (ER 2,000, BA
   300; R = 5 in batches of 2; ± churn and loss; every campaign kind)
   equal on the kernel and the plain path; then at full width on the
   phase-5 graph (a) ``run_coverage_campaign`` with 4,096 origins a
   replica, (b) ``run_gossip_campaign`` with phase 5's schedule drawn
   from each replica's seed and per-replica loss at p = 0.05, (c)
   ``run_protocol_campaign`` push-pull on phase 9's D = 6 staging: one
   warm and one timed run each, replicas 0 and 7 equal to the solo runs
   with their seeds, ms/tick (ms/round) and node-updates/s beside the
   solo run's, peak device memory, and (a) and (c) under
   ``torch.profiler``.

12. A million nodes (``p2p_gossip_tpu_torch.runtime.native``, the graph
   caches, the resident-memory model): build the C++ library from
   ``native/gossip_native.cc``; for BA m = 3 and ER p = 1e-4 at N =
   1,000,000, build the graph with the port's C++ builder, save it to an
   npz cache under ``chiprun_out/`` and reload it (equal CSR), stage it
   (time, peak host RSS, degree buckets), flood 4,096 origins from t = 0
   (one warm, one timed run): full coverage, ttc99, ``gather_or`` launched
   once per degree bucket per tick, and peak device memory within 20% of
   ``engine.sync.flood_resident_hbm_bytes``; then the four flood kernels
   on the tick-3 state, each held against its plain version on the first
   50,000 rows (of every bucket, for the gather) and timed on the whole
   state beside its bound. Last, the CLI on the card: ``--graphBuilder
   native --graphFile`` (cold, then warm) against the CPU run, and
   ``--backend event|native`` at the reference defaults against the card
   run's counters.
13. The gossip server (``p2p_gossip_tpu_torch.serve``): (a) ``tick_digest``
   with its replica axis against its plain version and B solo calls on
   ragged shapes (B = 1, 3, 8), and timed at B = 8 x 100,000 rows, W = 128
   and 256, beside its bound; (b) ``serve.bench``'s mixed trace at full
   width (24 requests on ER N = 100,000 p = 0.001 and BA m = 3, flood,
   push-pull, pull, fanout push, a lossy and a churn flood; 4,096 shares,
   horizon 64, replica counts 1/2/4) drained through one server of 8
   slots: requests/s, p50/p99 turnaround, slot occupancy, ms a dispatch,
   every request bitwise equal to its solo campaign on the card, and one
   flood dispatch profiled (device-busy share); (c)
   telemetry's rings on for one flood and one push-pull dispatch:
   ``tick_digest`` once a tick (round) for all 8 replicas, and each
   replica's ring and digest events equal to its solo telemetry-on run's;
   (d) peak device memory of the trace's largest dispatch, and of the
   largest of the other kind (flood or protocol), within 20% of the
   admission model's dispatch bytes, and a request over an explicit
   budget rejected; (e) a reduced trace (N = 2,000) on the card equal to
   the same trace run with ``device="cpu"``.
14. The sharded flood (``p2p_gossip_tpu_torch.parallel``): (a)
   ``compress_deltas`` against its plain version on edge cases (all-zero
   and all-nonzero slices, capacity 1, a count at capacity and one past
   it, k = 1 and 32, a slice not a whole number of tiles, B = 3 with one
   replica over capacity), ``compress_deltas`` and ``scatter_deltas``
   against their plain versions
   on a 4-shard split of the phase-5 flood's tick-3 and tick-10 frontiers
   (W = 256; capacity from ``exchange.delta_capacity`` of the real cut, and
   a forced overflow at capacity 64) and of phase 12's 1M BA tick-2 state
   (W = 128; run from phase 12's hook), every shard's compress and every
   receiver's scatter, timed beside the bound and ``torch.nonzero`` x k /
   ``index_put_``; and a look-back stress case (shard 0 of the 1M BA
   split at the flood's first eight frontiers as B = 8, ~7,800 tiles a
   replica: equal to the plain version, and ten more calls each equal to
   the first); (b) ``run_sharded_sim`` and
   ``run_sharded_flood_coverage`` on ``torch.cuda.device_count()`` NCCL
   ranks (one rank: in this process) with the ring replicated and sharded
   and the dense, delta, hub and async (K = 2) exchanges on phase 5's
   flood and phase 6's coverage, then phase 12's 1M BA coverage on the
   sharded ring with delta: counters, ticks and coverage rows equal the
   single-device port's, ms/tick, launches, and each run's peak device
   memory within 20% of ``stats.extra['resident_bytes']``, and a
   replicated and a delta flood under ``torch.profiler``; (c) 2 and 4
   gloo ranks on the one card (gloo chosen, not a fallback): the dense and
   delta flood and coverage equal the single-device port's.
15. The sharded protocols (``parallel.protocols_sharded``): (a) the
   ``or_fold`` kernel (the fold of ``_reduce_scatter_or``) against its
   plain version on ragged shapes (k up to 8, W = 1, 3, 256, n_loc not a
   multiple of 4, slices off 16-byte alignment, the top bit set) and on a
   4-shard split of the phase-9 push-pull's pushes at rounds 10 and 40
   (each rank group's ``scatter_or`` into a global-width buffer, restacked
   per destination and folded: equal to the single-device round's pushed
   rows), timed beside its bound; (b) ``run_sharded_partnered_sim`` on
   ``torch.cuda.device_count()`` NCCL ranks (one rank: in this process) on
   phase 9's graph and schedule: push-pull (D = 6) on the replicated and
   sharded rings and with the delta, hub (64 hub rows a shard) and async
   (K = 2) exchanges, pull replicated and delta, fanout push (k = 2)
   replicated and sharded, push-pull coverage (4,096 origins) with delta:
   counters and coverage rows equal to phase 9's single-device runs (async
   to the run on the delays clamped to max(d, K)), ms/round (whole call,
   and past a one-round call's set-up) beside phase 9's, launches, each
   run's peak device memory within 20% of
   ``stats.extra['resident_bytes']``, and a push-pull run under
   ``torch.profiler``; (c) 2 and 4 gloo ranks on the one card at N =
   10,000: push-pull dense and delta and fanout push equal to the
   single-device port, every rank folding with the kernel once a round;
   (d) ``--protocol pushpull|pull|pushk --backend sharded`` on the card
   and on the CPU: the same report.
16. The sharded campaigns (``batch.campaign_sharded``): (a)
   ``compress_deltas`` and ``scatter_deltas`` with a replica axis (B = 8 in
   one launch) against their plain versions on ragged (B, n_loc, W, k,
   capacity) and on the 4-shard split of phase 11's eight replicas'
   tick-3 and tick-10 frontiers (W = 256), with one replica alone over a
   capacity of 64; timed beside the bound (B x the one-run bytes), B
   launches of the one-run kernel and the one-call torch counterparts;
   (b) ``run_sharded_campaign`` (coverage, phase 11 (a)'s 8 x 4,096
   origins) in every phase-14 mode and ``run_sharded_protocol_campaign``
   push-pull (phase 11 (c)'s set, D = 6) replicated and delta, on
   ``torch.cuda.device_count()`` NCCL ranks (one rank: a 1 x 1 mesh with
   rb = 8, in this process): every replica equal to phase 11's
   single-device campaign (counters and coverage rows), wall / (R x
   replica 0's solo sharded wall), launches, peaks within 20% of
   ``extra['resident_bytes']``, and a delta campaign under
   ``torch.profiler``; (c) gloo ranks on the one card at N = 10,000,
   (replicas x nodes) 2 x 2 and 1 x 4 on 4 ranks: dense and delta
   coverage campaigns and the push-pull campaign equal to the
   single-device campaigns; (d) ``run_coverage_campaign(mesh=)`` over the
   NCCL ranks equal to the call without a mesh.
17. The server on a mesh (``GossipServer(mesh=...)``): (a)
   ``make_slot_mesh(8)`` on ``torch.cuda.device_count()`` NCCL ranks (one
   rank: 1 x 1, in this process); (b) phase 13's trace at full width
   through the mesh server with the dense and with the delta exchange,
   every request bitwise phase 13's result, requests/s, p50/p99
   turnaround, occupancy and ms a dispatch beside phase 13's, a flood and
   a push-pull dispatch under ``torch.profiler``, the peak device memory
   of the largest flood and protocol dispatch (staging included) within
   20% of the mesh admission model's per-rank bytes, and a request over an
   explicit budget rejected; (c) two gloo ranks on the one card, the
   reduced trace (N = 2,000) on (replicas x nodes) 2 x 1, 1 x 2 and
   ``make_slot_mesh(4)``, every request equal to the single-device server's;
   (d) ``scale.py --mesh 1x1`` in-process on one NCCL rank on phase 12's 1M
   BA graph (through an npz cache): processed, full coverage, ttc99 and
   coverage rows equal to phase 12's flood, the rank's peak within 20% of
   ``resident_bytes``. ``python3 chip_smoke.py --phase 17`` runs it alone,
   building phase 13's and phase 12's references itself.
18. The research tools (``p2p_gossip_tpu_torch.divergence``,
   ``.protocol_compare``): (a) the divergence bisector at its defaults
   (ER N = 96): its 8 pairs on the card, the five sharded ones on one
   world of 4 gloo ranks on the card, every pair clean and both of its
   streams equal, digest for digest, to the same pair run on the CPU in
   this call (the world's CPU job and this process's), a fault injected
   at tick 4 located on every pair, the tick-7 reports equal to the CPU's,
   and the bisector's CLI on the card (its host-side pairs); (b) every
   pair clean at full width, each pair's wall printed: ``sync-campaign``
   on ``bench.py``'s graph (ER N = 100,000, p = 0.001) with 4,096 shares,
   ``pushpull-campaign`` there with 128 shares (its campaign's pass: a
   wider one splits the campaign's stream), horizon 64; the sharded pairs
   on the same world at N = 10,000 (256 shares, horizon 32); native-sync
   at N = 2,000 (64 shares: the event engine is host Python); (c) the
   protocol comparison's rows at its defaults (N = 2,000) equal on the
   card and the CPU apart from ``wall_s``, and its table at
   docs/RESULTS.md's on-chip configuration (ER N = 100,000, p = 0.001, 64
   shares, horizon 96, fanout 3) with the card's walls.
   ``python3 chip_smoke.py --phase 18`` runs it alone.
19. The benchmark entry point (``p2p_gossip_tpu_torch.bench``): its
   headline, baseline and flood-campaign legs in this process on phase
   5's graph, schedule and staging, with 3 timed runs, each run's
   per-node counters and executed ticks equal to phase 5's timed run;
   the row's keys the documented set, ``ticks`` phase 5's, the median,
   runs and spread printed with the card's name and power limit.
   ``python3 chip_smoke.py --phase 19`` runs ``python -m
   p2p_gossip_tpu_torch.bench`` whole in a subprocess (every leg: the
   serve leg's subprocess and the world of 8 gloo ranks included) and
   requires ``processed`` = 819,200,000, ``ticks`` equal to the flood's on
   phase 5's graph (run here), every sharded-campaign replica bitwise,
   the serve leg bitwise and every exchange family ok.
20. The port's static-analysis gate on the card
   (``p2p_gossip_tpu_torch.staticcheck``): the op audit of every
   registered entry (the single-device ones in this process, the sharded
   ones on one NCCL rank) on CUDA tensors, under the dispatch recorder and
   ``torch.cuda.set_sync_debug_mode("warn")`` (restored after), beside the
   same audit on the CPU (the sharded entries' on a spawned world of one
   gloo rank); the telemetry-off check; the build half of the staging
   sentinel. It fails on any rule's violation, on an entry whose host
   reads a tick on the card differ from the CPU audit's, on a sync CUDA
   flags beyond an entry's budget (the CPU audit's host reads and host
   stagings), on an entry whose launched kernels are not the plain twins
   its CPU audit called, and on a kernel no entry launched. Its
   ``staticcheck`` line gives each entry's host reads a tick, the syncs
   CUDA flagged and its launches by kernel.
21. The tick update (``tick_update``): the kernel against its plain torch
   passes, bitwise in every output and in-place update, on ragged shapes
   (W = 1, 3, 4, 33; generations in the frontier and, as before the
   connect tick, out of it) and at burst32k's (100,000 x 1,024, 32,768
   events) and coverage4k's (10^6 x 128, 4,096 events) shapes with dense
   and sparse arrivals; timed there from the same state each run, beside
   its least bytes at 3.35 TB/s, its plain passes and the engine's update
   before it.
22. The gather masked by the destinations' seen-sets (``gather_or`` with
   ``seen``) on the engine's own state at burst32k's shape (the
   benchmark's ER 100K graph, 32,768 shares over 16 ticks, W = 1,024) at
   dense ticks of the burst, and at coverage4k's (its 1M BA graph, 4,096
   origins on tick 0, W = 128) across the flood: bitwise against the
   unmasked kernel & ~seen at every tick and against the plain version at
   the first two; the masked and unmasked kernels timed in turns.

Phase 3 also holds the ``scatter_or`` kernel (the destination-owned OR
over a destination-sorted plan) against its plain version on ragged
shapes (with a base, in place, the and-not frontier and pulled rows) and
at the protocols' own shapes (M = N for push-pull, M = 2N for fanout 2,
W = 256) over rings captured at rounds 10 and 40 of the phase-9 push-pull
run, and on the push-pull round's own call (pulled rows + pushes over
``seen``); it times the plan alone. Then the push-pull cells' own round
calls, each on the cell's graph from gossipbench's generator: campaign8's
(8 replicas x 100,000 rows at W = 4, one lane a row) and the 1M cell's
round at W = 4 (one lane a row, hub runs of more than 500 entries taken by
the whole warp) and at W = 128 (a warp a row), each bitwise against its
plain version, its launch counted under those lanes, and timed beside its
bound. Phase 4 also runs the protocols (push-pull, pull, fanout push)
with the kernels and with the plain versions on small graphs, with churn
and loss, with coverage rows, and stopped after a chunk and
resumed from a checkpoint; and the CLI's protocol, topology and
generation flags on the card and on the CPU.

Kernel launch counts are zeroed just before the timed run of phase 5 and
read after phase 6 (they must equal the option-free tick's), zeroed
again just before the timed run of phase 7 and read after its coverage
run, and zeroed again just before phase 9's timed runs and read after
them: there ``gather_or`` must not launch and ``scatter_or`` must launch
once a round. ``tick_digest`` must launch in none of those telemetry-off
runs. Phase 10 zeroes the counts just before its telemetry-on flood and
reads them after its coverage run (``tick_digest`` once per executed
tick, the coverage run's ticks counted by its ``coverage_per_slot``
launches), and again around its telemetry-on push-pull run (``tick_digest``
once a round, ``scatter_or`` twice: the round call and the row's
``msgs_gathered``). Phase 11 zeroes the counts just before each timed
campaign and reads them after it: a campaign tick launches ``gather_or``
once per degree bucket and ``coverage_per_slot`` once for all eight
replicas, a campaign round ``scatter_or`` once, ``tick_digest`` never.
Phase 12 zeroes them just before each million-node timed run and reads
them after it: each flood kernel launched, ``gather_or`` once per degree
bucket per tick. Phase 13 zeroes them just before the trace's drain and
reads them just after it (``launches_serve``: every flood and protocol
kernel launched, ``tick_digest`` never), and around each rings-on
dispatch (``tick_digest`` once a tick or round for the 8 replicas).
Phase 14 (b) zeroes them just before each mode's timed flood and reads
them after its coverage run: every flood kernel launched, the exchange
kernels once a tick exactly when the exchange is delta or hub (their
record's ``launches`` is the delta run's), and around the 1M BA run.
Phase 15 (b) zeroes them just before each run's timed call and reads them
after it (``launches_sharded_protocols_<run>``): ``or_fold`` once a round
on push-pull and fanout push, never on pull (its record's ``launches`` is
the replicated push-pull's), the exchange kernels exactly on delta and
hub; every other path's counts carry ``or_fold: 0``.
Phase 16 (b) zeroes them just before each timed campaign and reads them
after it (``launches_sharded_campaign_<mode>``): ``gather_or`` once per
degree bucket a tick for the local batch, ``coverage_per_slot`` and
``tick_update`` once a tick, the exchange kernels once a tick exactly on
delta and hub; ``or_fold`` and ``scatter_or`` once a round on push-pull.
Phase 17 (b) zeroes them just before each drain and reads them just after
it (``launches_serve_mesh_<exchange>``; by kind of dispatch in its record
line): ``gather_or``, ``coverage_per_slot``, ``popcount_rows``,
``tick_update``, ``scatter_or`` and ``or_fold`` launched, the exchange
kernels on delta.
Phase 18 zeroes them just before each card run and each world job and
reads them after it: on the card ``gather_or``, ``coverage_per_slot``,
``scatter_or`` and ``tick_digest`` launched by (a)'s host-side pairs,
``gather_or``, ``tick_digest``, ``compress_deltas`` and
``scatter_deltas`` on every rank of the world's card jobs, each (b) pair's
kernels and (c)'s flood and protocol kernels; on the CPU (the world's CPU
job, the CPU halves of (a) and (c)) none.
Phase 19 zeroes them just before the bench's legs and reads them after
them (``launches_bench``): ``gather_or``, ``sector_occupancy``,
``tick_update`` and ``coverage_per_slot`` launched.
Phase 20 reads each audited entry's launches as the change of the counts
over its call (``launches_staticcheck``: the sum over the entries): every
kernel launched by some entry.
The second-to-last line is the kernels' JSON record; the last line
is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
N_NODES, EDGE_P, SEED = 100_000, 0.001, 0
N_SHARES, GEN_WINDOW, HORIZON, CHUNK = 8192, 16, 64, 8192
COVERAGE_ORIGINS = 4096
CAPTURE_TICK = 10  # a mid-flood tick: shares of generation ticks 6-9 spreading
SNAPSHOTS = [8, 16, 24, 32]  # the options run's periodic-stats boundaries
# The loss-free main path's launches (flood + coverage), as before the
# options existed: with every option off the tick launches what it did.
# The flood never scatters.
LOSS_FREE_LAUNCHES = {
    "gather_or": 87, "sector_occupancy": 29, "popcount_rows": 0, "coverage_per_slot": 7,
    "scatter_or": 0, "tick_digest": 0,
    "compress_deltas": 0, "scatter_deltas": 0, "or_fold": 0, "tick_update": 29,
}
FLOOD_KERNELS = tuple(name for name, count in LOSS_FREE_LAUNCHES.items() if count)
SOURCE = "p2p_gossip_tpu_torch/csrc/gossip_kernels.cu"
REPLACES = {
    "gather_or": "p2p_gossip_tpu/ops/ell.py:157",
    # No TPU counterpart: the gather's companion pass, filed under the XLA
    # gather-OR it serves.
    "sector_occupancy": "p2p_gossip_tpu/ops/ell.py:157",
    "popcount_rows": "p2p_gossip_tpu/ops/pallas_kernels.py:152",
    # No TPU kernel: the tick update XLA fused (engine/sync.py apply_tick_updates).
    "tick_update": "p2p_gossip_tpu/engine/sync.py:339",
    "coverage_per_slot": "p2p_gossip_tpu/ops/pallas_kernels.py:122",
    "scatter_or": "p2p_gossip_tpu/ops/segment.py:41",
    "tick_digest": "p2p_gossip_tpu/telemetry/digest.py:118",
    "compress_deltas": "p2p_gossip_tpu/parallel/exchange.py:399",
    "scatter_deltas": "p2p_gossip_tpu/parallel/exchange.py:469",
    "or_fold": "p2p_gossip_tpu/parallel/protocols_sharded.py:104",
}
# The kernels the protocols' path runs: it keeps no occupancy ring, and its
# pull rides in the round's one scatter_or call (no gather).
PROTOCOL_KERNELS = ("popcount_rows", "coverage_per_slot", "scatter_or")
PROTOCOL_CAPTURE_ROUND = 10
PROTOCOL_DENSE_ROUND = 40  # push-pull near saturation: dense rows
# The kernel only the telemetry-on path (phase 10) runs.
TELEMETRY_KERNELS = ("tick_digest",)
# Phase 11: replicas a campaign batch, and campaign (b)'s per-replica loss.
CAMPAIGN_REPLICAS = 8
CAMPAIGN_LOSS = 0.05
# Phase 12: a million nodes. BA m = 3 is BASELINE.json config 4 in full; ER
# p = 1e-4 is the north star's graph (p = 0.001) cut to a tenth of its
# edges, so its native build fits this script's time.
SCALE_BA_M = 3
SCALE_CONFIGS = (("ba", 1_000_000, 0.0), ("er", 1_000_000, 1e-4))
SCALE_ORIGINS = 4096
SCALE_CAPTURE_TICK = 3
SCALE_SUBSET_ROWS = 50_000  # rows the plain versions check at a million nodes
MEMORY_TOLERANCE = 0.20  # measured peak device memory against the model
# Phase 13: the gossip server. The trace at full width (``serve.bench``'s,
# 4,096 shares, horizon 64) in dispatches of 8 slots; the batched digest's
# replicas; the reduced trace held between the card and the CPU.
SERVE_SLOTS = 8
SERVE_REQUESTS = 24
SERVE_SHARES = 4096
SERVE_REDUCED_NODES = 2000
DIGEST_REPLICAS = 8
# Phase 14: the sharded flood. The exchange kernels on a 4-shard split at
# the flood's tick-3 and tick-10 frontiers, and with a capacity forced to
# overflow; the engine's modes on the card's NCCL ranks; gloo ranks on the
# one card.
SHARD_SPLIT = 4
DELTA_TICKS = (3, 10)
OVERFLOW_CAPACITY = 64
PINNED_HUB_ROWS = 64  # hub rows a shard: overlay_hub's timing (14 (a)), 15 (b)'s hub run
SHARDED_MODES = (
    ("replicated", dict(ring_mode="replicated")), ("sharded", dict(ring_mode="sharded")),
    ("delta", dict(exchange="delta")), ("hub", dict(exchange="hub")),
    ("async", dict(exchange="async", async_k=2)),
)
SHARDED_KERNELS = ("compress_deltas", "scatter_deltas")
GLOO_RANKS = (2, 4)
GLOO_DEVICE = "cuda:0"  # every gloo rank on the one card
# Phase 15: the sharded protocols. or_fold on ragged shapes (k x W x
# n_loc) and on a SHARD_SPLIT-way split of the phase-9 push-pull's pushes;
# the runs on the card's NCCL ranks, each (label, protocol, phase 9's
# log-normal delays or the uniform delay, coverage rows, options); gloo
# ranks on the one card at a reduced size; the CLI.
OR_FOLD_RAGGED = ((1, 1, 1001), (2, 3, 37), (3, 256, 5), (4, 3, 1000), (8, 1, 13),
                  (8, 256, 3), (3, 1, 4096))
SHARDED_PROTOCOL_RUNS = (
    ("pushpull-replicated", "pushpull", True, False, dict(ring_mode="replicated")),
    ("pushpull-sharded", "pushpull", True, False, dict(ring_mode="sharded")),
    ("pushpull-delta", "pushpull", True, False, dict(exchange="delta")),
    ("pushpull-hub", "pushpull", True, False,
     dict(exchange="hub", hub_rows=PINNED_HUB_ROWS)),
    ("pushpull-async", "pushpull", True, False, dict(exchange="async", async_k=2)),
    ("pull-replicated", "pull", False, False, dict(ring_mode="replicated")),
    ("pull-delta", "pull", False, False, dict(exchange="delta")),
    ("pushk-replicated", "pushk", False, False, dict(ring_mode="replicated")),
    ("pushk-sharded", "pushk", False, False, dict(ring_mode="sharded")),
    ("coverage-delta", "pushpull", True, True, dict(exchange="delta")),
)
PROTOCOL_GLOO_NODES, PROTOCOL_GLOO_SHARES, PROTOCOL_GLOO_HORIZON = 10_000, 1024, 32
# Phase 16: the sharded campaigns. The exchange kernels with B = 8 on the
# 4-shard split of phase 11's replicas (replica ALONE the only one over the
# overflow capacity) and on ragged (B, n_loc, W, k, capacity); the
# campaigns on the card's NCCL ranks; gloo ranks on the one card.
ALONE = 5
EXCHANGE_RAGGED = ((1, 1001, 5, 3, 100), (3, 37, 256, 4, 64), (8, 5000, 1, 1, 7),
                   (5, 333, 13, 32, 50), (2, 64, 300, 2, 1))
CAMPAIGN_PROTOCOL_MODES = (("pushpull-replicated", dict(ring_mode="replicated")),
                           ("pushpull-delta", dict(exchange="delta")))
GLOO_CAMPAIGN_NODES, GLOO_CAMPAIGN_REPLICAS = 10_000, 4
GLOO_CAMPAIGN_SHARES, GLOO_CAMPAIGN_HORIZON = 256, 32
GLOO_CAMPAIGN_MESHES = ((2, 2), (1, 4))  # (replicas, nodes) on 4 ranks
U32 = 0xFFFFFFFF


def log(msg: str) -> None:
    print(msg, flush=True)


# Back-to-back calls per timed run of a kernel: the device's work then
# covers the host's launch overhead (Python checks, ctypes, allocation),
# which a single bracketed call would add to a kernel of tens of µs.
KERNEL_CALLS = 10


def time_ms(fn, reps: int, warmup: int = 2, calls: int = 1) -> float:
    """Median milliseconds of one call of ``fn`` over ``reps`` runs of
    ``calls`` back-to-back calls, each run bracketed by CUDA events on the
    current stream."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return float(np.median(times))


def bound_ms(nbytes: int) -> float:
    return nbytes / PEAK_BYTES_PER_S * 1e3


def random_words(rng, shape, dev):
    """uint32 words with every bit in play, as the int32 bit pattern."""
    import torch

    n = int(np.prod(shape))
    words = np.frombuffer(rng.bytes(4 * n), dtype=np.int32).reshape(shape)
    return torch.as_tensor(words.copy(), device=dev)


def sparse_words(rng, shape, dev, p_sector=0.4):
    """Random words in whole 8-word sectors kept with probability
    ``p_sector``, the rest zero — a frontier's banded look."""
    import torch

    *lead, w = shape
    keep = rng.random((*lead, -(-w // 8))) < p_sector
    sector_mask = torch.as_tensor(np.repeat(keep, 8, axis=-1)[..., :w], device=dev)
    return torch.where(sector_mask, random_words(rng, shape, dev), 0)


def ring_occupancy(hist, *, plain=False):
    """sector_occupancy of every slot of a (D, N, W) ring, as the engine
    keeps it: (D, N) int32."""
    import torch

    from p2p_gossip_tpu_torch.ops import kernels

    return torch.stack([kernels.sector_occupancy(h, plain=plain) for h in hist])


def set_bits(x) -> int:
    from p2p_gossip_tpu_torch.ops import kernels

    return int(kernels.popcount_rows_plain(x.reshape(-1, 1)).sum())


def compare(name, got, want) -> int:
    """Bitwise comparison; returns the max absolute difference (0)."""
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
    if err:
        raise AssertionError(f"{name}: kernel differs from its plain version by {err}")
    return err


# --- phase 3 ----------------------------------------------------------------

def check_gather_ragged(dev, rng):
    """gather_or on awkward shapes, each with no occupancy, the exact one
    and an over-approximate one (bits over zero sectors and past the last
    sector): W of 1, 3 and 5 (4-byte loads), 300 (sectors widened to 16
    words), 520 and 1027 (32- and 64-word sectors), caps of 129 and 300
    (more than one staging round of 128 entries), an all-zero ring,
    per-edge and uniform slots, destination rows in shuffled order with
    some outside [0, N) (dropped), and a zero-width ELL. ``out`` starts
    as all ones, so a row the kernel should zero and does not shows."""
    import torch

    from p2p_gossip_tpu_torch.ops import kernels

    cases = (  # n, cap, w, ring, per_edge, fill
        (1237, 7, 3, 4, True, "sparse"), (513, 5, 1, 2, False, "dense"),
        (300, 9, 300, 6, True, "sparse"), (400, 11, 5, 3, False, "sparse"),
        (256, 300, 16, 3, True, "sparse"), (129, 129, 8, 2, False, "sparse"),
        (777, 6, 520, 2, False, "sparse"), (150, 4, 1027, 2, True, "sparse"),
        (500, 12, 64, 3, True, "zero"), (64, 0, 2, 2, False, "sparse"),
    )
    for n, cap, w, ring, per_edge, fill in cases:
        if fill == "zero":
            hist = torch.zeros((ring, n, w), dtype=torch.int32, device=dev)
        elif fill == "dense":
            hist = random_words(rng, (ring, n, w), dev)
        else:
            hist = sparse_words(rng, (ring, n, w), dev)
        idx = torch.as_tensor(rng.integers(0, n, (n, cap)).astype(np.int32), device=dev)
        mask = torch.as_tensor(rng.random((n, cap)) < 0.7, device=dev)
        delay = (torch.as_tensor(rng.integers(1, ring, (n, cap)).astype(np.int32),
                                 device=dev) if per_edge else None)
        rows = rng.permutation(n + 6)[:n].astype(np.int32) - 3
        rows = torch.as_tensor(rows, device=dev)
        slot = None if per_edge else 1
        exact = ring_occupancy(hist)
        compare(f"sector_occupancy[ring n={n} w={w}]", exact, ring_occupancy(hist, plain=True))
        over = exact | random_words(rng, exact.shape, dev)

        def run(occ, plain):
            out = torch.full((n, w), -1, dtype=torch.int32, device=dev)
            return kernels.gather_or(hist, 5, idx, mask, delay, uniform_slot=slot,
                                     rows=rows, occ=occ, out=out, plain=plain)

        want = run(None, True)
        for occ_name, occ in (("none", None), ("exact", exact), ("over", over)):
            got = run(occ, False)
            label = f"gather_or[n={n} cap={cap} w={w} D={ring} {fill} occ={occ_name}]"
            compare(label, got, run(occ, True))
            compare(label + " vs no occupancy", got, want)
    log("gather_or ragged shapes (W 1/3/5/300/520/1027, caps 0/129/300, zero "
        "ring, per-edge, out-of-range rows; occupancy none/exact/over): bitwise equal")


def check_gather_options_ragged(dev, rng):
    """gather_or with the loss coin and the destination up mask against
    its plain version: p = 0 (equal to no loss), p = 0.05, p = 0.6 (a
    threshold past 2^31: the unsigned compare) and p = 1.0 (every row
    zero), a seed past 2^31, each without and with an up mask (a fifth of
    the nodes down), through identity rows and through shuffled bucket
    rows with some outside [0, N). ``out`` starts as all ones, so a down
    row the kernel should zero and does not shows."""
    import torch

    from p2p_gossip_tpu_torch.models.linkloss import LinkLossModel
    from p2p_gossip_tpu_torch.ops import kernels

    cases = (  # n, cap, w, ring, per_edge
        (1237, 7, 3, 4, True), (513, 9, 64, 2, False), (300, 9, 300, 6, True),
        (129, 129, 8, 2, False), (400, 11, 5, 3, True),
    )
    probs = (0.0, 0.05, 0.6, 1.0)
    for n, cap, w, ring, per_edge in cases:
        hist = sparse_words(rng, (ring, n, w), dev)
        occ = ring_occupancy(hist)
        idx = torch.as_tensor(rng.integers(0, n, (n, cap)).astype(np.int32), device=dev)
        mask = torch.as_tensor(rng.random((n, cap)) < 0.7, device=dev)
        delay = (torch.as_tensor(rng.integers(1, ring, (n, cap)).astype(np.int32),
                                 device=dev) if per_edge else None)
        slot = None if per_edge else 1
        up = torch.as_tensor(rng.random(n) >= 0.2, device=dev)
        shuffled = torch.as_tensor(rng.permutation(n + 6)[:n].astype(np.int32) - 3,
                                   device=dev)
        for rows in (None, shuffled):
            def run(loss, up_arg, plain, rows=rows):
                out = torch.full((n, w), -1, dtype=torch.int32, device=dev)
                return kernels.gather_or(hist, 7, idx, mask, delay, uniform_slot=slot,
                                         rows=rows, occ=occ, loss=loss, up=up_arg,
                                         out=out, plain=plain)

            lossless = run(None, None, False)
            for prob in probs:
                loss = LinkLossModel(prob, seed=2**31 + 17).static_cfg
                for up_arg in (None, up):
                    label = (f"gather_or[n={n} cap={cap} w={w} D={ring} p={prob} "
                             f"up={up_arg is not None} rows={rows is not None}]")
                    got = run(loss, up_arg, False)
                    compare(label, got, run(loss, up_arg, True))
                    if prob == 0.0 and up_arg is None:
                        compare(label + " vs no loss", got, lossless)
                    if prob == 1.0 and rows is None and got.any():
                        raise AssertionError(f"{label}: p = 1.0 left a nonzero row")
    log("gather_or with loss coin and up mask, ragged shapes (p 0/0.05/0.6/1.0, seed "
        "> 2^31, up none/80%, identity and shuffled rows, garbage out): bitwise equal")


def check_occupancy_ragged(dev, rng):
    """sector_occupancy on W of 1, 3, 5, 128, 256, 300, 512 and 1027, an
    all-ones row, a zero row and a bit-31-only row, and on column slices
    (row stride > W; an unaligned base)."""
    from p2p_gossip_tpu_torch.ops import kernels

    for shape in ((1237, 1), (1000, 3), (999, 5), (513, 128), (4097, 256),
                  (300, 300), (77, 512), (50, 1027)):
        words = sparse_words(rng, shape, dev)
        words[0] = -1
        words[1] = 0
        words[2] = 0
        words[2, -1] = -(2**31)
        compare(f"sector_occupancy{shape}", kernels.sector_occupancy(words),
                kernels.sector_occupancy_plain(words))
    for wide, cols in (((1000, 13), slice(2, 11)), ((1000, 260), slice(4, 260))):
        words = sparse_words(rng, wide, dev)[:, cols]
        compare(f"sector_occupancy[slice {wide}]", kernels.sector_occupancy(words),
                kernels.sector_occupancy_plain(words))
    log("sector_occupancy ragged shapes (W 1..1027, slices): bitwise equal")


def check_gather(dg, dg_edge, n, w, dev, rng, reps):
    """gather_or at the main path's buckets (uniform delay 1, W words) and
    with per-edge delays (ring D from the staged delays), on random words
    (every sector occupied) with the ring's occupancy, as the engine calls
    it. The bound counts each distinct source row (W words and its
    occupancy word) once, the staged ELL and bucket rows, and the output."""
    import torch

    from p2p_gossip_tpu_torch.ops.ell import propagate_bucketed

    rows_bytes = 4 * n
    results = {}
    for label, g in (("uniform", dg), ("per_edge", dg_edge)):
        hist = random_words(rng, (g.ring_size, n, w), dev)
        tick = 2 * g.ring_size + 1

        occ = ring_occupancy(hist)

        def run(plain, g=g, hist=hist, tick=tick, occ=occ):
            return propagate_bucketed(
                hist, tick, g.buckets, n_out=n, ring_size=g.ring_size,
                uniform_delay=g.uniform_delay, occ=occ, plain=plain,
            )

        err = compare(f"gather_or[{label}]", run(False), run(True))
        staged = sum(int(b[1].numel()) for b in g.buckets)
        if g.uniform_delay is not None:
            src_rows = n  # one slot; every node has a neighbor
            per_entry = 5
        else:
            keys = []
            for rows, idx, mask, delay in g.buckets:
                slot = torch.remainder(tick - delay.long(), g.ring_size)
                keys.append((slot * n + idx.long())[mask])
            src_rows = int(torch.unique(torch.cat(keys)).numel())
            per_entry = 9
        nbytes = src_rows * (w + 1) * 4 + staged * per_entry + rows_bytes + n * w * 4
        ms = time_ms(lambda: run(False), reps, calls=KERNEL_CALLS)
        plain_ms = time_ms(lambda: run(True), max(2, reps // 4), warmup=1)
        results[label] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms(nbytes),
        )
        log(
            f"gather_or[{label}] N={n} W={w} D={g.ring_size} buckets="
            f"{len(g.buckets)} entries={staged}: bitwise equal; one tick (all "
            f"buckets): kernel {ms:.3f} ms, "
            f"plain {plain_ms:.3f} ms, bound {bound_ms(nbytes):.4f} ms "
            f"({nbytes / 1e6:.1f} MB)"
        )
        del hist, occ
    return results


def check_occupancy(n, w, dev, rng, reps):
    """sector_occupancy on one random (N, W) slot (every sector occupied)."""
    from p2p_gossip_tpu_torch.ops import kernels

    words = random_words(rng, (n, w), dev)
    err = compare("sector_occupancy", kernels.sector_occupancy(words),
                  kernels.sector_occupancy_plain(words))
    ms = time_ms(lambda: kernels.sector_occupancy(words), reps, calls=KERNEL_CALLS)
    plain_ms = time_ms(lambda: kernels.sector_occupancy_plain(words), reps)
    nbytes = n * w * 4 + n * 4
    log(f"sector_occupancy ({n}, {w}) random: bitwise equal; kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, bound {bound_ms(nbytes):.4f} ms")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms(nbytes))


def capture_state(dg, sched, chunk, ticks, dev, frontiers=None):
    """Run the engine's own tick on one chunk of ``sched`` for ``ticks``
    ticks from t = 0 and return its state: seen, the frontier ring, the
    occupancy ring, received, sent and the last tick's new frontier. A
    ``frontiers`` list gets a copy of every tick's new frontier."""
    import torch

    from p2p_gossip_tpu_torch.engine.sync import _chunk_state, _tick

    origins, gen_ticks = sched.padded(chunk, HORIZON)
    origins = torch.as_tensor(origins.astype(np.int64), device=dev)
    gen_ticks = torch.as_tensor(gen_ticks, device=dev)
    slots = torch.arange(chunk, dtype=torch.int64, device=dev)
    seen, hist, occ, received, sent = _chunk_state(dg, chunk // 32)
    newly = None
    for t in range(ticks):
        newly, _ = _tick(dg, t, seen, hist, occ, received, sent, origins, slots,
                         gen_ticks, False)
        if frontiers is not None:
            frontiers.append(newly.clone())
    return seen, hist, occ, received, sent, newly


def capture_ring(dg, sched, chunk, ticks, dev):
    """`capture_state`'s frontier ring, occupancy ring and the last tick's
    new frontier."""
    _, hist, occ, _, _, newly = capture_state(dg, sched, chunk, ticks, dev)
    return hist, occ, newly


def check_captured(dg, dg_edge, sched, n, dev, reps):
    """gather_or and sector_occupancy on the rings the engine itself built
    by tick CAPTURE_TICK of the main-path flood, uniform and per-edge.
    Prints the sector occupancy the gather meets: the share of (valid
    edge, sector) pairs it reads. The bound counts what this ring needs:
    the occupied sectors of each distinct source row once, its occupancy
    word, the staged ELL and bucket rows, and the output."""
    import torch

    from p2p_gossip_tpu_torch.ops import kernels
    from p2p_gossip_tpu_torch.ops.ell import propagate_bucketed

    w = CHUNK // 32
    sw = kernels.sector_words(w)
    nsec = -(-w // sw)
    tick = CAPTURE_TICK
    results = {}
    for label, g in (("uniform", dg), ("per_edge", dg_edge)):
        hist, occ, _ = capture_ring(g, sched, CHUNK, tick, dev)

        def run(plain, occ_arg, g=g, hist=hist):
            return propagate_bucketed(
                hist, tick, g.buckets, n_out=n, ring_size=g.ring_size,
                uniform_delay=g.uniform_delay, occ=occ_arg, plain=plain,
            )

        got = run(False, occ)
        err = compare(f"gather_or[captured {label}]", got, run(True, occ))
        compare(f"gather_or[captured {label}] vs no occupancy", got, run(False, None))
        keys, edge_sectors, edges, staged, rows_bytes = [], 0, 0, 0, 0
        for rows, idx, mask, delay in g.buckets:
            if g.uniform_delay is not None:
                slot = torch.full_like(idx, (tick - g.uniform_delay) % g.ring_size,
                                       dtype=torch.int64)
            else:
                slot = torch.remainder(tick - delay.long(), g.ring_size)
            key = (slot * n + idx.long())[mask]
            keys.append(key)
            edge_sectors += set_bits(occ.reshape(-1)[key])
            edges += int(key.numel())
            staged += int(idx.numel())
            rows_bytes += 4 * int(rows.numel())
        distinct = torch.unique(torch.cat(keys))
        sectors_needed = set_bits(occ.reshape(-1)[distinct])
        per_entry = 5 if g.uniform_delay is not None else 9
        nbytes = (sectors_needed * sw * 4 + distinct.numel() * 4 + staged * per_entry
                  + rows_bytes + n * w * 4)
        share = edge_sectors / (edges * nsec)
        ms = time_ms(lambda: run(False, occ), reps, calls=KERNEL_CALLS)
        ms_full = time_ms(lambda: run(False, None), reps, calls=KERNEL_CALLS)
        plain_ms = time_ms(lambda: run(True, occ), max(2, reps // 4), warmup=1)
        # The occupancy pass on the slot this tick's own _tick call writes.
        slot_words = hist[(tick - 1) % g.ring_size]
        occ_err = compare(f"sector_occupancy[captured {label}]",
                          kernels.sector_occupancy(slot_words),
                          kernels.sector_occupancy_plain(slot_words))
        occ_ms = time_ms(lambda: kernels.sector_occupancy(slot_words), reps,
                         calls=KERNEL_CALLS)
        occ_plain_ms = time_ms(lambda: kernels.sector_occupancy_plain(slot_words), reps)
        opt = captured_with_options(g, hist, occ, tick, n, dev, reps)
        # The option-free call again, right after the options' timing.
        ms_again = time_ms(lambda: run(False, occ), reps, calls=KERNEL_CALLS)
        results[label] = dict(
            max_abs_err=max(err, occ_err, opt["max_abs_err"]), ms=ms,
            ms_no_occupancy=ms_full, plain_ms=plain_ms, bound_ms=bound_ms(nbytes),
            sector_share=share, occupancy_ms=occ_ms, occupancy_plain_ms=occ_plain_ms,
            ms_loss=opt["ms"], plain_ms_loss=opt["plain_ms"],
            bound_ms_loss=opt["bound_ms"], ms_again=ms_again,
        )
        log(
            f"gather_or[captured {label}, tick {tick}] D={g.ring_size}: bitwise "
            f"equal (kernel == plain == kernel without occupancy); sector occupancy "
            f"met by the gather {share:.4f} of {edges} edges x {nsec} sectors; "
            f"kernel {ms:.4f} ms (reading every sector: {ms_full:.4f} ms), plain "
            f"{plain_ms:.3f} ms, bound {bound_ms(nbytes):.4f} ms ({nbytes / 1e6:.1f} "
            f"MB); sector_occupancy of the tick-{tick - 1} slot: kernel {occ_ms:.4f} "
            f"ms, plain {occ_plain_ms:.4f} ms"
        )
        log(
            f"gather_or[captured {label}, tick {tick}] with loss p=0.05 and 10% of "
            f"nodes down: bitwise equal; kernel {opt['ms']:.4f} ms (without options, "
            f"timed again beside it: {ms_again:.4f} ms), plain {opt['plain_ms']:.3f} "
            f"ms, bound {opt['bound_ms']:.4f} ms; edges kept {opt['kept']} of {edges}"
        )
        del hist, occ
    return results


def captured_with_options(g, hist, occ, tick, n, dev, reps):
    """gather_or on a captured ring with the loss coin at p = 0.05 (the
    options run's loss model) and an up mask with 10% of the nodes down.
    The bound counts the occupied sectors of each distinct source row of a
    kept edge (not dropped, to an up node) once, its occupancy word, the
    staged ELL and bucket rows, the up mask and the output."""
    import torch

    from p2p_gossip_tpu_torch.models.linkloss import LinkLossModel, drop_mask_torch
    from p2p_gossip_tpu_torch.models.seeds import loss_stream_seed
    from p2p_gossip_tpu_torch.ops import kernels
    from p2p_gossip_tpu_torch.ops.ell import propagate_bucketed

    loss = LinkLossModel(0.05, seed=loss_stream_seed(SEED)).static_cfg
    up = torch.as_tensor(np.random.default_rng(SEED + 2).random(n) >= 0.1, device=dev)

    def run(plain):
        return propagate_bucketed(
            hist, tick, g.buckets, n_out=n, ring_size=g.ring_size,
            uniform_delay=g.uniform_delay, occ=occ, loss=loss, up=up, plain=plain,
        )

    err = compare("gather_or[captured, loss + up]", run(False), run(True))
    w = hist.shape[-1]
    sw = kernels.sector_words(w)
    keys, staged, rows_bytes = [], 0, 0
    for rows, idx, mask, delay in g.buckets:
        if g.uniform_delay is not None:
            slot = torch.full_like(idx, (tick - g.uniform_delay) % g.ring_size,
                                   dtype=torch.int64)
        else:
            slot = torch.remainder(tick - delay.long(), g.ring_size)
        keep = mask & ~drop_mask_torch(idx, rows.long()[:, None], tick, *loss)
        keep &= up[rows.long()][:, None]
        keys.append((slot * n + idx.long())[keep])
        staged += int(idx.numel())
        rows_bytes += 4 * int(rows.numel())
    distinct = torch.unique(torch.cat(keys))
    per_entry = 5 if g.uniform_delay is not None else 9
    nbytes = (set_bits(occ.reshape(-1)[distinct]) * sw * 4 + distinct.numel() * 4
              + staged * per_entry + rows_bytes + n + n * w * 4)
    return dict(
        max_abs_err=err, kept=int(sum(k.numel() for k in keys)),
        ms=time_ms(lambda: run(False), reps, calls=KERNEL_CALLS),
        plain_ms=time_ms(lambda: run(True), max(2, reps // 4), warmup=1),
        bound_ms=bound_ms(nbytes),
    )


def check_popcount(n, w, dev, rng, reps):
    from p2p_gossip_tpu_torch.ops import kernels

    for shape in ((1237, 3), (5, 1)):
        words = random_words(rng, shape, dev)
        words[0] = -1
        compare(f"popcount_rows{shape}", kernels.popcount_rows(words),
                kernels.popcount_rows_plain(words))
    words = random_words(rng, (n, w), dev)
    got, want = kernels.popcount_rows(words), kernels.popcount_rows_plain(words)
    err = compare("popcount_rows", got, want)
    ms = time_ms(lambda: kernels.popcount_rows(words), reps, calls=KERNEL_CALLS)
    plain_ms = time_ms(lambda: kernels.popcount_rows_plain(words), reps)
    nbytes = n * w * 4 + n * 4
    log(
        f"popcount_rows ({n}, {w}): bitwise equal; kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {bound_ms(nbytes):.4f} ms"
    )
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms(nbytes))


def check_coverage(n, w, dev, rng, reps):
    from p2p_gossip_tpu_torch.ops import kernels

    # Ragged cases: N off every tile, W in {1, 3}, slots off 32, bit 31 set,
    # and a column slice of a wider bitmask (row stride > W).
    for shape, slots in (((4099, 1), 17), ((1237, 3), 77), ((100_003, 3), 96)):
        words = random_words(rng, shape, dev)
        words[0] = -1
        words[1] = -(2**31)
        compare(f"coverage_per_slot{shape}", kernels.coverage_per_slot(words, slots),
                kernels.coverage_per_slot_plain(words, slots))
    wide = random_words(rng, (2000, 5), dev)
    compare("coverage_per_slot[slice]", kernels.coverage_per_slot(wide[:, :3], 90),
            kernels.coverage_per_slot_plain(wide[:, :3], 90))
    # Row stride 7 (not a multiple of 4), one slice from an unaligned base.
    wide = random_words(rng, (2000, 7), dev)
    for cols, slots in ((slice(0, 3), 90), (slice(2, 6), 128)):
        compare(f"coverage_per_slot[stride 7 {cols}]",
                kernels.coverage_per_slot(wide[:, cols], slots),
                kernels.coverage_per_slot_plain(wide[:, cols], slots))
    # Runs around the counters' flush period (255 nonzero words a column).
    for rows in (255, 256, 257, 2 * 8 * 255 + 1):
        words = random_words(rng, (rows, 33), dev)
        words[:, 0] = -1
        compare(f"coverage_per_slot[{rows} rows]", kernels.coverage_per_slot(words, 33 * 32),
                kernels.coverage_per_slot_plain(words, 33 * 32))
    words = random_words(rng, (n, w), dev)
    slots = w * 32
    err = compare("coverage_per_slot", kernels.coverage_per_slot(words, slots),
                  kernels.coverage_per_slot_plain(words, slots))
    ms = time_ms(lambda: kernels.coverage_per_slot(words, slots), reps,
                 calls=KERNEL_CALLS)
    plain_ms = time_ms(lambda: kernels.coverage_per_slot_plain(words, slots), reps)
    nbytes = n * w * 4 + slots * 4
    log(
        f"coverage_per_slot ({n}, {w}) -> {slots} random: bitwise equal; kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms(nbytes):.4f} ms"
    )
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms(nbytes))


def check_coverage_frontier(graph, dg, dev, reps):
    """coverage_per_slot on the coverage run's own tick-2 new frontier
    (4,096 origins at t = 0, W = 128), captured from the engine's tick."""
    import p2p_gossip_tpu_torch as pt
    from p2p_gossip_tpu_torch.ops import kernels

    origins = np.random.default_rng(SEED + 1).integers(0, graph.n, COVERAGE_ORIGINS)
    sched = pt.Schedule(graph.n, origins, np.zeros(COVERAGE_ORIGINS, dtype=np.int32))
    _, _, newly = capture_ring(dg, sched, COVERAGE_ORIGINS, 3, dev)
    words, slots = newly[:, : COVERAGE_ORIGINS // 32], COVERAGE_ORIGINS
    err = compare("coverage_per_slot[tick-2 frontier]",
                  kernels.coverage_per_slot(words, slots),
                  kernels.coverage_per_slot_plain(words, slots))
    nonzero = float((words != 0).float().mean())
    ms = time_ms(lambda: kernels.coverage_per_slot(words, slots), reps,
                 calls=KERNEL_CALLS)
    plain_ms = time_ms(lambda: kernels.coverage_per_slot_plain(words, slots), reps)
    nbytes = words.numel() * 4 + slots * 4
    log(
        f"coverage_per_slot tick-2 frontier {tuple(words.shape)} ({nonzero:.4f} of "
        f"words nonzero): bitwise equal; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {bound_ms(nbytes):.4f} ms"
    )
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms(nbytes),
                nonzero_words=nonzero)



def check_scatter_ragged(dev, rng):
    """scatter_or (plan + kernel) against its plain version on awkward
    shapes: M off a multiple of 32 and of a block's 8 rows, W of 1, 3, 8
    and 256 (4- and 16-byte loads), bit 31 set in every source row,
    masked-out entries, every entry to one destination (runs of 77, 513
    and 4,099 entries: more than one 32-index load), destinations and
    source rows outside range (dropped), rows read through ``src_row`` and,
    where M allows it, by identity, M = 0; each plan with no base (``out``
    starts as all ones, so a row the kernel should write and does not
    shows), a base, the base as ``out`` itself (in place), the and-not
    frontier, and pulled rows (-1 and out of range among them) over a
    base."""
    import torch

    from p2p_gossip_tpu_torch.ops import kernels, segment

    cases = (  # m, n_src, n_out, w, one destination
        (37, 50, 20, 1, False), (1001, 700, 333, 3, False), (77, 80, 9, 8, True),
        (4099, 5000, 4096, 256, False), (513, 600, 1, 256, True), (1, 1, 1, 3, False),
        (0, 4, 4, 8, False), (4099, 4500, 3, 256, True),
    )
    for m, n_src, n_out, w, hot in cases:
        src = random_words(rng, (n_src, w), dev)
        src[:, -1] |= -(2**31)
        dst = np.zeros(m, np.int32) if hot else rng.integers(-3, n_out + 3, m)
        dst = torch.as_tensor(dst.astype(np.int32), device=dev)
        src_row = torch.as_tensor(rng.integers(-2, n_src + 2, m).astype(np.int32),
                                  device=dev)
        mask = torch.as_tensor(rng.random(m) < 0.75, device=dev)
        base = sparse_words(rng, (n_out, w), dev)
        pull = torch.as_tensor(rng.integers(-3, n_src + 3, n_out).astype(np.int32), device=dev)
        for rows_arg, mask_arg in ((src_row, mask), (src_row, None), (None, mask)):
            if rows_arg is None and m > n_src:
                continue
            offsets, entries = kernels.scatter_or_plan(dst, rows_arg, mask_arg, n_out, n_src)
            label = (f"scatter_or[m={m} w={w} n_out={n_out} one_dst={hot} "
                     f"src_row={rows_arg is not None} mask={mask_arg is not None}")
            for opt in ("zeros", "base", "in place", "andnot", "pull"):
                def run(plain, opt=opt, offsets=offsets, entries=entries):
                    out = (base.clone() if opt == "in place"
                           else torch.full_like(base, -1))
                    b = {"zeros": None, "in place": out}.get(opt, base)
                    return kernels.scatter_or(
                        src, offsets, entries, pull_row=pull if opt == "pull" else None,
                        base=b, andnot=opt == "andnot", out=out, plain=plain)

                compare(f"{label} {opt}]", run(False), run(True))
            want = kernels.scatter_or(src, offsets, entries, out=torch.empty_like(base))
            compare(f"{label} segment]", segment.scatter_or(
                n_out, dst, src, mask_arg, src_row=rows_arg), want)
    log("scatter_or ragged shapes (M 0..4099, W 1/3/8/256, bit 31, masks, one "
        "destination of up to 4,099 entries, out-of-range dst and rows, identity rows; "
        "no base, base, in place, and-not, pulled rows; via ops.segment): bitwise equal")


def scatter_or_bound_bytes(n_out, w, distinct_rows, entries, pull_rows, base):
    """The least traffic of one `scatter_or` call: ``base`` read once if
    given, each distinct kept source row read once, ``out`` written once,
    4(n_out + 1) bytes of offsets and 4 bytes per entry and per pull row."""
    rows = n_out * w * 4
    return ((rows if base else 0) + distinct_rows * w * 4 + rows + 4 * (n_out + 1)
            + 4 * entries + 4 * pull_rows)


def check_scatter(graph, dg_edge, sched, dev, reps):
    """scatter_or at the protocols' shapes, sources read from the phase-9
    push-pull run's own (D*N, W) seen-ring as it stood at round
    PROTOCOL_CAPTURE_ROUND and at PROTOCOL_DENSE_ROUND (dense rows): the
    push of that round from zeros, M = N (push-pull's picks) and M = 2N
    (two picks a node, fanout 2's shape), given its plan; then the
    push-pull round's own call (pull rows and the push plan, ``base =
    seen``, out = the round's ring slot). Each against its plain version,
    bitwise; timed beside its bound (`scatter_or_bound_bytes`, from this
    ring's distinct kept rows); the plan timed alone, as the round loop
    makes it (16 rounds in one call, per round)."""
    import torch

    from p2p_gossip_tpu_torch.models import protocols
    from p2p_gossip_tpu_torch.models.partnersel import pick_key
    from p2p_gossip_tpu_torch.ops import kernels

    n, ring = graph.n, dg_edge.ring_size
    w = CHUNK // 32
    origins, gen_ticks = sched.padded(CHUNK, HORIZON)
    nodes = torch.arange(n, dtype=torch.int64, device=dev)
    results = {}
    for t in (PROTOCOL_CAPTURE_ROUND, PROTOCOL_DENSE_ROUND):
        key1 = pick_key(nodes[:, None], torch.zeros((1, 1), dtype=torch.int64, device=dev),
                        SEED)
        _, _, _, hist = protocols._run_chunk(
            dg_edge, origins, gen_ticks, key1, None, None, None, mode="pushpull",
            chunk_size=CHUNK, horizon=t, n_cov=None, plain=False,
        )
        flat = hist.view(-1, w)
        tag = "" if t == PROTOCOL_CAPTURE_ROUND else f" round {t}"
        for label, fanout in (("pushpull M=N", 1), ("fanout2 M=2N", 2)):
            key = pick_key(nodes[:, None], torch.arange(fanout, device=dev)[None, :], SEED)
            block = protocols._draw_rounds(dg_edge, key, None, None, None, t,
                                           t + protocols.PICK_BLOCK, "pushk")
            dst = block["partners"][0].reshape(-1).contiguous()
            rows = block["src"][0].reshape(-1).contiguous()
            mask = block["attempted"][0].reshape(-1).contiguous()
            offsets, entries = block["plan"]  # round t's: the block's first
            offsets = offsets[:n + 1]

            def run(plain, offsets=offsets, entries=entries):
                out = torch.empty((n, w), dtype=torch.int32, device=dev)
                return kernels.scatter_or(flat, offsets, entries, out=out, plain=plain)

            def plan_block(block=block):
                return protocols._push_plan(block["partners"], block["src"],
                                            block["attempted"], n, ring)

            got = run(False)
            err = compare(f"scatter_or[{label} round {t}]", got, run(True))
            m = int(dst.numel())
            kept = int(mask.sum())
            distinct = int(torch.unique(rows.long()[mask]).numel())
            nbytes = scatter_or_bound_bytes(n, w, distinct, kept, 0, False)
            ms = time_ms(lambda: run(False), reps, calls=KERNEL_CALLS)
            plain_ms = time_ms(lambda: run(True), max(2, reps // 4), warmup=1)
            plan_ms = time_ms(plan_block, reps, calls=2) / protocols.PICK_BLOCK
            # The plan's device time alone (the event time above includes
            # the host's gaps between its ~15 small launches).
            _, _, by_name, _ = device_events(lambda: [plan_block() for _ in range(4)])
            plan_device_ms = (sum(by_name.values()) / 1e3 / 4 / protocols.PICK_BLOCK
                              if by_name else None)
            nonzero = float((flat[rows.long()] != 0).float().mean())
            results[label + tag] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                        bound_ms=bound_ms(nbytes), plan_ms=plan_ms,
                                        plan_device_ms=plan_device_ms)
            log(
                f"scatter_or[{label}, round-{t} ring D={ring}] M={m} kept={kept} W={w}, "
                f"{distinct} distinct source rows, {nonzero:.4f} of their words nonzero: "
                f"bitwise equal; kernel from zeros given its plan {ms:.4f} ms, "
                f"plain {plain_ms:.3f} ms, bound "
                f"{bound_ms(nbytes):.4f} ms ({nbytes / 1e6:.1f} MB); plan (16 rounds a call) "
                f"{plan_ms:.4f} ms a round by CUDA events, device time "
                + ("not measured" if plan_device_ms is None else f"{plan_device_ms:.4f} ms")
                + " a round (torch.profiler)"
            )
        results["round call" + tag] = check_round_call(dg_edge, hist, t, dev, reps)
        del hist, flat
    return results


def check_round_call(dg, hist, t, dev, reps):
    """The push-pull round's own `scatter_or` call on a captured ring:
    pull rows and the push plan of round t from `_draw_rounds`, ``base``
    = seen (slot t-1), out = slot t; against its plain version."""
    import torch

    from p2p_gossip_tpu_torch.models import protocols
    from p2p_gossip_tpu_torch.models.partnersel import pick_key
    from p2p_gossip_tpu_torch.ops import kernels

    n, ring = dg.n, dg.ring_size
    w = hist.shape[-1]
    flat = hist.view(-1, w)
    nodes = torch.arange(n, dtype=torch.int64, device=dev)
    key = pick_key(nodes[:, None], torch.zeros((1, 1), dtype=torch.int64, device=dev), SEED)
    draw = protocols._draw_rounds(dg, key, None, None, None, t, t + 1, "pushpull")
    offsets, entries = draw["plan"]
    pull_row = draw["pull_row"][0]
    seen, row = hist[(t - 1) % ring], hist[t % ring]

    def run(plain):
        return kernels.scatter_or(flat, offsets, entries, pull_row=pull_row, base=seen,
                                  out=row, plain=plain)

    want = run(True).clone()
    err = compare(f"scatter_or[push-pull round call, round {t}]", run(False), want)
    kept_pull = pull_row[pull_row >= 0].long()
    kept_push = entries[: int(offsets[-1])].long()
    distinct = int(torch.unique(torch.cat([kept_pull, kept_push])).numel())
    nbytes = scatter_or_bound_bytes(n, w, distinct, int(kept_push.numel()), n, True)
    ms = time_ms(lambda: run(False), reps, calls=KERNEL_CALLS)
    plain_ms = time_ms(lambda: run(True), max(2, reps // 4), warmup=1)
    log(
        f"scatter_or[push-pull round call, round-{t} ring D={ring}] pull rows "
        f"{int(kept_pull.numel())}, push entries {int(kept_push.numel())}, {distinct} "
        f"distinct source rows, base = seen, out = slot {t % ring}: bitwise equal to its "
        f"plain version; one call {ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
        f"{bound_ms(nbytes):.4f} ms ({nbytes / 1e6:.1f} MB)"
    )
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms(nbytes))


# Phase 3's narrow rows: the push-pull cells' round calls, each on the
# cell's own graph (gossipbench's generator and staging) and its own ring.
NARROW_ROUND = 12  # the captured round: rows past the first rounds' empty ones
NARROW_CASES = (  # label, gossipbench config, replicas, shares a pass, lanes a row
    ("campaign8 W=4", "er100k", 8, 128, 1),
    ("pushpull 1M W=4", "ba1m-lognormal", 1, 128, 1),
    ("pushpull 1M W=128", "ba1m-lognormal", 1, 4096, 32),
)
# The 1M BA round must hold a run longer than this: its hubs' push runs,
# which the whole warp takes at W = 4. A round's longest is 685 entries on
# the cell's graph (835 on the program's BA graph): one push a node a
# round does not reach 1,000 at 1M nodes.
NARROW_HUB_RUN = 500


def narrow_case_graph(config: str, dev):
    """A push-pull cell's graph drawn by the benchmark's generator and
    staged as the cell's entry stages it: the protocols' CSR with the
    configuration's per-link delays, or its one delay."""
    from gossipbench.gen import delays as gen_delays
    from gossipbench.gen import topology as gen_topology
    from p2p_gossip_tpu_torch.models.protocols import PartnerGraph
    from p2p_gossip_tpu_torch.models.topology import Graph

    root = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, "gossipbench", "configs", f"{config}.json")) as f:
        cfg = json.load(f)
    n = int(cfg["graph"]["n"])
    graph = Graph.from_edges(n, gen_topology.edges_of(cfg["graph"], [SEED, 25]))
    if "delays" in cfg:
        delays = gen_delays.edge_delays(cfg["delays"], n, graph.indptr, graph.indices)
        return PartnerGraph.build(graph, delays, device=dev)
    return PartnerGraph.build(graph, constant_delay=int(cfg["delay_ticks"]), device=dev)


def narrow_round(pg, replicas: int, chunk: int, t: int, dev):
    """Round ``t``'s `scatter_or` call of a push-pull pass (``replicas`` >
    1: a campaign batch, each replica its own partner seed) of ``chunk``
    shares from origins on tick 0, on the ring rounds 0..t-1 left: (flat
    ring, offsets, entries, pull rows, seen = slot t-1, out = slot t)."""
    import torch

    from p2p_gossip_tpu_torch.models import protocols
    from p2p_gossip_tpu_torch.models.partnersel import pick_key

    n = replicas * pg.n
    origins = np.random.default_rng([SEED, 25]).integers(0, pg.n, (replicas, chunk))
    rows = (origins + np.arange(replicas)[:, None] * pg.n).reshape(-1)
    nodes = torch.arange(n, dtype=torch.int64, device=dev)
    seeds = (nodes // pg.n + SEED)[:, None]
    key = pick_key((nodes % pg.n)[:, None], torch.zeros((1, 1), dtype=torch.int64, device=dev),
                   seeds)
    hist = protocols._run_chunk(
        pg, rows, np.zeros(rows.size, np.int32), key, None, None, None, mode="pushpull",
        chunk_size=chunk, horizon=t, n_cov=None, plain=False, replicas=replicas)[3]
    draw = protocols._draw_rounds(pg, key, None, None, None, t, t + 1, "pushpull",
                                  replicas=replicas)
    offsets, entries = draw["plan"]
    ring = pg.ring_size
    return (hist.view(-1, hist.shape[-1]), offsets, entries, draw["pull_row"][0],
            hist[(t - 1) % ring], hist[t % ring])


def check_scatter_narrow(dev, reps):
    """The push-pull cells' round calls (NARROW_CASES): campaign8's
    (800,000 rows at W = 4: one lane a row), the 1M BA round at W = 4
    (one lane a row, hub runs of more than NARROW_HUB_RUN entries taken by
    the whole warp) and at W = 128 (a warp a row), both on the 1M cell's
    graph. Each against its plain
    version, bitwise; its launch counted under the lanes the case names;
    the kernel timed beside its bound (`scatter_or_bound_bytes`) by
    launches of its C entry point, so the wrapper's host work, which is
    most of a call at campaign8's 0.02 ms, is left out."""
    import torch

    from p2p_gossip_tpu_torch.ops import kernels

    results, staged = {}, {}
    for label, config, replicas, chunk, lanes in NARROW_CASES:
        if config not in staged:
            staged.clear()  # one graph staged at a time
            torch.cuda.empty_cache()
            staged[config] = narrow_case_graph(config, dev)
        pg = staged[config]
        flat, offsets, entries, pull_row, seen, row = narrow_round(pg, replicas, chunk,
                                                                  NARROW_ROUND, dev)
        n, w = row.shape

        def run(plain):
            return kernels.scatter_or(flat, offsets, entries, pull_row=pull_row, base=seen,
                                      out=row, plain=plain)

        want = run(True).clone()
        kernels.reset_launches()
        err = compare(f"scatter_or[{label} round {NARROW_ROUND}]", run(False), want)
        if kernels.scatter_or_lanes != {lanes: 1}:
            raise AssertionError(f"scatter_or[{label}]: launches by lanes "
                                 f"{kernels.scatter_or_lanes}, not {{{lanes}: 1}}")
        runs = offsets[1:] - offsets[:-1]
        max_run = int(runs.max())
        if config == "ba1m-lognormal" and max_run <= NARROW_HUB_RUN:
            raise AssertionError(f"scatter_or[{label}]: longest run {max_run} entries, "
                                 f"not above {NARROW_HUB_RUN}")
        kept_pull = pull_row[pull_row >= 0].long()
        kept_push = entries[: int(offsets[-1])].long()
        distinct = int(torch.unique(torch.cat([kept_pull, kept_push])).numel())
        nbytes = scatter_or_bound_bytes(n, w, distinct, int(kept_push.numel()), n, True)

        def launch():  # the kernel alone: its C entry point, past the wrapper's host work
            err = kernels._lib().gossip_scatter_or(
                flat.data_ptr(), flat.shape[0], w, offsets.data_ptr(), entries.data_ptr(),
                pull_row.data_ptr(), seen.data_ptr(), 0, n, row.data_ptr(), lanes,
                torch.cuda.current_stream(dev).cuda_stream)
            assert err == 0, f"scatter_or[{label}]: launch failed with error {err}"

        ms = time_ms(launch, reps, calls=KERNEL_CALLS)
        results[label] = dict(max_abs_err=err, ms=ms, bound_ms=bound_ms(nbytes), lanes=lanes,
                              max_run=max_run, runs_over_32=int((runs > 32).sum()))
        log(f"scatter_or[{label}, round-{NARROW_ROUND} ring D={pg.ring_size}] {n} rows, W={w}, "
            f"{lanes} lane(s) a row; pull rows {int(kept_pull.numel())}, push entries "
            f"{int(kept_push.numel())}, longest run {max_run}, "
            f"{results[label]['runs_over_32']} runs over 32: bitwise equal to its plain "
            f"version; one launch {ms:.4f} ms (CUDA events over its C entry point), "
            f"bound {bound_ms(nbytes):.4f} ms "
            f"({nbytes / 1e6:.1f} MB)")
        del flat, offsets, entries, pull_row, seen, row, want
    staged.clear()
    torch.cuda.empty_cache()
    return results


# --- phase 4 ----------------------------------------------------------------

def check_engine_paths(dev):
    """The whole path with kernels and with plain versions: equal results."""
    import p2p_gossip_tpu_torch as pt
    from p2p_gossip_tpu_torch.engine.sync import run_flood_coverage, run_sync_sim

    g = pt.erdos_renyi(2000, 0.01, seed=1)
    sched = pt.uniform_renewal_schedule(2000, 10.0, 0.005, seed=1)
    cases = [("ER 2000 p=0.01, 1024-share chunks", g, sched, 2000, None, 1024)]
    ba = pt.barabasi_albert(300, 3, seed=2)
    d = pt.lognormal_delays(ba, mean_ticks=2.0, sigma=0.5, max_ticks=8, seed=2)
    ba_sched = pt.poisson_schedule(300, 5.0, 0.01, rate=0.2, seed=2)
    cases.append(("BA 300 m=3 lognormal delays", ba, ba_sched, 500, d, 4096))
    for label, graph, sch, horizon, delays, chunk in cases:
        t0 = time.perf_counter()
        k = run_sync_sim(graph, sch, horizon, ell_delays=delays,
                         chunk_size=chunk, device=dev)
        t1 = time.perf_counter()
        p = run_sync_sim(graph, sch, horizon, ell_delays=delays,
                         chunk_size=chunk, device=dev, plain=True)
        t2 = time.perf_counter()
        if not (k.equal_counts(p)
                and k.extra["ticks_executed"] == p.extra["ticks_executed"]):
            raise AssertionError(f"{label}: kernel and plain paths differ")
        k.check_conservation()
        log(
            f"engine[{label}]: {sch.num_shares} shares, "
            f"{k.extra['ticks_executed']} ticks, kernel path {t1 - t0:.2f} s, "
            f"plain path {t2 - t1:.2f} s, equal NodeStats, conservation holds"
        )
    check_engine_options(dev, cases)
    check_cli(dev)
    origins = np.arange(0, 300, 3)
    _, ck = run_flood_coverage(ba, origins, 60, ell_delays=d, device=dev)
    _, cp = run_flood_coverage(ba, origins, 60, ell_delays=d, device=dev, plain=True)
    if not np.array_equal(ck, cp):
        raise AssertionError("coverage: kernel and plain paths differ")
    log(f"coverage[BA 300]: {len(origins)} origins, kernel == plain over 60 ticks")


def check_engine_options(dev, cases):
    """The same two engine cases with every option on — churn, loss, the
    connect window and snapshot boundaries — on the kernel and the plain
    path: equal counters, executed ticks and snapshots. Then the first
    case stopped after one chunk with a checkpoint in a temporary directory
    and resumed: equal to the uninterrupted run."""
    import os
    import tempfile

    import p2p_gossip_tpu_torch as pt
    from p2p_gossip_tpu_torch.engine.sync import run_sync_sim

    for i, (label, graph, sch, horizon, delays, chunk) in enumerate(cases):
        opts = dict(
            ell_delays=delays, chunk_size=chunk,
            churn=pt.random_churn(graph.n, horizon, outage_prob=0.2,
                                  mean_down_ticks=40.0, max_outages=2,
                                  seed=pt.churn_stream_seed(i)),
            loss=pt.LinkLossModel(0.1, seed=pt.loss_stream_seed(i)),
            connect_tick=int(sch.gen_ticks[sch.num_shares // 10]),
            snapshot_ticks=[horizon // 5, horizon // 2, horizon - 7, horizon],
            device=dev,
        )
        t0 = time.perf_counter()
        k = run_sync_sim(graph, sch, horizon, **opts)
        t1 = time.perf_counter()
        p = run_sync_sim(graph, sch, horizon, plain=True, **opts)
        t2 = time.perf_counter()
        if not (k.equal_counts(p)
                and k.extra["ticks_executed"] == p.extra["ticks_executed"]
                and k.extra["snapshots"] == p.extra["snapshots"]):
            raise AssertionError(f"{label} with options: kernel and plain paths differ")
        log(
            f"engine[{label}] with churn, loss p=0.1, connect tick "
            f"{opts['connect_tick']}, 4 snapshots: {k.extra['ticks_executed']} ticks, "
            f"kernel path {t1 - t0:.2f} s, plain path {t2 - t1:.2f} s, equal "
            f"NodeStats, ticks and snapshots"
        )
        if i == 0:
            with tempfile.TemporaryDirectory() as tmp:
                ckpt = os.path.join(tmp, "run.npz")
                part = run_sync_sim(graph, sch, horizon, checkpoint_path=ckpt,
                                    stop_after_chunks=1, **opts)
                resumed = run_sync_sim(graph, sch, horizon, checkpoint_path=ckpt, **opts)
            if part.equal_counts(k) or not resumed.equal_counts(k) or (
                resumed.extra["snapshots"] != k.extra["snapshots"]
            ):
                raise AssertionError(f"{label}: checkpoint resume differs")
            log(f"engine[{label}] with options: stopped after 1 chunk of "
                f"{-(-sch.num_shares // chunk)}, resumed from the checkpoint: equal "
                "to the uninterrupted run")


def check_cli(dev):
    """``python -m p2p_gossip_tpu_torch`` on the card against the same
    flags on the CPU (the plain torch versions): the reference default run
    (its five periodic-stats blocks included) and a run with churn, loss,
    the connect window and lognormal delays print the same report, apart
    from the start line's device and the wall-time line."""
    import contextlib
    import io

    from p2p_gossip_tpu_torch.utils import cli

    def report(args):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.run(args)
        if rc != 0:
            raise AssertionError(f"CLI {args} exited {rc}")
        return buf.getvalue().splitlines(), time.perf_counter() - t0

    options = ["--numNodes", "60", "--simTime", "20", "--statsInterval", "5",
               "--churnProb", "0.2", "--lossProb", "0.1", "--connectAtTick", "300",
               "--delayModel", "lognormal"]
    for label, args, blocks in (("reference defaults", [], 5), ("options", options, 3)):
        got, wall = report(args + ["--device", str(dev)])
        want, plain_wall = report(args + ["--device", "cpu"])
        if got[1:-1] != want[1:-1] or len(got) != len(want):
            raise AssertionError(f"CLI {label}: report differs from the plain path's")
        periodic = sum(ln.startswith("=== Periodic Stats at ") for ln in got)
        if periodic != blocks:
            raise AssertionError(f"CLI {label}: {periodic} periodic blocks, not {blocks}")
        log(f"cli[{label}] on {dev} {wall:.2f} s, on the CPU {plain_wall:.2f} s: equal "
            f"reports ({periodic} periodic-stats blocks)")


def check_protocol_paths(dev):
    """Push-pull, pull and fanout push (k = 2) with the kernels and with
    the plain versions on ER 2,000 (3,000 shares over 16 rounds, 1,024-share
    chunks) and BA 300 (Poisson generations), both with log-normal delays,
    40 rounds, coverage rows recorded; each also with churn and loss p =
    0.1. Counters and coverage rows must be equal. Then each protocol on
    ER stopped after one chunk and resumed from its checkpoint: equal to
    the uninterrupted run."""
    import os
    import tempfile

    import p2p_gossip_tpu_torch as pt
    from p2p_gossip_tpu_torch.models.protocols import run_pushk_sim, run_pushpull_sim

    rounds = 40
    rng = np.random.default_rng(1)
    er = pt.erdos_renyi(2000, 0.01, seed=1)
    er_sched = pt.Schedule(2000, rng.integers(0, 2000, 3000), rng.integers(0, 16, 3000))
    ba = pt.barabasi_albert(300, 3, seed=2)
    ba_sched = pt.poisson_schedule(300, 5.0, 0.25, rate=0.4, seed=2)
    cases = (
        ("ER 2000 p=0.01", er, er_sched,
         pt.lognormal_delays(er, mean_ticks=2.0, sigma=0.5, max_ticks=5, seed=1), 1024),
        ("BA 300 m=3", ba, ba_sched,
         pt.lognormal_delays(ba, mean_ticks=2.0, sigma=0.5, max_ticks=8, seed=2), 4096),
    )
    protos = (("pushpull", run_pushpull_sim, dict(mode="pushpull")),
              ("pull", run_pushpull_sim, dict(mode="pull")),
              ("pushk", run_pushk_sim, dict(fanout=2)))
    for i, (label, graph, sch, delays, chunk) in enumerate(cases):
        models = dict(
            churn=pt.random_churn(graph.n, rounds, outage_prob=0.2, mean_down_ticks=4.0,
                                  max_outages=2, seed=pt.churn_stream_seed(i)),
            loss=pt.LinkLossModel(0.1, seed=pt.loss_stream_seed(i)),
        )
        for name, fn, kw in protos:
            for opt_label, opts in (("", {}), (" with churn + loss", models)):
                common = dict(ell_delays=delays, seed=3, chunk_size=chunk, device=dev,
                              **kw, **opts)
                t0 = time.perf_counter()
                k, kc = fn(graph, sch, rounds, record_coverage=True, **common)
                t1 = time.perf_counter()
                p, pc = fn(graph, sch, rounds, record_coverage=True, plain=True, **common)
                t2 = time.perf_counter()
                if not (k.equal_counts(p) and np.array_equal(kc, pc)):
                    raise AssertionError(f"{name}[{label}{opt_label}]: kernel and plain differ")
                if not (np.diff(kc, axis=0) >= 0).all() or kc.max() > graph.n:
                    raise AssertionError(f"{name}[{label}{opt_label}]: bad coverage rows")
                log(f"{name}[{label}{opt_label}]: {sch.num_shares} shares, {rounds} rounds, "
                    f"received {int(k.received.sum())}, kernel {t1 - t0:.2f} s, plain "
                    f"{t2 - t1:.2f} s: equal counters and coverage rows")
                if i == 0 and opts:
                    with tempfile.TemporaryDirectory() as tmp:
                        ckpt = os.path.join(tmp, "run.npz")
                        part, _ = fn(graph, sch, rounds, checkpoint_path=ckpt,
                                     stop_after_chunks=1, **common)
                        resumed, _ = fn(graph, sch, rounds, checkpoint_path=ckpt, **common)
                    if part.equal_counts(k) or not resumed.equal_counts(k):
                        raise AssertionError(f"{name}[{label}]: checkpoint resume differs")
                    log(f"{name}[{label}{opt_label}]: stopped after 1 chunk, resumed from "
                        "the checkpoint: equal to the uninterrupted run")


def check_protocol_cli(dev):
    """The CLI's protocol, topology and generation flags on the card and on
    the CPU: the same report, apart from the start line's device and the
    wall-time line."""
    import contextlib
    import io

    from p2p_gossip_tpu_torch.utils import cli

    small = ["--numNodes", "60", "--simTime", "10", "--Latency", "50"]
    configs = (
        ("pushpull lognormal", small + ["--protocol", "pushpull", "--delayModel",
                                        "lognormal"]),
        ("pull churn + loss", small + ["--protocol", "pull", "--churnProb", "0.2",
                                       "--lossProb", "0.1"]),
        ("pushk coverage", small + ["--protocol", "pushk", "--fanout", "3",
                                    "--floodCoverage", "20"]),
        ("ws pushpull", ["--numNodes", "80", "--topology", "ws", "--simTime", "10",
                         "--Latency", "50", "--protocol", "pushpull"]),
        ("torus flood", ["--numNodes", "64", "--topology", "torus", "--simTime", "10"]),
        ("poisson pushk", small + ["--genModel", "poisson", "--protocol", "pushk"]),
    )
    for label, args in configs:
        lines = {}
        for device in (str(dev), "cpu"):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = cli.run(args + ["--device", device])
            if rc != 0:
                raise AssertionError(f"CLI {label} on {device} exited {rc}")
            lines[device] = buf.getvalue().splitlines()
        got, want = lines[str(dev)], lines["cpu"]
        if len(got) != len(want) or got[1:-1] != want[1:-1]:
            raise AssertionError(f"CLI {label}: report differs from the CPU's")
        log(f"cli[{label}] on {dev} and on the CPU: equal reports ({len(got)} lines)")


# --- phases 5 and 6 -----------------------------------------------------------

def flood_schedule(graph):
    """bench.py's flood: N_SHARES shares at random origins, generation
    ticks uniform over the first GEN_WINDOW ticks."""
    import p2p_gossip_tpu_torch as pt

    rng = np.random.default_rng(SEED)
    return pt.Schedule(
        graph.n,
        rng.integers(0, graph.n, N_SHARES).astype(np.int32),
        rng.integers(0, GEN_WINDOW, N_SHARES).astype(np.int32),
    )


def main_path(graph, dg, sched, dev):
    import torch

    from p2p_gossip_tpu_torch.engine.sync import (
        run_flood_coverage,
        run_sync_sim,
        time_to_coverage,
    )
    from p2p_gossip_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    warm = run_sync_sim(graph, sched, HORIZON, chunk_size=CHUNK, device_graph=dg,
                        device=dev)
    log(f"main path warm run: {time.perf_counter() - t0:.2f} s")

    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    stats = run_sync_sim(graph, sched, HORIZON, chunk_size=CHUNK, device_graph=dg,
                         device=dev)
    wall = time.perf_counter() - t0
    flood_launches = dict(kernels.launches)
    totals = stats.totals()
    if totals != warm.totals():
        raise AssertionError("timed run differs from the warm run")
    if totals["processed"] != N_SHARES * graph.n:
        raise AssertionError(f"flood incomplete: processed {totals['processed']}")
    stats.check_conservation()
    ticks = stats.extra["ticks_executed"]
    w = CHUNK // 32
    must = dg.must_move_bytes_per_tick(w)
    tick_ms = wall / ticks * 1e3
    log(
        f"main path: N={graph.n} shares={N_SHARES} W={w} ticks={ticks} "
        f"wall={wall:.4f} s -> {totals['processed'] / wall:.4e} node-updates/s, "
        f"{tick_ms:.3f} ms/tick; must-move {must / 1e9:.4f} GB/tick = "
        f"{bound_ms(must):.4f} ms/tick at 3.35 TB/s, achieved "
        f"{bound_ms(must) / tick_ms:.4f} of that bound; "
        f"processed == shares x N, conservation holds; launches {flood_launches}"
    )

    origins = np.random.default_rng(SEED + 1).integers(0, graph.n, COVERAGE_ORIGINS)
    t0 = time.perf_counter()
    cstats, cov = run_flood_coverage(graph, origins, HORIZON, device_graph=dg, device=dev)
    cwall = time.perf_counter() - t0
    launches = dict(kernels.launches)
    if not (cov[-1] == graph.n).all():
        raise AssertionError("coverage did not reach every node")
    if not (np.diff(cov, axis=0) >= 0).all():
        raise AssertionError("coverage rows are not monotone")
    cstats.check_conservation()
    t99 = time_to_coverage(cov, graph.n, 0.99)
    log(
        f"coverage: {COVERAGE_ORIGINS} origins W={COVERAGE_ORIGINS // 32} wall="
        f"{cwall:.4f} s, final coverage N for every share, monotone rows, "
        f"median t99 = {float(np.median(t99))} ticks (min {t99.min()}, max {t99.max()})"
    )
    log(f"main-path kernel launches (flood + coverage): {launches}")
    for name in FLOOD_KERNELS:
        if launches[name] == 0:
            raise AssertionError(f"kernel {name} never launched on the main path")
    if launches != LOSS_FREE_LAUNCHES:
        raise AssertionError(
            f"loss-free main path launched {launches}, not {LOSS_FREE_LAUNCHES}: "
            "the options changed the option-free tick"
        )
    return launches, dict(tick_ms=tick_ms, rate=totals["processed"] / wall, stats=stats)


def options_path(graph, dg, sched, dev, base):
    """The main path with the options on: the same 100K flood under churn
    (10% of nodes with one outage of mean 4 ticks in the 64-tick horizon)
    and link loss (p = 0.05), with snapshot boundaries, then the coverage
    run under the same churn and loss. Kernel launch counts are zeroed
    just before the timed flood and read after the coverage run; the
    plain comparison runs come after that."""
    import torch

    import p2p_gossip_tpu_torch as pt
    from p2p_gossip_tpu_torch.engine.sync import run_flood_coverage, run_sync_sim
    from p2p_gossip_tpu_torch.ops import kernels

    churn = pt.random_churn(graph.n, HORIZON, outage_prob=0.1, mean_down_ticks=4,
                            max_outages=1, seed=pt.churn_stream_seed(SEED))
    loss = pt.LinkLossModel(0.05, seed=pt.loss_stream_seed(SEED))
    flood = dict(chunk_size=CHUNK, device_graph=dg, churn=churn, loss=loss,
                 snapshot_ticks=SNAPSHOTS, device=dev)
    warm = run_sync_sim(graph, sched, HORIZON, **flood)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    stats = run_sync_sim(graph, sched, HORIZON, **flood)
    wall = time.perf_counter() - t0
    origins = np.random.default_rng(SEED + 1).integers(0, graph.n, COVERAGE_ORIGINS)
    cov_kw = dict(device_graph=dg, churn=churn, loss=loss, device=dev)
    cstats, cov = run_flood_coverage(graph, origins, HORIZON, **cov_kw)
    launches = dict(kernels.launches)
    log(f"options-path kernel launches (flood + coverage): {launches}")
    for name in FLOOD_KERNELS:
        if launches[name] == 0:
            raise AssertionError(f"kernel {name} never launched on the options path")
    if launches["scatter_or"]:
        raise AssertionError("scatter_or launched on the options path: the flood never scatters")
    if launches["tick_digest"]:
        raise AssertionError("tick_digest launched on the options path with telemetry off")

    t0 = time.perf_counter()
    plain = run_sync_sim(graph, sched, HORIZON, plain=True, **flood)
    plain_wall = time.perf_counter() - t0
    _, plain_cov = run_flood_coverage(graph, origins, HORIZON, plain=True, **cov_kw)
    for other in (warm, plain):
        if not (stats.equal_counts(other)
                and stats.extra["ticks_executed"] == other.extra["ticks_executed"]
                and stats.extra["snapshots"] == other.extra["snapshots"]):
            raise AssertionError("options flood: runs differ (kernel, warm, plain)")
    if not np.array_equal(cov, plain_cov):
        raise AssertionError("options coverage: kernel and plain paths differ")
    stats.check_conservation()
    cstats.check_conservation()
    if not (np.diff(cov, axis=0) >= 0).all():
        raise AssertionError("options coverage rows are not monotone")
    totals = stats.totals()
    ticks = stats.extra["ticks_executed"]
    tick_ms = wall / ticks * 1e3
    rate = totals["processed"] / wall
    log(
        f"options path: churn ({int((churn.down_end > churn.down_start).sum())} "
        f"outages), loss p=0.05, snapshots at {SNAPSHOTS}: ticks={ticks} wall="
        f"{wall:.4f} s -> {rate:.4e} node-updates/s, {tick_ms:.3f} ms/tick "
        f"(loss-free run: {base['tick_ms']:.3f} ms/tick, {base['rate']:.4e}; ratio "
        f"{tick_ms / base['tick_ms']:.3f}); processed {totals['processed']} of "
        f"{N_SHARES * graph.n}; kernel == warm == plain (counters, ticks, "
        f"snapshots; plain {plain_wall:.2f} s), conservation holds; snapshots "
        f"processed {[s['processed'] for s in stats.extra['snapshots']]}; coverage "
        f"kernel == plain, final mean {cov[-1].mean():.1f} of {graph.n}"
    )
    return launches, dict(churn=churn, loss=loss, snapshot_ticks=SNAPSHOTS)


def device_events(run):
    """Run ``run()`` under torch.profiler: (its result, wall seconds,
    device microseconds by kernel name from the CUDA events, launches by
    kernel name)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        result = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name: dict[str, float] = {}
    calls: dict[str, int] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
            calls[e.name] = calls.get(e.name, 0) + 1
    return result, wall, by_name, calls


def profile_device(label, run, top=10):
    """Device time of ``run()`` by kernel name, from torch.profiler's CUDA
    kernel events, and the share of the run's wall time the device was
    busy (kernels run on one stream, so their durations add). ``run``
    returns the number of ticks (rounds) it ran. Each line gives the
    kernel's device time, its share of the busy time and its launches."""
    ticks, wall, by_name, calls = device_events(run)
    if not by_name:
        log("profile: no device events recorded; breakdown not measured")
        return
    busy_us = sum(by_name.values())
    log(
        f"profile (profiled {label} run, {ticks} ticks, wall {wall * 1e3:.2f} ms): "
        f"device busy {busy_us / 1e3:.2f} ms = {busy_us / (wall * 1e6):.3f} of wall"
    )
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        log(f"  {us / 1e3:9.3f} ms  {us / busy_us:6.3f}  x{calls[name]:<5d} {name[:110]}")
    rest = sorted(by_name.items(), key=lambda kv: -kv[1])[top:]
    if rest:
        log(f"  {sum(us for _, us in rest) / 1e3:9.3f} ms in {len(rest)} other kernels")


def profile_flood(graph, sched, dg, dev, label="flood", **opts):
    """One flood run (``opts``: the engine's options) under the profiler."""
    from p2p_gossip_tpu_torch.engine.sync import run_sync_sim

    def run():
        stats = run_sync_sim(graph, sched, HORIZON, chunk_size=CHUNK,
                             device_graph=dg, device=dev, **opts)
        return stats.extra["ticks_executed"]

    profile_device(label, run)


# --- phase 9 ------------------------------------------------------------------

def pushpull_floor_bytes(n: int, w: int) -> int:
    """A rough floor of one push-pull round's device-memory traffic, four
    (N, W) int32 passes: ``seen`` read, the partners' pulled rows read, the
    pushed rows read, the new ring row written (the picks, the plan, the
    generations and the popcount's read not counted)."""
    return 4 * n * w * 4


def protocols_path(graph, dg_uni, dg_edge, sched, dev):
    """The slice's main path: the random-partner protocols at full size on
    the phase-5 graph and schedule (one 8,192-share chunk, 64 rounds).
    Warm runs of all four first; then every launch count is zeroed, the
    four timed runs go, and the counts are read. Every run is held
    against its warm run and its plain run (counters and coverage rows).
    Returns the launches, each run's ms/round and rate by label, and each
    run's (stats, coverage) by kind ("pushpull", "pull", "pushk",
    "coverage": phase 15's single-device references)."""
    import torch

    import p2p_gossip_tpu_torch as pt
    from p2p_gossip_tpu_torch.models.protocols import run_pushk_sim, run_pushpull_sim
    from p2p_gossip_tpu_torch.ops import kernels

    origins = np.random.default_rng(SEED + 1).integers(0, graph.n, COVERAGE_ORIGINS)
    cov_sched = pt.Schedule(graph.n, origins, np.zeros(COVERAGE_ORIGINS, dtype=np.int32))
    runs = (
        ("push-pull, log-normal per-edge delays (D=6)", run_pushpull_sim, sched,
         dict(device_graph=dg_edge, mode="pushpull", chunk_size=CHUNK)),
        ("pull, uniform delay", run_pushpull_sim, sched,
         dict(device_graph=dg_uni, mode="pull", chunk_size=CHUNK)),
        ("fanout push k=2, uniform delay", run_pushk_sim, sched,
         dict(device_graph=dg_uni, fanout=2, chunk_size=CHUNK)),
        (f"push-pull coverage, {COVERAGE_ORIGINS} origins, D=6", run_pushpull_sim,
         cov_sched, dict(device_graph=dg_edge, mode="pushpull", record_coverage=True)),
    )

    def drive(fn, sch, kw, **extra):
        return fn(graph, sch, HORIZON, seed=SEED, device=dev, **kw, **extra)

    warm = [drive(fn, sch, kw) for _, fn, sch, kw in runs]
    torch.cuda.synchronize()
    kernels.reset_launches()
    timed = []
    for _, fn, sch, kw in runs:
        t0 = time.perf_counter()
        out = drive(fn, sch, kw)
        timed.append((out, time.perf_counter() - t0))
    launches = dict(kernels.launches)
    log(f"protocols-path kernel launches (4 timed runs): {launches}")
    for name in PROTOCOL_KERNELS:
        if launches[name] == 0:
            raise AssertionError(f"kernel {name} never launched on the protocols path")
    rounds = len(runs) * HORIZON
    if launches["scatter_or"] != rounds:
        raise AssertionError(f"scatter_or launched {launches['scatter_or']} times in "
                             f"{rounds} rounds: the round is one call")
    for name in ("gather_or", "sector_occupancy"):
        if launches[name]:
            raise AssertionError(f"{name} launched on the protocols path")
    if launches["tick_digest"]:
        raise AssertionError("tick_digest launched on the protocols path with telemetry off")

    plain_walls = []
    for (label, fn, sch, kw), ((stats, cov), _) in zip(runs, timed):
        t0 = time.perf_counter()
        pstats, pcov = drive(fn, sch, kw, plain=True)
        plain_walls.append(time.perf_counter() - t0)
        if not stats.equal_counts(pstats) or (cov is not None
                                              and not np.array_equal(cov, pcov)):
            raise AssertionError(f"{label}: kernel and plain runs differ")
    w = CHUNK // 32
    results = {}
    refs = dict(zip(("pushpull", "pull", "pushk", "coverage"), warm))
    for (label, _, sch, kw), (wstats, wcov), ((stats, cov), wall), plain_wall in zip(
            runs, warm, timed, plain_walls):
        if not stats.equal_counts(wstats) or (cov is not None and not np.array_equal(cov, wcov)):
            raise AssertionError(f"{label}: timed run differs from the warm run")
        totals = stats.totals()
        if totals["processed"] <= sch.num_shares or totals["sent"] <= 0:
            raise AssertionError(f"{label}: nothing spread ({totals})")
        rate = totals["processed"] / wall
        round_ms = wall / HORIZON * 1e3
        extra = ""
        if cov is not None:
            if not ((np.diff(cov, axis=0) >= 0).all() and (cov[0] >= 1).all()
                    and cov.max() <= graph.n):
                raise AssertionError(f"{label}: bad coverage rows")
            extra = (f"; final coverage mean {cov[-1].mean():.1f} of {graph.n}, "
                     f"shares at N {int((cov[-1] == graph.n).sum())} of {cov.shape[1]}")
        elif label.startswith("push-pull"):
            floor = bound_ms(pushpull_floor_bytes(graph.n, w))
            extra = (f"; floor {floor:.4f} ms/round "
                     f"({pushpull_floor_bytes(graph.n, w) / 1e9:.3f} GB), achieved "
                     f"{floor / round_ms:.4f} of it")
        log(f"protocol[{label}]: {HORIZON} rounds wall={wall:.4f} s -> {rate:.4e} "
            f"node-updates/s, {round_ms:.3f} ms/round; processed {totals['processed']}"
            f" of {sch.num_shares * graph.n}, sent {totals['sent']}{extra}; kernel == "
            f"warm == plain (plain run {plain_wall:.2f} s)")
        results[label] = dict(round_ms=round_ms, rate=rate)
    results.update({kind: results[label] for kind, (label, *_) in zip(refs, runs)})

    def run():
        drive(runs[0][1], runs[0][2], runs[0][3])
        return HORIZON

    profile_device("push-pull", run, top=40)  # every kernel, the plan's sort among them
    return launches, results, refs


# --- phase 10 -----------------------------------------------------------------

def digest_bytes(n: int, w: int, hi: bool) -> int:
    """What the digest must read: every word of ``seen`` and each 32-bit
    counter once (the slot's 4 bytes aside)."""
    return n * w * 4 + 8 * n + (4 * n if hi else 0)


def digest_inputs(rng, n, w, dev, *, hi=False, zero_share=0.0):
    """Random words and counters (every bit in play, bit 31 included), a
    ``zero_share`` of them zero (the sparse fold's skips)."""
    import torch

    def sparse(shape):
        x = random_words(rng, shape, dev)
        if zero_share:
            x = torch.where(torch.as_tensor(rng.random(shape) < zero_share, device=dev), 0, x)
        return x

    return sparse((n, w)), sparse((n,)), sparse((n,)), sparse((n,)) if hi else None


def digest_pair(seen, received, sent, sent_hi=None, slot=0):
    """(kernel, plain) digests as uint32 ints; the kernel XORs into a slot
    that holds ``slot`` first."""
    import torch

    from p2p_gossip_tpu_torch.ops import kernels

    out = torch.full((1,), slot - (1 << 32) if slot >= 1 << 31 else slot,
                     dtype=torch.int32, device=seen.device)
    got = int(kernels.tick_digest(seen, received, sent, sent_hi, out=out)[0]) & U32
    want = int(kernels.tick_digest_plain(seen, received, sent, sent_hi)) ^ slot
    return got, want


def check_digest_ragged(dev, rng):
    """tick_digest against its plain version on ragged shapes: W = 1, 3 and
    5 (32-bit loads) and 4 and 8 (16-byte loads), N off the 8-row block and
    past the grid's stride (1,056 blocks of 8 warps), with and without
    sent_hi, 30% zero words and counters (the sparse fold); a column slice
    (row stride 7 > W = 5) and one from an unaligned base; a slot that
    holds bits already; an all-zero state (digest 0)."""
    import torch

    cases = 0
    for n, w in ((1, 1), (13, 3), (1237, 5), (4099, 1), (9, 8), (20_011, 4),
                 (140_001, 3), (100_003, 8)):
        for hi in (False, True):
            state = digest_inputs(rng, n, w, dev, hi=hi, zero_share=0.3)
            got, want = digest_pair(*state)
            if got != want:
                raise AssertionError(f"tick_digest({n}, {w}, hi={hi}): {got:08x} != {want:08x}")
            cases += 1
    wide = random_words(rng, (3001, 7), dev)
    seen, received, sent, hi = digest_inputs(rng, 3001, 7, dev, hi=True)
    for label, words in (("column slice", wide[:, :5]), ("unaligned slice", wide[:, 1:6])):
        got, want = digest_pair(words, received, sent, hi)
        if got != want:
            raise AssertionError(f"tick_digest[{label}]: {got:08x} != {want:08x}")
        cases += 1
    got, want = digest_pair(seen, received, sent, hi, slot=0x9E3779B9)
    if got != want:
        raise AssertionError("tick_digest into a nonzero slot differs")
    zero = torch.zeros((5000, 4), dtype=torch.int32, device=dev)
    zc = torch.zeros((5000,), dtype=torch.int32, device=dev)
    if digest_pair(zero, zc, zc, zc) != (0, 0):
        raise AssertionError("tick_digest of an all-zero state is not 0")
    log(f"tick_digest ragged: {cases + 2} cases bitwise equal to the plain version "
        "(W = 1, 3, 5 / 4, 8; N up to 140,001; with and without sent_hi; column slices; "
        "a nonzero slot; the all-zero state digests to 0)")


def check_digest(dg, sched, dev, rng, reps):
    """tick_digest at the main path's shape (N = 100,000, W = 256): on dense
    random words (the flood's lo-only fold, and with sent_hi as the
    protocols fold), and on the phase-5 flood's own state after tick
    CAPTURE_TICK. Each against its plain version, bitwise, timed beside its
    bound (`digest_bytes` at 3.35 TB/s: the fold reads every word, zero or
    not)."""
    from p2p_gossip_tpu_torch.ops import kernels

    n, w = N_NODES, CHUNK // 32
    seen, _, _, received, sent, _ = capture_state(dg, sched, CHUNK, CAPTURE_TICK, dev)
    dense = digest_inputs(rng, n, w, dev, hi=True)
    results = {}
    for label, state in (("dense", dense[:3] + (None,)), ("dense_sent_hi", dense),
                         ("captured", (seen, received, sent, None))):
        got, want = digest_pair(*state)
        if got != want:
            raise AssertionError(f"tick_digest[{label}]: {got:08x} != {want:08x}")
        slot = state[0].new_zeros((1,))
        ms = time_ms(lambda: kernels.tick_digest(*state, out=slot), reps, calls=KERNEL_CALLS)
        plain_ms = time_ms(lambda: kernels.tick_digest_plain(*state), max(2, reps // 4))
        bound = bound_ms(digest_bytes(n, w, state[3] is not None))
        nonzero = set_bits(state[0] != 0) / (n * w)
        results[label] = dict(max_abs_err=0, ms=ms, plain_ms=plain_ms, bound_ms=bound)
        log(f"tick_digest[{label}] ({n}, {w}), {nonzero:.4f} of words nonzero: bitwise "
            f"equal; kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bound:.4f} ms "
            f"({digest_bytes(n, w, state[3] is not None) / 1e6:.1f} MB); digest {got:08x}")
    return results


def stream_events(kinds=("ring", "digest")):
    from p2p_gossip_tpu_torch import telemetry

    return [e for e in telemetry.events() if e["type"] in kinds]


def ring_sum(events, kernel, col):
    return sum(sum(e["metrics"][col]) for e in events
               if e["type"] == "ring" and e["kernel"] == kernel)


def check_reconciled(label, events, kernel, stats, frontier=True):
    """The rings' newly_infected sums to the run's received, and (without
    a connect window) frontier_bits to received + generated."""
    received = int(stats.received.sum())
    if ring_sum(events, kernel, "newly_infected") != received:
        raise AssertionError(f"{label}: newly_infected does not sum to received {received}")
    if frontier and ring_sum(events, kernel, "frontier_bits") != (
            received + int(stats.generated.sum())):
        raise AssertionError(f"{label}: frontier_bits does not sum to received + generated")


def timed(run):
    """(run(), host seconds): the clock starts after a synchronize and the
    run ends in its device-to-host copies."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run()
    return out, time.perf_counter() - t0


def in_turns(run_off, run_on):
    """Telemetry off, on, on, off. ``run_off()`` and ``run_on(first)``
    return (result, seconds of the timed call); ``first`` is True for the
    first on run, which also reads its launch counts and events. Returns
    the off and the on results and walls."""
    from p2p_gossip_tpu_torch import telemetry

    results = {False: [], True: []}
    walls = {False: [], True: []}
    for i, on in enumerate((False, True, True, False)):
        telemetry.reset()
        if on:
            telemetry.configure(None, rings=True)
        out, wall = run_on(i == 1) if on else run_off()
        results[on].append(out)
        walls[on].append(wall)
    telemetry.reset()
    return results[False], results[True], walls[False], walls[True]


def telemetry_flood(graph, dg, sched, dev):
    """The phase-5 flood and coverage run with telemetry on, in turns with
    it off. Launch counts are zeroed just before the first telemetry-on
    flood and read after its coverage run."""
    import torch

    from p2p_gossip_tpu_torch import telemetry
    from p2p_gossip_tpu_torch.engine import sync
    from p2p_gossip_tpu_torch.ops import kernels
    from p2p_gossip_tpu_torch.telemetry import rings as tel_rings

    origins = np.random.default_rng(SEED + 1).integers(0, graph.n, COVERAGE_ORIGINS)
    flood = dict(chunk_size=CHUNK, device_graph=dg, device=dev)
    cov_kw = dict(device_graph=dg, device=dev)
    first = {}

    def run_off():
        return timed(lambda: sync.run_sync_sim(graph, sched, HORIZON, **flood))

    def run_on(first_run):
        if first_run:
            torch.cuda.synchronize()
            kernels.reset_launches()
        out = timed(lambda: sync.run_sync_sim(graph, sched, HORIZON, **flood))
        if first_run:
            first["coverage"], first["coverage_wall"] = timed(
                lambda: sync.run_flood_coverage(graph, origins, HORIZON, **cov_kw))
            first["launches"] = dict(kernels.launches)
            first["events"] = stream_events()
        return out

    offs, ons, off_walls, on_walls = in_turns(run_off, run_on)
    base = offs[0]
    for stats in offs[1:] + ons:
        if not (stats.equal_counts(base)
                and stats.extra["ticks_executed"] == base.extra["ticks_executed"]):
            raise AssertionError("telemetry flood: counters differ from the telemetry-off run")
    ticks = base.extra["ticks_executed"]
    events, launches = first["events"], first["launches"]
    cstats, cov = first["coverage"]
    off_cstats, off_cov = sync.run_flood_coverage(graph, origins, HORIZON, **cov_kw)
    if not (cstats.equal_counts(off_cstats) and np.array_equal(cov, off_cov)):
        raise AssertionError("telemetry coverage: results differ from the telemetry-off run")
    check_reconciled("telemetry flood", events, "engine.sync.run_sync_sim", base)
    check_reconciled("telemetry coverage", events, "engine.sync.run_flood_coverage", cstats)
    (flood_digest,) = [e for e in events if e["type"] == "digest"
                       and e["kernel"] == "engine.sync.run_sync_sim"]
    (cov_digest,) = [e for e in events if e["type"] == "digest"
                     and e["kernel"] == "engine.sync.run_flood_coverage"]
    # The coverage run's executed ticks, counted apart from the digests:
    # it launches coverage_per_slot once a tick, the flood never.
    cov_ticks = launches["coverage_per_slot"]
    cov_values = cov_digest["values"]
    if not (all(cov_values[:cov_ticks]) and not any(cov_values[cov_ticks:])):
        raise AssertionError(f"coverage digest stream: not one nonzero digest for each of its "
                             f"{cov_ticks} executed ticks and zero after them")
    if flood_digest["ticks"] != ticks:
        raise AssertionError(f"flood digest stream has {flood_digest['ticks']} ticks, not {ticks}")
    if launches["tick_digest"] != ticks + cov_ticks:
        raise AssertionError(f"tick_digest launched {launches['tick_digest']} times, not once "
                             f"per executed tick ({ticks} + {cov_ticks})")
    for name in FLOOD_KERNELS:
        if launches[name] == 0:
            raise AssertionError(f"kernel {name} never launched on the telemetry path")

    # The chunk's last digest against the plain digest of the state it ends in.
    o, g = sched.padded(CHUNK, HORIZON)
    live = g[g < HORIZON]
    rings = tel_rings.chunk_rings(HORIZON, dg.device)
    seen, received, sent, _, run_ticks = sync._run_chunk_while(
        dg, torch.as_tensor(o.astype(np.int64), device=dev), torch.as_tensor(g, device=dev),
        int(live.min()), int(live.max()), chunk_size=CHUNK, horizon=HORIZON, rings=rings,
    )
    stream = (rings[1].cpu().numpy().astype(np.int64) & U32).tolist()
    t0 = int(live.min())
    if stream[t0:t0 + run_ticks] != flood_digest["values"]:
        raise AssertionError("the chunk's digest ring differs from the emitted stream")
    last = stream[t0 + run_ticks - 1]
    plain_last = int(kernels.tick_digest_plain(seen, received, sent))
    if last != plain_last:
        raise AssertionError(f"last digest {last:08x} != plain digest {plain_last:08x} "
                             "of the final state")
    off_ms = [w / ticks * 1e3 for w in off_walls]
    on_ms = [w / ticks * 1e3 for w in on_walls]
    log(f"telemetry flood: {ticks} ticks, ms/tick off {off_ms[0]:.3f} on {on_ms[0]:.3f} "
        f"on {on_ms[1]:.3f} off {off_ms[1]:.3f} (on/off {np.mean(on_ms) / np.mean(off_ms):.3f}); "
        f"coverage with telemetry {first['coverage_wall']:.4f} s ({cov_ticks} ticks); counters, "
        f"ticks and coverage rows equal to the telemetry-off runs; rings reconcile "
        f"(newly_infected = received, frontier_bits = received + generated); "
        f"tick_digest x{launches['tick_digest']} = {ticks} + {cov_ticks} executed ticks; last "
        f"digest {last:08x} = plain digest of the final state; launches {launches}")
    telemetry.configure(None, rings=True)
    profile_flood(graph, sched, dg, dev, "telemetry-on flood")
    telemetry.reset()
    return launches, dict(tick_ms_off=float(np.mean(off_ms)), tick_ms_on=float(np.mean(on_ms)))


def telemetry_pushpull(graph, dg_edge, sched, dev):
    """Phase 9's push-pull (log-normal per-edge delays, D = 6) with
    telemetry on, in turns with it off; launch counts zeroed just before
    the first telemetry-on run and read after it."""
    import torch

    from p2p_gossip_tpu_torch import telemetry
    from p2p_gossip_tpu_torch.models import protocols
    from p2p_gossip_tpu_torch.models.partnersel import pick_key
    from p2p_gossip_tpu_torch.ops import kernels
    from p2p_gossip_tpu_torch.telemetry import digest
    from p2p_gossip_tpu_torch.telemetry import rings as tel_rings

    kw = dict(device_graph=dg_edge, mode="pushpull", chunk_size=CHUNK, seed=SEED, device=dev)
    first = {}

    def run_off():
        return timed(lambda: protocols.run_pushpull_sim(graph, sched, HORIZON, **kw))

    def run_on(first_run):
        if first_run:
            torch.cuda.synchronize()
            kernels.reset_launches()
        out = timed(lambda: protocols.run_pushpull_sim(graph, sched, HORIZON, **kw))
        if first_run:
            first["launches"] = dict(kernels.launches)
            first["events"] = stream_events()
        return out

    offs, ons, off_walls, on_walls = in_turns(run_off, run_on)
    base = offs[0][0]
    for stats, _ in offs[1:] + ons:
        if not stats.equal_counts(base):
            raise AssertionError("telemetry push-pull: counters differ from the telemetry-off run")
    events, launches = first["events"], first["launches"]
    kernel = "models.protocols.pushpull"
    check_reconciled("telemetry push-pull", events, kernel, base)
    if launches["tick_digest"] != HORIZON:
        raise AssertionError(f"tick_digest launched {launches['tick_digest']} times in "
                             f"{HORIZON} rounds")
    if launches["scatter_or"] != 2 * HORIZON:
        raise AssertionError(f"scatter_or launched {launches['scatter_or']} times in {HORIZON} "
                             "rounds: the round call and msgs_gathered's, once each")
    if launches["gather_or"] or launches["sector_occupancy"]:
        raise AssertionError("the flood's kernels launched on the telemetry push-pull path")
    (dstream,) = [e for e in events if e["type"] == "digest"]

    # The last round's digest against the plain digest of the final state.
    origins, gen_ticks = sched.padded(CHUNK, HORIZON)
    nodes = torch.arange(graph.n, dtype=torch.int64, device=dev)
    key = pick_key(nodes[:, None], torch.zeros((1, 1), dtype=torch.int64, device=dev), SEED)
    rings = tel_rings.chunk_rings(HORIZON, dev)
    received, sent, _, hist = protocols._run_chunk(
        dg_edge, origins, gen_ticks, key, None, None, None, mode="pushpull",
        chunk_size=CHUNK, horizon=HORIZON, n_cov=None, plain=False, rings=rings,
    )
    stream = (rings[1].cpu().numpy().astype(np.int64) & U32).tolist()
    if stream != dstream["values"]:
        raise AssertionError("the chunk's digest ring differs from the emitted stream")
    seen = hist[(HORIZON - 1) % dg_edge.ring_size]
    plain_last = int(kernels.tick_digest_plain(seen, received, *digest.split_u64(sent)))
    if stream[-1] != plain_last:
        raise AssertionError(f"last digest {stream[-1]:08x} != plain digest {plain_last:08x}")
    off_ms = [w / HORIZON * 1e3 for w in off_walls]
    on_ms = [w / HORIZON * 1e3 for w in on_walls]
    log(f"telemetry push-pull (D={dg_edge.ring_size}): {HORIZON} rounds, ms/round off "
        f"{off_ms[0]:.3f} on {on_ms[0]:.3f} on {on_ms[1]:.3f} off {off_ms[1]:.3f} (on/off "
        f"{np.mean(on_ms) / np.mean(off_ms):.3f}); counters equal to the telemetry-off runs; "
        f"rings reconcile; tick_digest x{launches['tick_digest']}, scatter_or "
        f"x{launches['scatter_or']}; last digest {stream[-1]:08x} = plain digest of the "
        f"final state; launches {launches}")

    def run():
        protocols.run_pushpull_sim(graph, sched, HORIZON, **kw)
        return HORIZON

    telemetry.configure(None, rings=True)
    profile_device("telemetry-on push-pull", run, top=25)
    telemetry.reset()
    return launches, dict(round_ms_off=float(np.mean(off_ms)), round_ms_on=float(np.mean(on_ms)))


def check_telemetry_streams(dev):
    """The flood (3 chunks) and the three protocols on ER 2,000 under churn
    and loss p = 0.1, log-normal delays, telemetry on, with the kernels
    and with the plain versions: equal ring and digest streams."""
    import p2p_gossip_tpu_torch as pt
    from p2p_gossip_tpu_torch import telemetry
    from p2p_gossip_tpu_torch.engine.sync import run_sync_sim
    from p2p_gossip_tpu_torch.models.protocols import run_pushk_sim, run_pushpull_sim

    rng = np.random.default_rng(4)
    g = pt.erdos_renyi(2000, 0.01, seed=4)
    delays = pt.lognormal_delays(g, mean_ticks=2.0, sigma=0.5, max_ticks=5, seed=4)
    rounds, horizon = 40, 120
    models = dict(
        churn=pt.random_churn(g.n, horizon, outage_prob=0.2, mean_down_ticks=4.0,
                              max_outages=2, seed=pt.churn_stream_seed(4)),
        loss=pt.LinkLossModel(0.1, seed=pt.loss_stream_seed(4)),
    )
    flood_sched = pt.Schedule(g.n, rng.integers(0, g.n, 700), rng.integers(0, 40, 700))
    proto_sched = pt.Schedule(g.n, rng.integers(0, g.n, 600), rng.integers(0, 16, 600))
    runs = (
        ("flood", lambda **p: run_sync_sim(g, flood_sched, horizon, ell_delays=delays,
                                           chunk_size=256, connect_tick=5, **models, **p)),
        ("pushpull", lambda **p: run_pushpull_sim(g, proto_sched, rounds, ell_delays=delays,
                                                  chunk_size=256, seed=2, mode="pushpull",
                                                  record_coverage=True, **models, **p)),
        ("pull", lambda **p: run_pushpull_sim(g, proto_sched, rounds, ell_delays=delays,
                                              chunk_size=256, seed=2, mode="pull", **models,
                                              **p)),
        ("pushk", lambda **p: run_pushk_sim(g, proto_sched, rounds, fanout=2,
                                            ell_delays=delays, chunk_size=256, seed=2,
                                            **models, **p)),
    )
    for name, run in runs:
        streams = []
        for plain in (False, True):
            telemetry.reset()
            telemetry.configure(None, rings=True)
            run(device=dev, plain=plain)
            streams.append(stream_events())
        telemetry.reset()
        got, want = streams
        digests = [e for e in got if e["type"] == "digest"]
        if not digests or got != want:
            raise AssertionError(f"telemetry[{name}]: kernel and plain streams differ")
        dropped = sum(sum(e["metrics"]["loss_dropped"]) for e in got if e["type"] == "ring")
        log(f"telemetry[{name}] ER 2000 churn + loss 0.1: {len(digests)} chunk streams, "
            f"{sum(e['ticks'] for e in digests)} digests, loss_dropped {dropped}: kernel "
            "streams == plain streams")


# --- phase 11 -----------------------------------------------------------------

def campaign_replicas(graph, shares):
    """Phase 11's gossip and protocol replica set: replica r draws its
    schedule as `flood_schedule` does, from seed r (replica 0 is phase 5's
    schedule): ``shares`` shares at random origins, generation ticks
    uniform over the first GEN_WINDOW ticks."""
    from p2p_gossip_tpu_torch.batch.campaign import ReplicaSet

    seeds = np.arange(CAMPAIGN_REPLICAS, dtype=np.int64) + SEED
    origins, gen_ticks = [], []
    for s in seeds:
        rng = np.random.default_rng(int(s))
        o = rng.integers(0, graph.n, shares).astype(np.int32)
        g = rng.integers(0, GEN_WINDOW, shares).astype(np.int32)
        order = np.argsort(g, kind="stable")  # a Schedule's share order
        origins.append(o[order])
        gen_ticks.append(g[order])
    return ReplicaSet(n=graph.n, origins=np.stack(origins), gen_ticks=np.stack(gen_ticks),
                      seeds=seeds)


def capture_campaign(dg, replicas, chunk, ticks, dev):
    """Run the campaign tick (all replicas of ``replicas`` in one batch,
    no options) for ``ticks`` ticks from t = 0 and return its stacked
    state: the frontier ring, the occupancy ring and the last tick's new
    frontier."""
    from p2p_gossip_tpu_torch.batch.campaign import _Batch
    from p2p_gossip_tpu_torch.engine.sync import _chunk_state, _share_slots, _tick

    b, s = replicas.origins.shape
    pad_o = np.zeros((b, chunk), dtype=np.int32)
    pad_g = np.full((b, chunk), HORIZON, dtype=np.int32)
    pad_o[:, :s], pad_g[:, :s] = replicas.origins, replicas.gen_ticks
    staged = _Batch(dg, pad_o, pad_g, None, None, None)
    rows, gen_ticks = staged.events(dev)
    opts = staged.tick_options()
    slots = _share_slots(chunk, b, dev)
    seen, hist, occ, received, sent = _chunk_state(dg, chunk // 32, b)
    newly = None
    for t in range(ticks):
        newly, _ = _tick(dg, t, seen, hist, occ, received, sent, rows, slots, gen_ticks,
                         False, opts)
    return hist, occ, newly


def check_gather_replicas_ragged(dev, rng):
    """gather_or with a replica axis (B = 3 and 8) on ragged shapes: per-
    edge and uniform slots, W of 3, 5, 64 and 300, caps past one staging
    round, identity and shuffled bucket rows (some outside [0, N)), each
    without loss, with one loss seed (past 2^31) for every replica, and
    with per-replica seeds, without and with an up mask (a fifth of the
    rows down). Against the plain version, and against B solo kernel
    calls on the replicas' own rows with their own seeds. ``out`` starts as
    all ones."""
    import torch

    from p2p_gossip_tpu_torch.ops import kernels

    cases = (  # b, n, cap, w, ring, per_edge
        (3, 1237, 7, 3, 4, True), (3, 513, 9, 64, 2, False), (8, 300, 9, 300, 6, True),
        (8, 129, 129, 8, 2, False), (3, 400, 140, 5, 3, True), (8, 2000, 11, 64, 2, False),
    )
    checked = 0
    for b, n, cap, w, ring, per_edge in cases:
        hist = sparse_words(rng, (ring, b * n, w), dev)
        occ = ring_occupancy(hist)
        idx = torch.as_tensor(rng.integers(0, n, (n, cap)).astype(np.int32), device=dev)
        mask = torch.as_tensor(rng.random((n, cap)) < 0.7, device=dev)
        delay = (torch.as_tensor(rng.integers(1, ring, (n, cap)).astype(np.int32),
                                 device=dev) if per_edge else None)
        slot = None if per_edge else 1
        up = torch.as_tensor(rng.random(b * n) >= 0.2, device=dev)
        seeds_np = rng.integers(0, 2**32, b, dtype=np.uint64).astype(np.uint32)
        seeds = torch.as_tensor(seeds_np.view(np.int32), device=dev)
        shuffled = torch.as_tensor(rng.permutation(n + 6)[:n].astype(np.int32) - 3,
                                   device=dev)
        threshold = int(round(0.3 * 2**32))
        for rows in (None, shuffled):
            for loss in (None, (threshold, 2**31 + 17), (threshold, seeds)):
                for up_arg in (None, up):
                    def run(plain, rows=rows, loss=loss, up_arg=up_arg):
                        out = torch.full((b * n, w), -1, dtype=torch.int32, device=dev)
                        return kernels.gather_or(
                            hist, 7, idx, mask, delay, uniform_slot=slot, rows=rows,
                            occ=occ, loss=loss, up=up_arg, out=out, replicas=b,
                            plain=plain)

                    label = (f"gather_or[B={b} n={n} cap={cap} w={w} D={ring} "
                             f"loss={'none' if loss is None else type(loss[1]).__name__} "
                             f"up={up_arg is not None} rows={rows is not None}]")
                    got = run(False)
                    compare(label, got, run(True))
                    for r in range(b):
                        part = slice(r * n, (r + 1) * n)
                        r_loss = loss
                        if loss is not None and isinstance(loss[1], torch.Tensor):
                            r_loss = (threshold, int(seeds_np[r]))
                        solo = torch.full((n, w), -1, dtype=torch.int32, device=dev)
                        kernels.gather_or(
                            hist[:, part].contiguous(), 7, idx, mask, delay,
                            uniform_slot=slot, rows=rows, occ=occ[:, part].contiguous(),
                            loss=r_loss, up=None if up_arg is None else up_arg[part],
                            out=solo)
                        compare(f"{label} replica {r} vs solo call", got[part], solo)
                    checked += 1
    log(f"gather_or with replicas, ragged shapes: {checked} cases (B = 3 and 8; loss "
        "none / one seed / per-replica seeds; up none / 80%; identity and shuffled "
        "rows) bitwise equal to the plain version and to B solo kernel calls")


def gather_replicas_bound_bytes(dg, hist, occ, tick, b, loss=None, up=None):
    """What the B-replica gather of one tick must move on this ring: the
    occupied sectors of each distinct (slot, stacked source row) of a kept
    edge once, its occupancy word, the staged ELL and bucket rows once
    (shared by the replicas), the up mask, the seeds and the output."""
    import torch

    from p2p_gossip_tpu_torch.models.linkloss import drop_mask_torch
    from p2p_gossip_tpu_torch.ops import kernels

    n, w = dg.n, hist.shape[-1]
    sw = kernels.sector_words(w)
    rows_of = hist.shape[1]
    keys, staged, rows_bytes = [], 0, 0
    for rows, idx, mask, delay in dg.buckets:
        if dg.uniform_delay is not None:
            slot = torch.full_like(idx, (tick - dg.uniform_delay) % dg.ring_size,
                                   dtype=torch.int64)
        else:
            slot = torch.remainder(tick - delay.long(), dg.ring_size)
        staged += int(idx.numel())
        rows_bytes += 4 * int(rows.numel())
        for r in range(b):
            keep = mask.clone()
            if loss is not None:
                seed = loss[1][r] if isinstance(loss[1], torch.Tensor) else loss[1]
                keep &= ~drop_mask_torch(idx, rows.long()[:, None], tick, loss[0], seed)
            if up is not None:
                keep &= up[r * n + rows.long()][:, None]
            keys.append((slot * rows_of + r * n + idx.long())[keep])
    distinct = torch.unique(torch.cat(keys))
    per_entry = 5 if dg.uniform_delay is not None else 9
    return (set_bits(occ.reshape(-1)[distinct]) * sw * 4 + distinct.numel() * 4
            + staged * per_entry + rows_bytes + (b * n if up is not None else 0)
            + 4 * b + b * n * w * 4)


def check_campaign_kernels(graph, dg, cov_set, gossip_set, dev, rng, reps):
    """The replica-axis kernels at phase 11's shapes. gather_or (B = 8) on
    the ring the campaign tick itself built by tick CAPTURE_TICK of the
    gossip campaign (b), without options and with the per-replica loss
    coins at p = 0.05 and 10% of the rows down; on the tick-2 ring of the
    coverage campaign (a) (its flood is over by tick ~6, so its tick-10
    ring is empty). coverage_per_slot (B = 8) on dense words (8, 100,000,
    128) and on campaign (a)'s tick-2 frontier. Each bitwise against its
    plain version and timed beside its bound."""
    import torch

    import p2p_gossip_tpu_torch as pt
    from p2p_gossip_tpu_torch.models.seeds import replica_loss_seeds
    from p2p_gossip_tpu_torch.ops import kernels
    from p2p_gossip_tpu_torch.ops.ell import propagate_bucketed

    b = CAMPAIGN_REPLICAS
    out = {}
    loss_model = pt.LinkLossModel(CAMPAIGN_LOSS, seed=0)
    lseeds = np.asarray(replica_loss_seeds(gossip_set.seeds), dtype=np.int64)
    seeds_dev = torch.as_tensor((lseeds & U32).astype(np.uint32).view(np.int32), device=dev)
    for label, rset, chunk, tick in (("gossip tick 10", gossip_set, CHUNK, CAPTURE_TICK),
                                     ("coverage tick 2", cov_set, COVERAGE_ORIGINS, 2)):
        hist, occ, newly = capture_campaign(dg, rset, chunk, tick, dev)
        up = torch.as_tensor(np.random.default_rng(SEED + 2).random(b * graph.n) >= 0.1,
                             device=dev)
        for opt_label, loss, up_arg in (("", None, None),
                                        (" loss + up", (loss_model.threshold, seeds_dev), up)):
            def run(plain, loss=loss, up_arg=up_arg, hist=hist, occ=occ, tick=tick):
                return propagate_bucketed(
                    hist, tick, dg.buckets, n_out=graph.n, ring_size=dg.ring_size,
                    uniform_delay=dg.uniform_delay, occ=occ, loss=loss, up=up_arg,
                    replicas=b, plain=plain)

            name = f"gather_or[B={b} {label}{opt_label}]"
            err = compare(name, run(False), run(True))
            nbytes = gather_replicas_bound_bytes(dg, hist, occ, tick, b, loss, up_arg)
            ms = time_ms(lambda: run(False), reps, calls=KERNEL_CALLS)
            plain_ms = time_ms(lambda: run(True), 2, warmup=1)
            log(f"{name} W={hist.shape[-1]}: bitwise equal; kernel {ms:.4f} ms (all "
                f"{len(dg.buckets)} buckets, one launch each), plain {plain_ms:.3f} ms, "
                f"bound {bound_ms(nbytes):.4f} ms ({nbytes / 1e6:.1f} MB)")
            out[f"gather{opt_label.replace(' + ', '_').replace(' ', '_')}_{label.split()[0]}"] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms(nbytes))
        if label.startswith("coverage"):
            words = newly.view(b, graph.n, -1)[:, :, : COVERAGE_ORIGINS // 32]
            err = compare("coverage_per_slot[B=8 tick-2 frontier]",
                          kernels.coverage_per_slot(words, COVERAGE_ORIGINS),
                          kernels.coverage_per_slot_plain(words, COVERAGE_ORIGINS))
            ms = time_ms(lambda: kernels.coverage_per_slot(words, COVERAGE_ORIGINS), reps,
                         calls=KERNEL_CALLS)
            plain_ms = time_ms(lambda: kernels.coverage_per_slot_plain(words, COVERAGE_ORIGINS),
                               2, warmup=1)
            nbytes = words.numel() * 4 + b * COVERAGE_ORIGINS * 4
            log(f"coverage_per_slot[B=8 tick-2 frontier] {tuple(words.shape)}: bitwise "
                f"equal; kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
                f"{bound_ms(nbytes):.4f} ms")
            out["coverage_frontier"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                            bound_ms=bound_ms(nbytes))
        del hist, occ, newly
    words = random_words(rng, (b, graph.n, COVERAGE_ORIGINS // 32), dev)
    slots = COVERAGE_ORIGINS
    err = compare("coverage_per_slot[B=8 dense]", kernels.coverage_per_slot(words, slots),
                  kernels.coverage_per_slot_plain(words, slots))
    for r in range(b):  # the stacked launch against one solo launch a replica
        compare(f"coverage_per_slot[B=8 dense] replica {r} vs solo call",
                kernels.coverage_per_slot(words, slots)[r],
                kernels.coverage_per_slot(words[r], slots))
    ms = time_ms(lambda: kernels.coverage_per_slot(words, slots), reps, calls=KERNEL_CALLS)
    plain_ms = time_ms(lambda: kernels.coverage_per_slot_plain(words, slots), 2, warmup=1)
    nbytes = words.numel() * 4 + b * slots * 4
    log(f"coverage_per_slot[B=8 dense] {tuple(words.shape)}: bitwise equal (and to 8 solo "
        f"calls); kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
        f"{bound_ms(nbytes):.4f} ms")
    out["coverage_dense"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                 bound_ms=bound_ms(nbytes))
    return out


def check_small_campaigns(dev):
    """Campaigns on small graphs (ER 2,000 p = 0.006, BA 300 with
    log-normal delays), R = 5 in batches of 2 (a padded last batch), plain
    and with churn + per-replica loss: coverage, gossip (several 256-share
    chunks) and the three protocols, each run with the kernels and with
    the plain versions, equal in every counter and coverage row."""
    import p2p_gossip_tpu_torch as pt
    from p2p_gossip_tpu_torch.batch import campaign as bc
    from p2p_gossip_tpu_torch.models.seeds import replica_loss_seeds

    horizon, seeds = 32, list(range(3, 8))
    runs = 0
    for gname, graph, delays in (
        ("ER 2000", pt.erdos_renyi(2000, 0.006, seed=1), None),
        ("BA 300", (ba := pt.barabasi_albert(300, m=2, seed=3)),
         pt.lognormal_delays(ba, 2.0, 0.5, 4, seed=3)),
    ):
        for opts in ("plain", "churn+loss"):
            churn_kw = dict(churn_prob=0.2, mean_down_ticks=3) if opts != "plain" else {}
            loss = pt.LinkLossModel(0.1, seed=5) if opts != "plain" else None
            lseeds = replica_loss_seeds(seeds) if loss is not None else None
            flood = bc.flood_replicas(graph, 40, seeds, horizon, **churn_kw)
            gossip = bc.gossip_replicas(graph, 0.06, 0.005, seeds, horizon, gen_lo=0.03,
                                        gen_hi=0.06, **churn_kw)
            kw = dict(ell_delays=delays, loss=loss, loss_seeds=lseeds, batch_size=2,
                      device=dev)
            drives = (
                ("coverage", lambda p: bc.run_coverage_campaign(graph, flood, horizon,
                                                                plain=p, **kw)),
                ("gossip", lambda p: bc.run_gossip_campaign(graph, gossip, horizon,
                                                            chunk_size=256, plain=p, **kw)),
            ) + tuple(
                (proto, lambda p, proto=proto: bc.run_protocol_campaign(
                    graph, flood, horizon, protocol=proto, fanout=3, plain=p, **kw))
                for proto in ("pushpull", "pull", "pushk")
            )
            for label, drive in drives:
                got, want = drive(False), drive(True)
                for key in ("generated", "received", "sent", "coverage"):
                    a, b = getattr(got, key), getattr(want, key)
                    if (a is None) != (b is None) or (a is not None and not np.array_equal(a, b)):
                        raise AssertionError(f"small campaign {gname} {opts} {label}: "
                                             f"{key} differs between kernel and plain")
                if got.received.sum() <= 0:
                    raise AssertionError(f"small campaign {gname} {opts} {label}: nothing spread")
                runs += 1
    log(f"small campaigns (ER 2000, BA 300 log-normal; R = 5, batch 2; plain and churn + "
        f"per-replica loss; coverage, gossip in 256-share chunks, push-pull, pull, fanout "
        f"push k=3): {runs} campaigns, kernel == plain in every counter and coverage row")


def campaigns_path(graph, dg, dgf_edge, cov_set, gossip_set, dev):
    """Phase 11's main path: (a) the coverage campaign, (b) the gossip
    campaign with per-replica loss, (c) the push-pull campaign, each one
    warm and one timed run with launch counts zeroed just before the timed
    runs and read after them; replicas 0 and 7 of each against the solo
    runs with their seeds; (a) and (c) under torch.profiler; peak device
    memory of each timed run."""
    import torch

    import p2p_gossip_tpu_torch as pt
    from p2p_gossip_tpu_torch.batch import campaign as bc
    from p2p_gossip_tpu_torch.batch.stats import ensemble_summary
    from p2p_gossip_tpu_torch.engine.sync import run_flood_coverage, run_sync_sim
    from p2p_gossip_tpu_torch.models.protocols import run_pushpull_sim
    from p2p_gossip_tpu_torch.models.seeds import replica_loss_seeds
    from p2p_gossip_tpu_torch.ops import kernels

    b = CAMPAIGN_REPLICAS
    lseeds = replica_loss_seeds(gossip_set.seeds)
    loss = pt.LinkLossModel(CAMPAIGN_LOSS, seed=0)
    drives = {
        "coverage": lambda: bc.run_coverage_campaign(
            graph, cov_set, HORIZON, device_graph=dg, device=dev),
        "gossip": lambda: bc.run_gossip_campaign(
            graph, gossip_set, HORIZON, loss=loss, loss_seeds=lseeds, chunk_size=CHUNK,
            device_graph=dg, device=dev),
        "pushpull": lambda: bc.run_protocol_campaign(
            graph, gossip_set, HORIZON, protocol="pushpull", chunk_size=CHUNK,
            device_graph=dgf_edge, device=dev),
    }

    def solo(kind, r):
        sched = gossip_set.replica_schedule(r, HORIZON)
        if kind == "coverage":
            stats, cov = run_flood_coverage(graph, cov_set.origins[r], HORIZON,
                                            device_graph=dg, device=dev)
            return stats, cov
        if kind == "gossip":
            return run_sync_sim(graph, sched, HORIZON, chunk_size=CHUNK, device_graph=dg,
                                loss=pt.LinkLossModel(CAMPAIGN_LOSS, seed=lseeds[r]),
                                device=dev), None
        return run_pushpull_sim(graph, sched, HORIZON, seed=int(gossip_set.seeds[r]),
                                chunk_size=CHUNK, record_coverage=True,
                                device_graph=dgf_edge, device=dev)

    results, all_launches = {}, {}
    for kind, drive in drives.items():
        warm = drive()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        res = drive()
        wall = time.perf_counter() - t0
        launches = dict(kernels.launches)
        peak = torch.cuda.max_memory_allocated()
        all_launches[kind] = launches
        for key in ("received", "sent", "coverage"):
            a, w_ = getattr(res, key), getattr(warm, key)
            if (a is None) != (w_ is None) or (a is not None and not np.array_equal(a, w_)):
                raise AssertionError(f"campaign {kind}: timed run differs from the warm run")
        ticks = HORIZON if kind == "pushpull" else launches["sector_occupancy"]
        if kind == "pushpull":
            if launches["scatter_or"] != HORIZON or launches["gather_or"]:
                raise AssertionError(f"campaign {kind}: scatter_or must launch once a round "
                                     f"for all {b} replicas, gather_or never: {launches}")
        else:
            want_gather = len(dg.buckets) * ticks
            want_cov = ticks if kind == "coverage" else 0
            if (launches["gather_or"] != want_gather or launches["tick_update"] != ticks
                    or launches["coverage_per_slot"] != want_cov or launches["scatter_or"]):
                raise AssertionError(
                    f"campaign {kind}: a tick launches gather_or once per degree bucket "
                    f"({want_gather} in {ticks} ticks), tick_update once and "
                    f"coverage_per_slot {'once' if want_cov else 'never'}: {launches}")
        if launches["tick_digest"]:
            raise AssertionError(f"campaign {kind}: tick_digest launched with telemetry off")
        for r in (0, b - 1):
            stats, cov = solo(kind, r)
            same = (np.array_equal(stats.received, res.received[r])
                    and np.array_equal(stats.sent, res.sent[r])
                    and np.array_equal(stats.generated, res.generated[r]))
            if cov is not None:
                same &= np.array_equal(cov, res.coverage[r])
            if not same:
                raise AssertionError(f"campaign {kind}: replica {r} differs from its solo run")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solo_stats, _ = solo(kind, 0)
        solo_wall = time.perf_counter() - t0
        totals = res.totals_per_replica()
        processed = int(totals["processed"].sum())
        if processed <= int(totals["generated"].sum()):
            raise AssertionError(f"campaign {kind}: nothing spread")
        rate = processed / wall
        solo_rate = solo_stats.totals()["processed"] / solo_wall
        unit = "round" if kind == "pushpull" else "tick"
        summary = ensemble_summary(res)
        ttc = summary.get("ttc") or {}
        log(f"campaign[{kind}] R={b} N={graph.n} S={res.coverage.shape[-1] if res.coverage is not None else gossip_set.shares_per_replica}: "
            f"{ticks} {unit}s, wall {wall:.4f} s -> {wall / ticks * 1e3:.3f} ms/{unit}; "
            f"{rate:.4e} node-updates/s summed over replicas; solo replica 0 "
            f"{solo_wall:.4f} s ({solo_rate:.4e} node-updates/s; R x solo wall "
            f"{b * solo_wall:.4f} s, campaign / (R x solo) {wall / (b * solo_wall):.3f}); "
            f"peak device memory {peak / 2**30:.2f} GiB; replicas 0 and {b - 1} == solo "
            f"runs; ttc reached {ttc.get('reached')}; launches {launches}")
        results[kind] = dict(wall_s=wall, ticks=ticks, ms_per_tick=wall / ticks * 1e3,
                             rate=rate, solo_wall_s=solo_wall, solo_rate=solo_rate,
                             peak_gib=peak / 2**30, campaign=res)

    def run_cov():
        kernels.reset_launches()
        drives["coverage"]()
        return kernels.launches["sector_occupancy"]

    profile_device("coverage campaign (a)", run_cov)

    def run_pp():
        drives["pushpull"]()
        return HORIZON

    profile_device("push-pull campaign (c)", run_pp, top=20)
    return all_launches, results


# --- phase 12 -----------------------------------------------------------------

class PeakRss:
    """Peak resident set of this process while the ``with`` block runs: a
    thread samples /proc/self/statm every 5 ms (the chip machine's /proc
    has no VmHWM). Where statm is missing, the process's lifetime peak
    (``getrusage``) stands in, and ``scope`` says so."""

    def __init__(self):
        import threading

        self.peak, self.scope = 0, "while staging"
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)

    @staticmethod
    def _rss():
        with open("/proc/self/statm", encoding="ascii") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")

    def _sample(self):
        while not self._stop.wait(0.005):
            self.peak = max(self.peak, self._rss())

    def __enter__(self):
        try:
            self.peak = self._rss()
        except OSError:
            self._thread = None
        if self._thread is not None:
            self._thread.start()
        return self

    def __exit__(self, *exc):
        if self._thread is None:
            import resource

            self.peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
            self.scope = "process lifetime"
            return False
        self._stop.set()
        self._thread.join(timeout=5)
        self.peak = max(self.peak, self._rss())
        return False


def scale_graph(topology, nodes, prob, cache_dir):
    """Build a SCALE_CONFIGS graph with the port's C++ builder, save it to an
    npz cache, reload it and require the same CSR; returns the graph and the
    timings. The cache file is removed afterwards (chiprun_out/ must stay
    small)."""
    from p2p_gossip_tpu_torch.models.topology import (
        load_graph_cache,
        load_or_build_graph_cache,
        scale_graph_fingerprint,
    )
    from p2p_gossip_tpu_torch.runtime import native

    os.makedirs(cache_dir, exist_ok=True)
    cache = os.path.join(cache_dir, f"{topology}_{nodes}.npz")
    if os.path.exists(cache):
        os.remove(cache)
    timing = {}

    def build():
        t0 = time.perf_counter()
        if topology == "ba":
            g = native.native_barabasi_albert(nodes, m=SCALE_BA_M, seed=SEED)
        else:
            g = native.native_erdos_renyi(nodes, prob, seed=SEED)
        timing["build_s"] = time.perf_counter() - t0
        return g

    try:
        t0 = time.perf_counter()
        graph = load_or_build_graph_cache(
            cache, topology=topology, nodes=nodes, prob=prob, ba_m=SCALE_BA_M, seed=SEED,
            build=build, log=log,
        )
        timing["save_s"] = time.perf_counter() - t0 - timing["build_s"]
        timing["cache_bytes"] = os.path.getsize(cache)
        t0 = time.perf_counter()
        loaded, fp = load_graph_cache(cache)
        timing["load_s"] = time.perf_counter() - t0
    finally:
        if os.path.exists(cache):
            os.remove(cache)
    if fp != scale_graph_fingerprint(topology, nodes, prob, SCALE_BA_M, SEED):
        raise AssertionError(f"{topology} cache: fingerprint {fp!r} is not the build's")
    if not (loaded.n == graph.n and np.array_equal(loaded.indptr, graph.indptr)
            and np.array_equal(loaded.indices, graph.indices)):
        raise AssertionError(f"{topology} cache: the reloaded CSR differs from the built one")
    if graph.indptr.dtype != np.int64 or graph.indices.dtype != np.int32:
        raise AssertionError("native CSR must be int64 indptr, int32 indices")
    del loaded
    log(f"scale[{topology}] graph: N={graph.n} edges={graph.num_edges} "
        f"dmax={graph.max_degree}; native build {timing['build_s']:.2f} s, cache save "
        f"{timing['save_s']:.2f} s ({timing['cache_bytes'] / 1e6:.1f} MB), load "
        f"{timing['load_s']:.2f} s, reloaded CSR equal")
    return graph, timing


def scale_kernels(dg, origins, dev, reps, hook=None):
    """The four flood kernels on the state the engine's own tick built by
    SCALE_CAPTURE_TICK of the million-node coverage run: each held against
    its plain version on the first SCALE_SUBSET_ROWS rows (of every degree
    bucket, for gather_or; the plain versions do not scale to 10^6 rows)
    and timed on the whole state beside its bound."""
    import torch

    import p2p_gossip_tpu_torch as pt
    from p2p_gossip_tpu_torch.ops import kernels
    from p2p_gossip_tpu_torch.ops.ell import propagate_bucketed

    n, w, tick = dg.n, SCALE_ORIGINS // 32, SCALE_CAPTURE_TICK
    sched = pt.Schedule(n, origins, np.zeros(len(origins), dtype=np.int32))
    _, hist, occ, _, _, newly = capture_state(dg, sched, SCALE_ORIGINS, tick, dev)
    sw = kernels.sector_words(w)
    slot = (tick - dg.uniform_delay) % dg.ring_size
    k = SCALE_SUBSET_ROWS
    err = 0
    for bi, (rows, idx, mask, _) in enumerate(dg.buckets):
        got = torch.zeros((n, w), dtype=torch.int32, device=dev)
        want = torch.zeros_like(got)
        for out, plain in ((got, False), (want, True)):
            kernels.gather_or(hist, tick, idx[:k], mask[:k], uniform_slot=slot,
                              rows=rows[:k], occ=occ, out=out, plain=plain)
        sub = rows[:k].long()
        err = max(err, compare(f"gather_or[bucket {bi} rows :{k}]", got[sub], want[sub]))
    del got, want

    def gather():
        return propagate_bucketed(hist, tick, dg.buckets, n_out=n, ring_size=dg.ring_size,
                                  uniform_delay=dg.uniform_delay, occ=occ)

    keys, staged, rows_bytes = [], 0, 0
    for rows, idx, mask, _ in dg.buckets:
        keys.append((slot * n + idx.long())[mask])
        staged += int(idx.numel())
        rows_bytes += 4 * int(rows.numel())
    distinct = torch.unique(torch.cat(keys))
    del keys
    sectors = set_bits(occ.reshape(-1)[distinct])
    gather_bytes = sectors * sw * 4 + distinct.numel() * 4 + staged * 5 + rows_bytes + n * w * 4
    del distinct
    out = {"gather_or": dict(
        max_abs_err=err, ms=time_ms(gather, reps, calls=KERNEL_CALLS),
        plain_ms=time_ms(lambda: [kernels.gather_or(
            hist, tick, idx[:k], mask[:k], uniform_slot=slot, rows=rows[:k], occ=occ,
            out=torch.zeros((n, w), dtype=torch.int32, device=dev), plain=True)
            for rows, idx, mask, _ in dg.buckets], 2, warmup=1),
        bound_ms=bound_ms(gather_bytes))}
    frontier = newly  # the tick-(SCALE_CAPTURE_TICK - 1) slot
    part = frontier[:k]
    for name, fn, plain_fn, nbytes in (
        ("sector_occupancy", kernels.sector_occupancy, kernels.sector_occupancy_plain,
         n * w * 4 + n * 4),
        ("popcount_rows", kernels.popcount_rows, kernels.popcount_rows_plain,
         n * w * 4 + n * 4),
        ("coverage_per_slot", lambda x: kernels.coverage_per_slot(x, SCALE_ORIGINS),
         lambda x: kernels.coverage_per_slot_plain(x, SCALE_ORIGINS),
         n * w * 4 + SCALE_ORIGINS * 4),
    ):
        e = compare(f"{name}[rows :{k}]", fn(part), plain_fn(part))
        out[name] = dict(max_abs_err=e, ms=time_ms(lambda: fn(frontier), reps,
                                                    calls=KERNEL_CALLS),
                         plain_ms=time_ms(lambda: plain_fn(part), 2, warmup=1),
                         bound_ms=bound_ms(nbytes))
    if hook is not None:
        hook(frontier)
    occ_bits = set_bits(occ[(tick - 1) % dg.ring_size])
    log(f"scale kernels on the tick-{tick} state (N={n}, W={w}, {len(dg.buckets)} "
        f"buckets, {occ_bits} occupied sectors in the newest slot): every kernel == plain "
        f"on the first {k} rows (gather_or on each bucket's); on the whole state: "
        + "; ".join(f"{name} {m['ms']:.4f} ms (bound {m['bound_ms']:.4f}, plain on "
                    f"{k} rows {m['plain_ms']:.3f})" for name, m in out.items()))
    del hist, occ, newly, frontier, part
    torch.cuda.empty_cache()
    return out


def scale_path(topology, nodes, prob, dev, cache_dir, graph=None, hook=None):
    """Phase 12 on one SCALE_CONFIGS graph: build, cache and reload it,
    stage it (time, peak host RSS, buckets), flood SCALE_ORIGINS shares
    from t = 0 (one warm, one timed run with launch counts and peak device
    memory against the resident-memory model), then the kernels on the
    tick-3 state (`scale_kernels`). A ``graph`` given (the north star's,
    loaded from its cache) skips the build and cache steps. ``hook(graph,
    dg, origins, stats, coverage, frontier)`` (phase 14's) sees the graph,
    its staging, the timed flood's results and the state's newest frontier
    slot."""
    import torch

    from p2p_gossip_tpu_torch.engine.sync import (
        DeviceGraph,
        flood_resident_hbm_bytes,
        run_flood_coverage,
        time_to_coverage,
    )
    from p2p_gossip_tpu_torch.ops import kernels

    timing = {}
    if graph is None:
        graph, timing = scale_graph(topology, nodes, prob, cache_dir)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    with PeakRss() as host:
        dg = DeviceGraph.build(graph, device=dev)
        torch.cuda.synchronize()
    stage_s = time.perf_counter() - t0
    rss = host.peak
    staged_entries = sum(int(b[1].numel()) for b in dg.buckets)
    log(f"scale[{topology}] staging: {stage_s:.2f} s, {len(dg.buckets)} degree buckets, "
        f"{staged_entries} staged ELL entries (caps "
        f"{[int(b[1].shape[1]) for b in dg.buckets]}), peak host RSS "
        f"{rss / 2**30:.2f} GiB ({host.scope})")

    origins = np.random.default_rng(SEED).integers(0, graph.n, SCALE_ORIGINS).astype(np.int32)
    t0 = time.perf_counter()
    warm, warm_cov = run_flood_coverage(graph, origins, HORIZON, device_graph=dg, device=dev)
    warm_wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    stats, cov = run_flood_coverage(graph, origins, HORIZON, device_graph=dg, device=dev)
    wall = time.perf_counter() - t0
    launches = dict(kernels.launches)
    model = flood_resident_hbm_bytes(graph.degree, SCALE_ORIGINS // 32,
                                     ring_size=dg.ring_size)
    peak = torch.cuda.max_memory_allocated() - base
    processed = stats.totals()["processed"]
    if processed != SCALE_ORIGINS * graph.n:
        raise AssertionError(f"scale[{topology}]: processed {processed}, not full coverage")
    if not (np.array_equal(cov, warm_cov) and stats.equal_counts(warm)):
        raise AssertionError(f"scale[{topology}]: timed run differs from the warm run")
    stats.check_conservation()
    ticks = launches["coverage_per_slot"]
    want = dict(dict.fromkeys(LOSS_FREE_LAUNCHES, 0), gather_or=len(dg.buckets) * ticks,
                sector_occupancy=ticks, tick_update=ticks, coverage_per_slot=ticks)
    if ticks == 0 or launches != want:
        raise AssertionError(f"scale[{topology}]: launches {launches}, want {want} (gather_or "
                             "once per degree bucket per tick)")
    ttc = time_to_coverage(cov, graph.n, 0.99)
    log(f"scale[{topology}] flood: {SCALE_ORIGINS} origins, {ticks} ticks, warm "
        f"{warm_wall:.3f} s, timed {wall:.4f} s -> {wall / ticks * 1e3:.2f} ms/tick, "
        f"{processed / wall:.4e} node-updates/s; full coverage, conservation holds; "
        f"ttc99 median {float(np.median(ttc))} / max {int(ttc.max())} ticks; peak device "
        f"memory {peak / 1e9:.3f} GB vs modeled {model / 1e9:.3f} GB "
        f"(measured / model {peak / model:.3f}); launches {launches} "
        f"({len(dg.buckets)} gather_or launches a tick)")
    if abs(peak - model) > MEMORY_TOLERANCE * model:
        raise AssertionError(f"scale[{topology}]: peak device memory {peak} is not within "
                             f"{MEMORY_TOLERANCE:.0%} of the model's {model}")
    kernels_1m = scale_kernels(
        dg, origins, dev, reps=5,
        hook=None if hook is None else (lambda f: hook(graph, dg, origins, stats, cov, f)))
    result = dict(timing, stage_s=stage_s, rss_peak=rss, buckets=len(dg.buckets),
                  ticks=ticks, wall_s=wall, ms_per_tick=wall / ticks * 1e3,
                  rate=processed / wall, peak_bytes=peak, model_bytes=model,
                  ttc99_median=float(np.median(ttc)), ttc99_max=int(ttc.max()),
                  launches=launches, kernels=kernels_1m)
    del dg
    torch.cuda.empty_cache()
    return result


def check_scale_cli(dev, cache_dir):
    """Phase 12 (d): the CLI's C++ builder and graph file on the card (a cold
    and a warm run, each the CPU run's report), and the event and native
    backends at the reference defaults (the card run's counters)."""
    import contextlib
    import io

    from p2p_gossip_tpu_torch.utils import cli

    def report(args):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.run(args)
        if rc != 0:
            raise AssertionError(f"CLI {args} exited {rc}")
        return buf.getvalue().splitlines()

    path = os.path.join(cache_dir, "cli_graph.npz")
    args = ["--numNodes", "2000", "--connectionProb", "0.004", "--simTime", "2",
            "--graphBuilder", "native", "--graphFile", path]
    try:
        if os.path.exists(path):
            os.remove(path)
        cold = report(args + ["--device", str(dev)])
        warm = report(args + ["--device", str(dev)])
        cpu = report(args + ["--device", "cpu"])
    finally:
        if os.path.exists(path):
            os.remove(path)
    if not (cold[0].endswith("graph-builder=native") and warm[0].endswith("graph-builder=cache")
            and cpu[0].endswith("graph-builder=cache")):
        raise AssertionError("CLI --graphFile: cold run must build natively, warm runs load")
    if not (cold[1:-1] == warm[1:-1] == cpu[1:-1]):
        raise AssertionError("CLI --graphBuilder native --graphFile: reports differ")
    card = report(["--device", str(dev)])
    for backend in ("event", "native"):
        host = report(["--backend", backend])
        if host[1:-1] != card[1:-1] or f"backend={backend}" not in host[0]:
            raise AssertionError(f"CLI --backend {backend}: counters differ from the card's")
    log("cli[phase 12] --graphBuilder native --graphFile (N=2000): cold (built) and warm "
        "(loaded) runs on the card print the CPU run's report; --backend event and "
        "--backend native at the reference defaults print the card run's counters")


def scale_phase(dev):
    """Phase 12: the native library, BA and ER at a million nodes, the CLI."""
    from p2p_gossip_tpu_torch.runtime import native

    path, build_s = native.build()
    native.load_library()
    log(f"native library built in {build_s:.2f} s -> {path}")
    cache_dir = os.path.join("chiprun_out", "phase12")
    results = {}
    kept = {}

    def keep_ba(graph, dg, origins, stats, cov, frontier):
        # Phase 14: the exchange kernels on a 4-shard split of this state,
        # and this graph and flood for the sharded engine.
        kept.update(graph=graph, origins=origins, stats=stats, coverage=cov,
                    **ba_exchange(graph, dg, origins, frontier, dev))

    for topology, nodes, prob in SCALE_CONFIGS:
        results[topology] = scale_path(topology, nodes, prob, dev, cache_dir,
                                       hook=keep_ba if topology == "ba" else None)
    kept["ms_per_tick"] = results["ba"]["ms_per_tick"]
    check_scale_cli(dev, cache_dir)
    results["native_build_s"] = build_s
    return results, kept


def north_star(cache: str, dev) -> None:
    """``python3 chip_smoke.py --north-star CACHE``: phase 12's staging,
    flood, memory check and kernel timings on the north-star graph (ER N =
    1,000,000, p = 0.001, BASELINE.json config 3) loaded from the npz
    cache ``python -m p2p_gossip_tpu_torch.scale --cache CACHE`` wrote."""
    from p2p_gossip_tpu_torch.models.topology import (
        load_graph_cache,
        scale_graph_fingerprint,
    )

    t0 = time.perf_counter()
    graph, fp = load_graph_cache(cache)
    if fp != scale_graph_fingerprint("er", 1_000_000, 0.001, SCALE_BA_M, SEED):
        raise AssertionError(f"{cache} is not the north star's graph")
    log(f"north star: N={graph.n} edges={graph.num_edges} dmax={graph.max_degree}, "
        f"loaded in {time.perf_counter() - t0:.1f} s")
    result = scale_path("er", graph.n, 0.001, dev, "", graph=graph)
    print(json.dumps({"north_star": {k: v for k, v in result.items()}}))


# --- phase 13 -----------------------------------------------------------------

def check_digest_batched_ragged(dev, rng):
    """tick_digest with its replica axis against its plain version (the
    per-replica fold) and against B calls of the solo kernel on each
    replica's rows, on ragged shapes: B = 1, 3, 8; N off the 8-row block;
    W odd (32-bit loads) and W = 4, 8 (16-byte loads); with and without
    sent_hi; a row stride above W and a view 4 bytes off 16-byte alignment;
    the slots a column of a (B, 5) ring (stride 5). At B = 1 the call is
    today's solo call."""
    import torch

    from p2p_gossip_tpu_torch.ops import kernels

    cases = 0
    for b in (1, 3, 8):
        for n, w in ((13, 3), (1237, 5), (4099, 1), (9, 8), (20_011, 4), (999, 7)):
            for hi in (False, True):
                wide = random_words(rng, (b * n, w + 4), dev)
                views = [("dense", wide[:, :w].contiguous())]
                if w in (4, 8):
                    views += [("stride", wide[:, :w]), ("unaligned", wide[:, 1:1 + w])]
                _, received, sent, sent_hi = digest_inputs(rng, b * n, 1, dev, hi=hi,
                                                           zero_share=0.3)
                for label, seen in views:
                    ring = torch.zeros((b, 5), dtype=torch.int32, device=dev)
                    kernels.tick_digest(seen, received, sent, sent_hi, out=ring[:, 2],
                                        replicas=b)
                    got = [v & U32 for v in ring[:, 2].tolist()]
                    want = kernels.tick_digest_plain(seen, received, sent, sent_hi,
                                                     replicas=b).tolist()
                    solo = []
                    for r in range(b):
                        part = slice(r * n, (r + 1) * n)
                        one = kernels.tick_digest(seen[part], received[part], sent[part],
                                                  None if sent_hi is None else sent_hi[part])
                        solo.append(int(one[0]) & U32)
                    if got != want or got != solo or ring[:, [0, 1, 3, 4]].any():
                        raise AssertionError(
                            f"tick_digest(B={b}, N={n}, W={w}, hi={hi}, {label}): kernel "
                            f"{got} != plain {want} / solo {solo}")
                    cases += 1
    log(f"tick_digest replica axis ragged: {cases} cases bitwise equal to the per-replica "
        "plain fold and to B solo calls (B = 1, 3, 8; N up to 20,011 a replica; W = 1, 3, "
        "5, 7 / 4, 8; sent_hi; row stride > W, a view off 16-byte alignment; the slots a "
        "strided ring column)")


def check_digest_batched(dev, rng, reps):
    """The batched tick_digest at B = DIGEST_REPLICAS replicas of N_NODES
    rows, W = 128 (4,096 shares: the server's flood) and 256 (the flood
    chunk): bitwise against its plain version, timed beside its bound
    B * `digest_bytes` at 3.35 TB/s, and one launch for the B replicas."""
    import torch

    from p2p_gossip_tpu_torch.ops import kernels

    b, n = DIGEST_REPLICAS, N_NODES
    results = {}
    for w in (128, 256):
        seen, received, sent, _ = digest_inputs(rng, b * n, w, dev)
        out = torch.zeros((b,), dtype=torch.int32, device=dev)
        kernels.reset_launches()
        kernels.tick_digest(seen, received, sent, out=out, replicas=b)
        launched = kernels.launches["tick_digest"]
        got = [v & U32 for v in out.tolist()]
        want = kernels.tick_digest_plain(seen, received, sent, replicas=b).tolist()
        if got != want or launched != 1:
            raise AssertionError(f"tick_digest(B={b}, W={w}): {got} != {want} "
                                 f"or {launched} launches")
        ms = time_ms(lambda: kernels.tick_digest(seen, received, sent, out=out, replicas=b),
                     reps, calls=KERNEL_CALLS)
        plain_ms = time_ms(lambda: kernels.tick_digest_plain(seen, received, sent,
                                                             replicas=b), 2)
        nbytes = b * digest_bytes(n, w, False)
        bound = bound_ms(nbytes)
        results[w] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound)
        log(f"tick_digest[B={b}] ({b} x {n}, {w}): bitwise equal, one launch; kernel "
            f"{ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bound:.4f} ms "
            f"({nbytes / 1e6:.1f} MB; bound / kernel {bound / ms:.3f})")
        del seen, received, sent
    return results


def serve_trace(nodes=None, requests=None, shares=None, horizon=None):
    """``serve.bench``'s mixed trace (ER p = 0.001 at N = 100,000 and BA
    m = 3; flood, push-pull, pull, fanout push with k = 2, a lossy and a
    churn flood; replica counts cycling 1/2/4) from seed SEED; by default
    N_NODES nodes, SERVE_REQUESTS requests, SERVE_SHARES shares, horizon
    HORIZON."""
    from p2p_gossip_tpu_torch.serve import bench

    return bench.build_trace(requests or SERVE_REQUESTS, SEED, nodes or N_NODES,
                             shares or SERVE_SHARES, horizon or HORIZON)


def serve_graphs(graph, trace):
    """Topology fingerprint -> host Graph for every topology of ``trace``:
    the phase-5 graph where the trace names it (ER N = 100,000, p = 0.001,
    seed 0 builds the same graph), the others built here, so the server's
    graph cache starts full and no build falls inside a timed drain."""
    from p2p_gossip_tpu_torch.serve.request import build_graph, topology_fingerprint

    phase5 = {"family": "erdos_renyi", "n": graph.n, "p": EDGE_P, "seed": SEED}
    graphs = {}
    for d in trace:
        fp = topology_fingerprint(d["topology"])
        if fp not in graphs:
            graphs[fp] = graph if d["topology"] == phase5 else build_graph(d["topology"])
    return graphs


def trace_graph(graphs, d):
    from p2p_gossip_tpu_torch.serve.request import topology_fingerprint

    return graphs[topology_fingerprint(d["topology"])]


def serve_request(trace, protocol, seeds, rid, **extra):
    """A request of ``protocol`` on the trace's first topology, with the
    trace's shares and horizon and ``seeds``."""
    base = next(d for d in trace if d["protocol"] == protocol and "loss_prob" not in d
                and "churn_prob" not in d)
    return dict(base, request_id=rid, seeds=list(seeds), **extra)


def serve_main_path(graph, dev):
    """Phase 13 (b): the mixed trace at full width through one server on
    the card, launch counts zeroed just before the drain and read just
    after it; every request against its solo campaign on the card; one
    flood dispatch profiled."""
    import torch

    from p2p_gossip_tpu_torch.ops import kernels
    from p2p_gossip_tpu_torch.serve import bench

    trace = serve_trace()
    t0 = time.perf_counter()
    graphs = serve_graphs(graph, trace)
    log(f"serve: the trace's {len(graphs)} graphs ready in {time.perf_counter() - t0:.1f} s "
        "(the phase-5 graph reused)")
    torch.cuda.synchronize()
    kernels.reset_launches()
    server, summary = bench.run_trace(trace, SERVE_SLOTS, dev, graphs=graphs, log=log)
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    for name in ("gather_or", "sector_occupancy", "popcount_rows", "coverage_per_slot",
                 "scatter_or", "tick_update"):
        if launches[name] == 0:
            raise AssertionError(f"serve: {name} was not launched by the trace: {launches}")
    if launches["tick_digest"]:
        raise AssertionError(f"serve: tick_digest launched: {launches}")
    log(f"serve: launches over the drain {launches}")
    t0 = time.perf_counter()
    if bench.verify(server, trace, log=log):
        raise AssertionError("serve: a request differs from its solo campaign")
    log(f"serve: verification took {time.perf_counter() - t0:.1f} s")
    results = {d["request_id"]: server.result(d["request_id"]) for d in trace}
    server.submit(serve_request(trace, "flood", range(1000, 1000 + SERVE_SLOTS), "profiled"))
    _, wall, by_name, calls = device_events(server.step)
    if not by_name:
        raise AssertionError("serve: the profiler recorded no device event")
    busy_us = sum(by_name.values())
    log(f"profile (profiled server flood dispatch, {SERVE_SLOTS} replicas, wall "
        f"{wall * 1e3:.2f} ms): device busy {busy_us / 1e3:.2f} ms = "
        f"{busy_us / (wall * 1e6):.3f} of wall")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
        log(f"  {us / 1e3:9.3f} ms  {us / busy_us:6.3f}  x{calls[name]:<5d} {name[:100]}")
    summary = dict(summary, busy_share_flood_dispatch=busy_us / (wall * 1e6))
    del server
    torch.cuda.empty_cache()
    return launches, summary, graphs, results


def _request(d):
    from p2p_gossip_tpu_torch.serve.request import SimRequest

    return SimRequest.from_dict(d)


def serve_rings(graphs, dev):
    """Phase 13 (c): telemetry's rings on for one flood dispatch (the
    trace's full width) and one push-pull dispatch (512 shares, four
    128-share passes) of SERVE_SLOTS replicas: tick_digest launches once a
    tick (round) for all replicas, as a solo run's once a tick; each
    replica's ring and digest events equal its solo telemetry-on run's;
    with the rings off no tick_digest launches."""
    import torch

    from p2p_gossip_tpu_torch import telemetry
    from p2p_gossip_tpu_torch.engine.sync import run_flood_coverage
    from p2p_gossip_tpu_torch.models.protocols import run_pushpull_sim
    from p2p_gossip_tpu_torch.ops import kernels
    from p2p_gossip_tpu_torch.batch.campaign import flood_replicas
    from p2p_gossip_tpu_torch.serve.server import GossipServer

    trace = serve_trace()
    seeds = list(range(2000, 2000 + SERVE_SLOTS))
    cases = {"flood": serve_request(trace, "flood", seeds, "rings-flood"),
             "pushpull": serve_request(trace, "pushpull", seeds, "rings-pushpull", shares=512)}
    launches = {}
    for kind, req in cases.items():
        server = GossipServer(slots=SERVE_SLOTS, device=dev)
        server._graphs.update(graphs)
        telemetry.reset()
        telemetry.configure(None, rings=True)
        server.submit(req)
        torch.cuda.synchronize()
        kernels.reset_launches()
        server.step()
        torch.cuda.synchronize()
        got = dict(kernels.launches)
        camp = [e for e in telemetry.events() if e["type"] in ("ring", "digest")]
        ticks = got["coverage_per_slot"]  # once a tick (round) for the batch
        if got["tick_digest"] != ticks or ticks == 0:
            raise AssertionError(f"serve rings[{kind}]: tick_digest launched "
                                 f"{got['tick_digest']} times in {ticks} ticks")
        g = trace_graph(graphs, req)
        reps = flood_replicas(g, req["shares"], seeds, req["horizon"])
        solo_ticks = []
        for r, seed in enumerate(seeds):
            telemetry.reset()
            telemetry.configure(None, rings=True)
            kernels.reset_launches()
            if kind == "flood":
                run_flood_coverage(g, reps.origins[r], req["horizon"],
                                   device_graph=server._device_graph(_request(req)), device=dev)
            else:
                run_pushpull_sim(g, reps.replica_schedule(r, req["horizon"]), req["horizon"],
                                 seed=seed, chunk_size=128, record_coverage=True,
                                 device_graph=server._device_graph(_request(req)), device=dev)
            solo_ticks.append((kernels.launches["tick_digest"],
                               kernels.launches["coverage_per_slot"]))
            solo = [e for e in telemetry.events() if e["type"] in ("ring", "digest")]
            mine = [e for e in camp if e["replica"] == r]
            same_events(f"serve rings[{kind}] replica {r}", solo, mine, seed)
        if any(d != t for d, t in solo_ticks):
            raise AssertionError(f"serve rings[{kind}]: a solo run's tick_digest launches "
                                 f"are not its ticks: {solo_ticks}")
        launches[kind] = got
        log(f"serve rings[{kind}]: {SERVE_SLOTS} replicas, {ticks} "
            f"{'ticks' if kind == 'flood' else 'rounds'}, tick_digest {got['tick_digest']} "
            f"launches (solo runs: {solo_ticks[0][0]} in {solo_ticks[0][1]}); every replica's "
            f"ring and digest events equal its solo telemetry-on run's")
        del server
    telemetry.reset()
    return launches


def same_events(label, solo, mine, seed):
    """Replica events against a solo run's, chunk by chunk: ring rows
    equal tick for tick (rows past the replica's own quiescence zero), the
    digests equal over the solo run's executed ticks."""
    def by_chunk(events, kind):
        return {e.get("chunk", 0): e for e in events if e["type"] == kind}

    for kind in ("ring", "digest"):
        s, m = by_chunk(solo, kind), by_chunk(mine, kind)
        if sorted(s) != sorted(m) or any(e["seed"] != seed for e in m.values()):
            raise AssertionError(f"{label}: {kind} chunks {sorted(m)} != solo {sorted(s)}")
        for chunk, want in s.items():
            got = m[chunk]
            if kind == "ring":
                for col in want["metrics"]:
                    a = {want["t0"] + i: v for i, v in enumerate(want["metrics"][col])}
                    b = {got["t0"] + i: v for i, v in enumerate(got["metrics"][col])}
                    if any(a.get(t, 0) != b.get(t, 0) for t in set(a) | set(b)):
                        raise AssertionError(f"{label}: ring {col} of chunk {chunk} differs")
            else:
                a = {want["t0"] + i: v for i, v in enumerate(want["values"])}
                b = {got["t0"] + i: v for i, v in enumerate(got["values"])}
                last = max((t for t, v in a.items() if v), default=-1)
                if any(b.get(t) != v for t, v in a.items() if t <= last):
                    raise AssertionError(f"{label}: digests of chunk {chunk} differ")


def serve_admission(graphs, dev):
    """Phase 13 (d): the modeled dispatch bytes (`serve.scheduler.
    modeled_request_cost`, staging included) of the trace's largest
    dispatch, and of the largest of the other kind (flood or protocol),
    against the card's peak device memory over each dispatch, staging
    included: each within MEMORY_TOLERANCE. Then a request whose modeled
    dispatch exceeds an explicit budget is rejected with a ``request``
    event."""
    import torch

    from p2p_gossip_tpu_torch import telemetry
    from p2p_gossip_tpu_torch.serve.scheduler import modeled_request_cost
    from p2p_gossip_tpu_torch.serve.server import GossipServer

    trace = serve_trace()
    sized = sorted(((modeled_request_cost(_request(d), trace_graph(graphs, d).degree,
                                          SERVE_SLOTS)["dispatch_bytes"], i, d)
                    for i, d in enumerate(trace)), reverse=True)
    largest = sized[0][2]
    other = next(d for _, _, d in sized
                 if (d["protocol"] == "flood") != (largest["protocol"] == "flood"))
    results = {}
    for label, d in (("largest", largest), ("other", other)):
        req = dict(d, request_id=f"mem-{label}", seeds=list(range(3000, 3000 + SERVE_SLOTS)))
        server = GossipServer(slots=SERVE_SLOTS, device=dev)
        server._graphs.update(graphs)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        server.submit(req)
        server.drain()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        model = server._states[req["request_id"]].cost["dispatch_bytes"]
        tag = (f"{d['protocol']}{' lossy' if d.get('loss_prob') else ''}"
               f"{' churn' if d.get('churn_prob') else ''} {d['topology']['family']}")
        results[label] = dict(peak=peak, model=model, request=tag)
        log(f"serve memory[{label}: {tag}, {SERVE_SLOTS} slots, staging included]: peak "
            f"{peak / 1e9:.3f} GB vs modeled {model / 1e9:.3f} GB (measured / model "
            f"{peak / model:.3f})")
        del server
        torch.cuda.empty_cache()
        if abs(peak - model) > MEMORY_TOLERANCE * model:
            raise AssertionError(f"serve: peak device memory {peak} of the {label} dispatch "
                                 f"({tag}) is not within {MEMORY_TOLERANCE:.0%} of the "
                                 f"model's {model}")
    big = results["largest"]
    telemetry.reset()
    telemetry.configure(None, rings=False)
    server = GossipServer(slots=SERVE_SLOTS, hbm_budget_bytes=big["model"] - 1, device=dev)
    server._graphs.update(graphs)
    rid = server.submit(dict(largest, request_id="over-budget"))
    rejected = [e for e in telemetry.events() if e["type"] == "request"
                and e["event"] == "rejected" and e["request_id"] == rid]
    if server.status(rid) != "rejected" or not rejected or server.drain():
        raise AssertionError("serve: a request over the explicit budget was not rejected")
    log(f"serve admission: a request modeled at {big['model']} bytes against a budget of "
        f"{big['model'] - 1} is rejected ({rejected[0]['reason']})")
    telemetry.reset()
    return results


def serve_reduced(dev):
    """Phase 13 (e): a reduced trace (N = SERVE_REDUCED_NODES, 256 shares,
    horizon 32, one request a scenario) on the card and with
    ``device="cpu"`` (the plain versions): every result bitwise equal."""
    from p2p_gossip_tpu_torch.serve import bench

    trace = serve_trace(SERVE_REDUCED_NODES, 10, 256, 32)
    t0 = time.perf_counter()
    card, _ = bench.run_trace(trace, SERVE_SLOTS, dev, log=lambda m: None)
    cpu, _ = bench.run_trace(trace, SERVE_SLOTS, "cpu", log=lambda m: None)
    for d in trace:
        rid = d["request_id"]
        if not bench.same_result(card.result(rid), cpu.result(rid)):
            raise AssertionError(f"serve reduced: {rid} differs between the card and the CPU")
    log(f"serve reduced (N={SERVE_REDUCED_NODES}, {len(trace)} requests): the card's results "
        f"equal the CPU's bitwise ({time.perf_counter() - t0:.1f} s)")


def serve_phase(graph, dev, rng):
    """Phase 13: the batched tick_digest, then the gossip server on the
    card."""
    t0 = time.perf_counter()
    check_digest_batched_ragged(dev, rng)
    digest = check_digest_batched(dev, rng, reps=10)
    launches, summary, graphs, results = serve_main_path(graph, dev)
    rings = serve_rings(graphs, dev)
    memory = serve_admission(graphs, dev)
    serve_reduced(dev)
    log(json.dumps({"serve": dict(summary, memory=memory)}))
    log(f"phase 13 took {time.perf_counter() - t0:.1f} s")
    return dict(digest=digest, launches=launches, summary=summary, rings=rings,
                memory=memory, results=results, graphs=graphs)

# --- phase 14 -----------------------------------------------------------------

def delta_library_ms(changed, need, k, reps):
    """``torch.nonzero`` on one destination's candidate mask (nonzero word,
    row in the cut), times the k destinations: compress_deltas' one-call
    PyTorch counterpart (it ranks the candidates, it packs nothing)."""
    import torch

    mask = ((changed != 0) & need[:, :1]).reshape(-1)
    return k * time_ms(lambda: torch.nonzero(mask), reps, calls=KERNEL_CALLS)


# compress_deltas' edge cases, as tests/test_torch_exchange.py holds the
# plain version to JAX: (label, B or None, n_loc, W, k, capacity, fill);
# a capacity "at" is destination 0's count, "past" one below it; fill as
# `compress_case`. "ragged-tiles": n_loc*W = 9,000 words, not a multiple of
# the kernel's 4,096-word tile.
COMPRESS_EDGES = (
    ("all-zero", None, 20, 8, 3, 50, "zero"), ("all-nonzero", None, 20, 8, 3, 50, "full"),
    ("capacity-1", None, 10, 4, 2, 1, "random"),
    ("count-at-capacity", None, 16, 3, 3, "at", "random"),
    ("count-past-capacity", None, 16, 3, 3, "past", "random"),
    ("k-1", None, 30, 5, 1, 64, "random"), ("k-32", None, 33, 5, 32, 20, "random"),
    ("ragged-tiles", None, 1000, 9, 4, 3000, "random"),
    ("B-3-one-over", 3, 40, 6, 4, 12, "random"),
)
COMPRESS_REPEATS = 10  # calls on one input whose outputs must all be equal
STRESS_TICKS = 8  # the 1M BA flood's frontiers stacked as B = 8 replicas


def compress_case(rng, b, n_loc, w, k, fill):
    """A (B*n_loc, W) slice and its (n_loc, k) cut: fill "random" (60% zero
    words), "zero" or "full" (no zero word); with B replicas, replica 1
    keeps its words and the others only their first row's."""
    rows = (b or 1) * n_loc
    changed = rng.integers(1, 2**32, (rows, w), dtype=np.uint64).astype(np.uint32)
    if fill == "zero":
        changed[:] = 0
    elif fill == "random":
        changed[rng.random((rows, w)) < 0.6] = 0
    if b:
        changed.reshape(b, n_loc, w)[[r for r in range(b) if r != 1], 1:] = 0
    return changed.view(np.int32), rng.random((n_loc, k)) < 0.5


def check_compress_edges(dev, rng):
    """Phase 14 (a): compress_deltas on COMPRESS_EDGES, each bitwise its plain
    version (the padding, the counts past capacity and the one replica
    over included)."""
    import torch

    from p2p_gossip_tpu_torch.ops import kernels

    for label, b, n_loc, w, k, cap, fill in COMPRESS_EDGES:
        changed, need = compress_case(rng, b, n_loc, w, k, fill)
        if isinstance(cap, str):
            count0 = int(((changed != 0) & need[:, :1]).sum())
            cap = count0 if cap == "at" else count0 - 1
        changed = torch.as_tensor(changed, device=dev)
        need = torch.as_tensor(need, device=dev)
        got = kernels.compress_deltas(changed, need, cap, replicas=b)
        want = kernels.compress_deltas(changed, need, cap, replicas=b, plain=True)
        for a, c, part in zip(got, want, ("idx", "val", "counts")):
            compare(f"compress_deltas[{label} {part}]", a, c)
        if b and (got[2] > cap).any(dim=1).tolist() != [r == 1 for r in range(b)]:
            raise AssertionError(f"compress_deltas[{label}]: not replica 1 alone over")
    log(f"compress_deltas edge cases: {len(COMPRESS_EDGES)} cases "
        f"({', '.join(e[0] for e in COMPRESS_EDGES)}), kernel == plain")


def check_compress_stress(graph, dg, origins, dev, reps):
    """Phase 14 (a) on the 1M BA graph: shard 0 of its SHARD_SPLIT-way split
    at the new frontiers of ticks 0..STRESS_TICKS-1 of the coverage flood
    of ``origins``, stacked as B = STRESS_TICKS replicas (thousands of
    tiles a replica, so the look-back crosses many windows): bitwise the
    plain version, then COMPRESS_REPEATS calls on the same input each
    bitwise the first (tile scheduling changes nothing); timed beside the
    bound and ``torch.nonzero`` x k."""
    import torch

    import p2p_gossip_tpu_torch as pt
    from p2p_gossip_tpu_torch.ops import kernels
    from p2p_gossip_tpu_torch.ops.build import load_library
    from p2p_gossip_tpu_torch.parallel import exchange as exch

    k, b = SHARD_SPLIT, STRESS_TICKS
    n_padded = graph.n + (-graph.n) % k
    n_loc = n_padded // k
    need_np = exch.plan_flood_exchange_csr(graph, n_padded, k)
    cut = need_np.reshape(k, n_loc, k).sum(axis=1)
    sched = pt.Schedule(graph.n, origins, np.zeros(len(origins), dtype=np.int32))
    fronts = []
    capture_state(dg, sched, len(origins), b, dev, frontiers=fronts)
    w = fronts[0].shape[1]
    changed = torch.cat([f[:n_loc] for f in fronts])  # (b * n_loc, W)
    del fronts
    need0 = torch.as_tensor(need_np[:n_loc], device=dev)
    cap = exch.delta_capacity(int(cut.max()), n_loc, w)
    got = kernels.compress_deltas(changed, need0, cap, replicas=b)
    want = kernels.compress_deltas(changed, need0, cap, replicas=b, plain=True)
    for a, c, part in zip(got, want, ("idx", "val", "counts")):
        compare(f"compress_deltas[1M BA stress B={b} {part}]", a, c)
    del want
    for i in range(COMPRESS_REPEATS):
        again = kernels.compress_deltas(changed, need0, cap, replicas=b)
        for a, c, part in zip(again, got, ("idx", "val", "counts")):
            compare(f"compress_deltas[1M BA stress call {i + 2} {part}]", a, c)
    del again
    tiles = load_library().gossip_compress_tiles(n_loc * w)
    mask = ((changed != 0) & need0[:, :1].repeat(b, 1)).reshape(-1)
    out = dict(
        ms=time_ms(lambda: kernels.compress_deltas(changed, need0, cap, replicas=b), reps,
                   calls=KERNEL_CALLS),
        bound_ms=bound_ms(b * (n_loc * w * 4 + 2 * k * cap * 4 + k * 4) + n_loc * k),
        library_ms=k * time_ms(lambda: torch.nonzero(mask), reps, calls=KERNEL_CALLS),
        entries=int(got[2].clamp(max=cap).sum()), tiles=tiles)
    log(f"compress_deltas look-back stress: shard 0 of the 1M BA {k}-way split (n_loc "
        f"{n_loc}, W={w}, capacity {cap}, {tiles} tiles a replica), ticks 0-{b - 1}'s "
        f"frontiers as B={b}: == plain, {COMPRESS_REPEATS} more calls each == the first; "
        f"{out['ms']:.4f} ms (bound {out['bound_ms']:.4f}, nonzero x {k} "
        f"{out['library_ms']:.4f}; {out['entries']} entries)")
    del changed, got, mask
    torch.cuda.empty_cache()
    return out


def check_delta_kernels(graph, frontiers, dev, reps):
    """Phase 14 (a): compress_deltas and scatter_deltas on a SHARD_SPLIT-way
    split of ``graph``'s rows. For each (tag, frontier (N, W)): every
    shard's compress at the planned capacity (`exchange.delta_capacity` of
    the cut, `exchange.plan_flood_exchange_csr`) and at OVERFLOW_CAPACITY,
    and every receiver's scatter of the buffers the shards send it, each
    held bitwise against its plain version; where nothing overflowed, the
    rebuild equals the other shards' cut rows of the frontier. Timed on
    shard 0 and receiver 0 of the last frontier at the planned capacity
    (10 back-to-back calls), beside the bound (compress: the slice and the
    cut read once, the buffers and counts written once; scatter: the
    canvas written once, the buffers read once) and the one-call PyTorch
    counterparts: ``torch.nonzero`` a destination x k, and ``index_put_``
    into a fresh zero canvas."""
    import torch

    from p2p_gossip_tpu_torch.ops import kernels
    from p2p_gossip_tpu_torch.parallel import exchange as exch

    k = SHARD_SPLIT
    n_padded = graph.n + (-graph.n) % k
    n_loc = n_padded // k
    need_np = exch.plan_flood_exchange_csr(graph, n_padded, k)
    cut = need_np.reshape(k, n_loc, k).sum(axis=1)
    w = frontiers[0][1].shape[1]
    cap = exch.delta_capacity(int(cut.max()), n_loc, w)
    need = torch.as_tensor(need_np, device=dev)
    err = {"compress_deltas": 0, "scatter_deltas": 0}
    notes = []
    for tag, frontier in frontiers:
        padded = torch.zeros((n_padded, w), dtype=torch.int32, device=dev)
        padded[: graph.n] = frontier
        for capacity in (cap, OVERFLOW_CAPACITY):
            sent = []
            for sh in range(k):
                rows = slice(sh * n_loc, (sh + 1) * n_loc)
                got = kernels.compress_deltas(padded[rows], need[rows], capacity)
                want = kernels.compress_deltas(padded[rows], need[rows], capacity, plain=True)
                for a, b, part in zip(got, want, ("idx", "val", "counts")):
                    err["compress_deltas"] = max(err["compress_deltas"], compare(
                        f"compress_deltas[{tag} cap {capacity} shard {sh} {part}]", a, b))
                sent.append(got)
            over = max(int(c[2].max()) for c in sent)
            for d in range(k):
                ridx = torch.stack([c[0][d] for c in sent])
                rval = torch.stack([c[1][d] for c in sent])
                got = kernels.scatter_deltas(ridx, rval, n_loc, w, n_padded)
                want = kernels.scatter_deltas(ridx, rval, n_loc, w, n_padded, plain=True)
                err["scatter_deltas"] = max(err["scatter_deltas"], compare(
                    f"scatter_deltas[{tag} cap {capacity} receiver {d}]", got, want))
                if over <= capacity:
                    cut_rows = torch.where(need[:, d:d + 1], padded, 0)
                    compare(f"rebuild[{tag} receiver {d}]", got, cut_rows)
            notes.append(f"{tag} cap {capacity}: largest count {over}"
                         f"{' (overflow)' if over > capacity else ''}")
    changed, need0 = padded[:n_loc], need[:n_loc]
    idx, val, counts = kernels.compress_deltas(changed, need0, cap)
    compress = dict(
        max_abs_err=err["compress_deltas"],
        ms=time_ms(lambda: kernels.compress_deltas(changed, need0, cap), reps,
                   calls=KERNEL_CALLS),
        plain_ms=time_ms(lambda: kernels.compress_deltas(changed, need0, cap, plain=True), 3),
        bound_ms=bound_ms(n_loc * w * 4 + n_loc * k + 2 * k * cap * 4 + k * 4),
        library_ms=delta_library_ms(changed, need0, k, reps),
        capacity=cap, entries=int(counts.clamp(max=cap).sum()),
    )
    sent = [kernels.compress_deltas(padded[sh * n_loc:(sh + 1) * n_loc],
                                    need[sh * n_loc:(sh + 1) * n_loc], cap)
            for sh in range(k)]
    ridx = torch.stack([c[0][0] for c in sent])
    rval = torch.stack([c[1][0] for c in sent])
    canvas = torch.empty((n_padded, w), dtype=torch.int32, device=dev)
    offsets = torch.arange(k, dtype=torch.int64, device=dev)[:, None] * (n_loc * w)

    def library_scatter():
        # index_put_'s route does the kernel's work: it finds the live
        # entries (idx >= 0) and their canvas words inside the timer.
        live = ridx >= 0
        return torch.zeros(n_padded * w, dtype=torch.int32, device=dev).index_put_(
            ((ridx.long() + offsets)[live],), rval[live])

    scatter = dict(
        max_abs_err=err["scatter_deltas"],
        ms=time_ms(lambda: kernels.scatter_deltas(ridx, rval, n_loc, w, n_padded, out=canvas),
                   reps, calls=KERNEL_CALLS),
        plain_ms=time_ms(lambda: kernels.scatter_deltas(ridx, rval, n_loc, w, n_padded,
                                                        out=canvas, plain=True), 3),
        bound_ms=bound_ms(n_padded * w * 4 + 2 * k * cap * 4),
        library_ms=time_ms(library_scatter, reps, calls=KERNEL_CALLS),
        entries=int((ridx >= 0).sum()),
    )
    hub = check_overlay_hub(need_np, cut, padded, k, n_loc, canvas, reps)
    log(f"exchange kernels, {k}-shard split of N={graph.n} (n_loc {n_loc}, W={w}, cut "
        f"{int(cut.max())} rows, capacity {cap}): kernel == plain for every shard and "
        f"receiver; {'; '.join(notes)}. Shard 0 / receiver 0 of the last frontier: "
        f"compress {compress['ms']:.4f} ms (bound {compress['bound_ms']:.4f}, nonzero x {k} "
        f"{compress['library_ms']:.4f}, plain {compress['plain_ms']:.3f}; "
        f"{compress['entries']} entries); scatter {scatter['ms']:.4f} ms (bound "
        f"{scatter['bound_ms']:.4f}, index_put_ {scatter['library_ms']:.4f}, plain "
        f"{scatter['plain_ms']:.3f}; {scatter['entries']} entries)")
    del padded, canvas, sent
    torch.cuda.empty_cache()
    return {"compress_deltas": compress, "scatter_deltas": scatter, "overlay_hub": hub}


def check_overlay_hub(need_np, cut, padded, k, n_loc, canvas, reps):
    """``exchange.overlay_hub`` (torch ``index_copy_``, the hub exchange's
    row set) on the SHARD_SPLIT-way split with a pinned hub count
    (`exchange.plan_hub_split`, PINNED_HUB_ROWS a shard): every shard's
    hub rows of the frontier overlaid onto a canvas, held against the rows
    themselves, timed beside its bound (the k*h-row block read once, those
    rows written once, their int64 ids read once)."""
    import torch

    from p2p_gossip_tpu_torch.parallel import exchange as exch

    w = padded.shape[1]
    split = exch.plan_hub_split(need_np, cut, k, n_loc, w, hub_rows=PINNED_HUB_ROWS)
    rows = torch.as_tensor(split["hub_global"].reshape(-1).astype(np.int64), device=padded.device)
    block = padded[rows].contiguous()
    canvas.zero_()
    exch.overlay_hub(canvas, rows, block)
    compare("overlay_hub[hub rows]", canvas[rows], block)
    if int(canvas.count_nonzero()) != int(block.count_nonzero()):
        raise AssertionError("overlay_hub wrote outside the hub rows")
    h = split["hub_count"]
    nbytes = 2 * k * h * w * 4 + k * h * 8
    out = dict(ms=time_ms(lambda: exch.overlay_hub(canvas, rows, block), reps, calls=KERNEL_CALLS),
               bound_ms=bound_ms(nbytes), hub_rows=h)
    log(f"overlay_hub ({k} shards x {h} hub rows, W={w}): == the hub rows; "
        f"{out['ms']:.4f} ms, bound {out['bound_ms']:.6f} ms ({nbytes / 1e6:.3f} MB)")
    return out


def sharded_worker(graph, sched, origins, ba, device):
    """Phase 14 (b), on every rank: the mesh of all ranks on the nodes axis,
    phase 5's flood and phase 6's coverage (of ``origins``) in every
    SHARDED_MODES mode (a warm flood, then the timed flood and coverage
    between a launch-count reset and a read, each with its peak device
    memory against ``stats.extra['resident_bytes']``), a replicated and a
    delta flood more (the first rank's under the profiler), and with
    ``ba`` (graph, origins) the million-node BA coverage on the sharded
    ring with the delta exchange. Every rank runs every call, so the
    collectives pair up across the mesh. A run's peak counts from before
    its graph's first run, so it includes the staged arrays the graph
    keeps on the card (as ``resident_bytes`` does). ``device`` None means
    ``cuda:<rank>``; on the CPU nothing is profiled and no memory is
    read (peaks 0). Returns host values only."""
    import torch
    import torch.distributed as dist

    from p2p_gossip_tpu_torch.ops import kernels
    from p2p_gossip_tpu_torch.parallel import launch
    from p2p_gossip_tpu_torch.parallel.engine_sharded import (
        run_sharded_flood_coverage,
        run_sharded_sim,
        stage_sharded_graph,
    )
    from p2p_gossip_tpu_torch.parallel.mesh import make_mesh

    dev = torch.device(device if device else f"cuda:{dist.get_rank()}")
    cuda = dev.type == "cuda"
    mesh = make_mesh(device=dev)

    base = device_allocated(cuda)
    t0 = time.perf_counter()
    sg = stage_sharded_graph(graph, mesh)
    out = {"stage_s": time.perf_counter() - t0, "shape": mesh.shape}
    for mode, kw in SHARDED_MODES:
        flood = dict(chunk_size=CHUNK, sharded_graph=sg, **kw)
        run_sharded_sim(graph, sched, HORIZON, mesh, **flood)
        kernels.reset_launches()
        stats, wall, peak = measured_run(
            lambda: run_sharded_sim(graph, sched, HORIZON, mesh, **flood), base, cuda)
        (cstats, cov), cwall, cpeak = measured_run(lambda: run_sharded_flood_coverage(
            graph, origins, HORIZON, mesh, sharded_graph=sg, **kw), base, cuda)
        out[mode] = dict(
            stats=stats, wall=wall, peak=peak, coverage=cov, cov_stats=cstats,
            cov_wall=cwall, cov_peak=cpeak, launches=dict(kernels.launches))
        launch.progress()
    for mode in ("replicated", "delta"):
        flood = dict(chunk_size=CHUNK, sharded_graph=sg, **dict(SHARDED_MODES)[mode])

        def run():
            return run_sharded_sim(graph, sched, HORIZON, mesh, **flood).extra["ticks_executed"]

        if mesh.is_first and cuda:
            profile_device(f"sharded {mode} flood", run)
        else:
            run()
        launch.progress()
    if ba is not None:
        ba_graph, ba_origins = ba
        del sg
        base = device_allocated(cuda)
        t0 = time.perf_counter()
        sg = stage_sharded_graph(ba_graph, mesh)
        stage_s = time.perf_counter() - t0
        ba_kw = dict(ring_mode="sharded", exchange="delta", sharded_graph=sg)
        _, warm_wall, warm_peak = measured_run(lambda: run_sharded_flood_coverage(
            ba_graph, ba_origins, HORIZON, mesh, **ba_kw), base, cuda)
        kernels.reset_launches()
        (stats, cov), wall, peak = measured_run(lambda: run_sharded_flood_coverage(
            ba_graph, ba_origins, HORIZON, mesh, **ba_kw), base, cuda)
        out["ba"] = dict(stats=stats, coverage=cov, wall=wall, peak=peak, stage_s=stage_s,
                         warm_wall=warm_wall, warm_peak=warm_peak,
                         launches=dict(kernels.launches))
    return out


def device_allocated(cuda: bool) -> int:
    """Bytes allocated on the card after a sync and a cache flush (0 off
    the card)."""
    import torch

    if not cuda:
        return 0
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated()


def measured_run(run, base: int, cuda: bool):
    """(``run()``'s result, its wall seconds ending in a sync, its peak
    device memory above ``base``; 0 off the card)."""
    import torch

    if cuda:
        device_allocated(cuda)
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    result = run()
    if not cuda:
        return result, time.perf_counter() - t0, 0
    torch.cuda.synchronize()
    return result, time.perf_counter() - t0, torch.cuda.max_memory_allocated() - base


def same_counts(a, b) -> bool:
    return all(np.array_equal(getattr(a, f), getattr(b, f))
               for f in ("generated", "received", "sent", "processed"))


def check_resident(label, peak, model):
    log(f"  {label}: peak device memory {peak / 1e9:.3f} GB vs modeled {model / 1e9:.3f} GB "
        f"(measured / model {peak / model:.3f})")
    if abs(peak - model) > MEMORY_TOLERANCE * model:
        raise AssertionError(f"{label}: peak device memory {peak} is not within "
                             f"{MEMORY_TOLERANCE:.0%} of the model's {model}")


def sharded_references(graph, sched, origins, ranks, ref, ref_cov, dev):
    """What each SHARDED_MODES run on ``ranks`` node shards must equal:
    mode -> (flood stats, coverage stats, coverage rows) of the
    single-device port. ``ref`` and ``ref_cov`` are its flood and coverage
    at the graph's own delays. Async K replays the synchronous engine with
    cross-shard delays clamped to K (`async_ticks.clamp_flood_delays`): on
    several ranks its reference runs those delays; on one rank no edge
    crosses a shard and it shares the others'."""
    from p2p_gossip_tpu_torch.engine.sync import run_flood_coverage, run_sync_sim
    from p2p_gossip_tpu_torch.parallel.async_ticks import clamp_flood_delays

    refs = {}
    for mode, kw in SHARDED_MODES:
        refs[mode] = (ref, *ref_cov)
        if ranks > 1 and kw.get("async_k", 0) > 1:
            d = clamp_flood_delays(graph, ranks, kw["async_k"])
            refs[mode] = (
                run_sync_sim(graph, sched, HORIZON, chunk_size=CHUNK, ell_delays=d, device=dev),
                *run_flood_coverage(graph, origins, HORIZON, ell_delays=d, device=dev))
    return refs


def check_sharded_mode(mode, run, want):
    """Phase 14 (b)'s equality of one rank's SHARDED_MODES ``run`` (a
    `sharded_worker` entry) with its reference ``want`` (a
    `sharded_references` entry): counters, ticks and coverage rows."""
    stats, cov_stats, cov = want
    st = run["stats"]
    # Async K's ring holds max(dmax, K) + 1 slots: its stop test may run an
    # empty tick more than the synchronous engine's.
    if not (same_counts(st, stats) and (st.extra["ticks_executed"] == stats.extra[
            "ticks_executed"] or mode == "async")):
        raise AssertionError(f"sharded flood [{mode}]: counters or ticks differ from the "
                             "single-device port's")
    if not (np.array_equal(run["coverage"], cov) and same_counts(run["cov_stats"], cov_stats)):
        raise AssertionError(f"sharded coverage [{mode}]: rows or counters differ from the "
                             "single-device port's")


def delta_frontiers(dg, sched, dev):
    """Phase 14 (a)'s frontiers: the main-path flood's new frontier at each
    of DELTA_TICKS, as (tag, (N, W))."""
    return [(f"tick-{t}", capture_ring(dg, sched, CHUNK, t + 1, dev)[2].clone())
            for t in DELTA_TICKS]


def ba_exchange(graph, dg, origins, frontier, dev):
    """Phase 14 (a) on the 1M BA graph: the exchange kernels on the 4-way
    split of its tick-2 frontier, and compress_deltas' look-back stress
    case."""
    return dict(delta=check_delta_kernels(graph, [("tick-2", frontier)], dev, 5),
                stress=check_compress_stress(graph, dg, origins, dev, 5))


def sharded_phase(graph, dg, sched, ba, dev):
    """Phase 14: (a) the exchange kernels at 100K (compress_deltas' edge
    cases, the flood's tick-3 and tick-10 frontiers; the 1M BA split and
    the look-back stress case ran in phase 12's hook), (b) the
    sharded flood on ``torch.cuda.device_count()`` NCCL ranks against the
    single-device port, (c) 2 and 4 gloo ranks on the one card."""
    import torch
    import torch.distributed as dist

    from p2p_gossip_tpu_torch.engine.sync import run_flood_coverage, run_sync_sim
    from p2p_gossip_tpu_torch.ops import kernels
    from p2p_gossip_tpu_torch.parallel import launch
    from p2p_gossip_tpu_torch.parallel.mesh import initialize_multihost

    t_phase = time.perf_counter()
    check_compress_edges(dev, np.random.default_rng(SEED))
    kernels_100k = check_delta_kernels(graph, delta_frontiers(dg, sched, dev), dev, reps=10)
    torch.cuda.empty_cache()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = run_sync_sim(graph, sched, HORIZON, chunk_size=CHUNK, device_graph=dg, device=dev)
    ref_tick_ms = (time.perf_counter() - t0) / ref.extra["ticks_executed"] * 1e3
    origins = np.random.default_rng(SEED + 1).integers(0, graph.n, COVERAGE_ORIGINS)
    ref_cov_stats, ref_cov = run_flood_coverage(graph, origins, HORIZON, device_graph=dg,
                                                device=dev)
    ranks = torch.cuda.device_count()
    refs = sharded_references(graph, sched, origins, ranks, ref, (ref_cov_stats, ref_cov), dev)
    ba_args = (ba["graph"], ba["origins"])
    if ranks == 1:
        initialize_multihost(backend="nccl", device=dev)
        try:
            runs = sharded_worker(graph, sched, origins, ba_args, str(dev))
        finally:
            dist.destroy_process_group()
    else:
        runs = launch.spawn(sharded_worker, ranks, graph, sched, origins, ba_args, None,
                            backend="nccl")[0]
    log(f"sharded flood (b): {ranks} NCCL rank(s), mesh {runs['shape']}, host staging "
        f"{runs['stage_s']:.2f} s; single-device reference {ref.extra['ticks_executed']} "
        f"ticks, {ref_tick_ms:.3f} ms/tick in this phase (each sharded wall below is the "
        f"whole call: the plan, the run's set-up and the final gathers included)")
    for mode, _ in SHARDED_MODES:
        r = runs[mode]
        st, cst = r["stats"], r["cov_stats"]
        ticks = st.extra["ticks_executed"]
        check_sharded_mode(mode, r, refs[mode])
        tick_ms = r["wall"] / ticks * 1e3
        launched = {k: v for k, v in r["launches"].items() if v}
        log(f"  {mode}: flood {ticks} ticks, {r['wall']:.4f} s -> {tick_ms:.3f} ms/tick "
            f"({tick_ms / ref_tick_ms:.3f} of the single-device run's; "
            f"{st.totals()['processed'] / r['wall']:.4e} node-updates/s); coverage "
            f"{r['cov_wall']:.4f} s; == single-device (counters, ticks, coverage rows); "
            f"exchange {st.extra['exchange']['mode']}; launches (flood + coverage) "
            f"{launched}")
        for name in FLOOD_KERNELS:
            if r["launches"][name] == 0:
                raise AssertionError(f"sharded [{mode}]: {name} never launched")
        delta = st.extra["exchange"]["mode"] in ("delta", "hub")
        for name in SHARDED_KERNELS:
            if delta != (r["launches"][name] > 0):
                raise AssertionError(f"sharded [{mode}]: {name} launched "
                                     f"{r['launches'][name]} times")
        check_resident(f"{mode} flood", r["peak"], st.extra["resident_bytes"])
        check_resident(f"{mode} coverage", r["cov_peak"], cst.extra["resident_bytes"])
    b = runs["ba"]
    bticks = b["launches"]["coverage_per_slot"]
    if not (np.array_equal(b["coverage"], ba["coverage"]) and same_counts(b["stats"],
                                                                          ba["stats"])):
        raise AssertionError("sharded 1M BA coverage: differs from phase 12's single-device run")
    log(f"  1M BA m=3 coverage, sharded ring, delta: host staging {b['stage_s']:.2f} s, "
        f"first run {b['warm_wall']:.4f} s (the card copy and the cut plan made), timed "
        f"{bticks} ticks, {b['wall']:.4f} s -> {b['wall'] / bticks * 1e3:.2f} ms/tick (phase "
        f"12's single-device run: {ba['ms_per_tick']:.2f}); == phase 12's single-device run; "
        f"launches {({k: v for k, v in b['launches'].items() if v})}")
    check_resident("1M BA coverage (first run)", b["warm_peak"], b["stats"].extra["resident_bytes"])
    check_resident("1M BA coverage", b["peak"], b["stats"].extra["resident_bytes"])

    gloo = gloo_ranks(graph, sched, origins, ref, ref_cov)
    log(f"phase 14 took {time.perf_counter() - t_phase:.1f} s")
    return dict(kernels_100k=kernels_100k, kernels_1m=ba["delta"], stress=ba["stress"],
                runs=runs, gloo=gloo, ref_tick_ms=ref_tick_ms)


def gloo_ranks(graph, sched, origins, ref, ref_cov):
    """Phase 14 (c): GLOO_RANKS ranks on the one card (cuda:0 for every
    rank) over gloo, gloo's explicit choice (it stages CUDA tensors through
    the host), on phase 5's flood and coverage with the dense and delta
    exchanges: counters and coverage rows equal to the single-device
    port's, and the delta run's report its planned capacity with entries
    used. Walls are transport over the host and say nothing of a
    multi-GPU machine's speed."""
    from p2p_gossip_tpu_torch.parallel import exchange as exch
    from p2p_gossip_tpu_torch.parallel import launch

    sim = "p2p_gossip_tpu_torch.parallel.engine_sharded:run_sharded_sim"
    cov = "p2p_gossip_tpu_torch.parallel.engine_sharded:run_sharded_flood_coverage"
    calls, labels = [], []
    for n in GLOO_RANKS:
        for mode, kw in (("dense", dict(ring_mode="sharded")), ("delta", dict(exchange="delta"))):
            calls.append((n, 1, sim, (graph, sched, HORIZON), dict(chunk_size=CHUNK, **kw)))
            calls.append((n, 1, cov, (graph, origins, HORIZON), kw))
            labels.append((n, mode))
    t0 = time.perf_counter()
    ranks = launch.spawn(launch.call_on_meshes, max(GLOO_RANKS), calls, GLOO_DEVICE,
                         backend="gloo")
    wall = time.perf_counter() - t0
    out = {}
    for i, (n, mode) in enumerate(labels):
        stats, (cstats, cov_rows) = ranks[0][2 * i], ranks[0][2 * i + 1]
        for r in ranks[1:n]:
            if not same_counts(r[2 * i], stats):
                raise AssertionError(f"gloo {n} ranks [{mode}]: ranks disagree")
        if not (same_counts(stats, ref) and np.array_equal(cov_rows, ref_cov)):
            raise AssertionError(f"gloo {n} ranks [{mode}]: differs from the single-device port")
        ex = stats.extra["exchange"]
        if mode == "delta":
            n_padded = graph.n + (-graph.n) % n
            need = exch.plan_flood_exchange_csr(graph, n_padded, n)
            cut = int(need.reshape(n, n_padded // n, n).sum(axis=1).max())
            cap = exch.delta_capacity(cut, n_padded // n, CHUNK // 32)
            if not (ex["capacity"] == cap and ex["achieved_used_entries"] > 0
                    and ex["exchange_ticks"] == stats.extra["ticks_executed"]):
                raise AssertionError(f"gloo {n} ranks: exchange report {ex}")
        out[f"{n}_{mode}"] = dict(ticks=stats.extra["ticks_executed"], exchange=ex)
        log(f"  gloo (c) {n} ranks on one card [{mode}]: == single-device (counters, "
            f"coverage rows), {stats.extra['ticks_executed']} ticks; exchange {ex}")
    log(f"gloo (c): {len(calls)} runs on {max(GLOO_RANKS)} spawned ranks in {wall:.1f} s "
        "(host transport, not a speed)")
    return out



# --- phase 15 -----------------------------------------------------------------

def or_fold_case(label, stack, dev, reps=0):
    """``kernels.or_fold`` of ``stack`` against its plain version (bitwise);
    with ``reps``, timed (10 back-to-back calls) beside its bound: the k
    slices read once, the (n_loc, W) result written once."""
    import torch

    from p2p_gossip_tpu_torch.ops import kernels

    k, n, w = stack.shape
    out = torch.empty((n, w), dtype=torch.int32, device=dev)
    got = kernels.or_fold(stack, out=out)
    want = kernels.or_fold(stack, plain=True)
    result = dict(max_abs_err=compare(f"or_fold[{label}]", got, want))
    if reps:
        result.update(
            ms=time_ms(lambda: kernels.or_fold(stack, out=out), reps, calls=KERNEL_CALLS),
            plain_ms=time_ms(lambda: kernels.or_fold(stack, plain=True), reps,
                             calls=KERNEL_CALLS),
            bound_ms=bound_ms((k + 1) * n * w * 4))
    return result, got


def check_or_fold_ragged(dev, rng):
    """or_fold on OR_FOLD_RAGGED's (k, W, n_loc): random words with every bit
    in play (the top bit set), the vector path where n_loc x W is a
    multiple of 4 and the scalar one where not, and a stack whose slices
    start 4 bytes past 16-byte alignment."""
    err = 0
    for k, w, n in OR_FOLD_RAGGED:
        stack = random_words(rng, (k, n, w), dev)
        stack.view(-1)[0] |= -(1 << 31)
        err = max(err, or_fold_case(f"k={k} W={w} n_loc={n}", stack, dev)[0]["max_abs_err"])
        skewed = random_words(rng, (k * n * w + 1,), dev)[1:].view(k, n, w)
        err = max(err, or_fold_case(f"k={k} W={w} n_loc={n}, unaligned", skewed,
                                    dev)[0]["max_abs_err"])
    log(f"or_fold ragged: {len(OR_FOLD_RAGGED)} shapes, aligned and unaligned, "
        f"== plain (max_abs_err {err})")
    return err


def check_or_fold_split(graph, dg_edge, sched, dev, reps):
    """or_fold on a SHARD_SPLIT-way split of the phase-9 push-pull's pushes
    at rounds PROTOCOL_CAPTURE_ROUND and PROTOCOL_DENSE_ROUND: the senders
    in SHARD_SPLIT rank groups, each group's `scatter_or` of its pushes
    into a (n_padded, W) buffer, the buffers restacked per destination
    shard and folded; the folded shards equal the single-device round's
    pushed rows (one `scatter_or` of every push). Timed on destination 0's
    stack of the dense round."""
    import torch

    from p2p_gossip_tpu_torch.models import protocols
    from p2p_gossip_tpu_torch.models.partnersel import pick_key
    from p2p_gossip_tpu_torch.ops import kernels

    n, w, k = graph.n, CHUNK // 32, SHARD_SPLIT
    n_padded = n + (-n) % k
    n_loc = n_padded // k
    origins, gen_ticks = sched.padded(CHUNK, HORIZON)
    nodes = torch.arange(n, dtype=torch.int64, device=dev)
    key = pick_key(nodes[:, None], torch.zeros((1, 1), dtype=torch.int64, device=dev), SEED)
    err, timed = 0, None
    for t in (PROTOCOL_CAPTURE_ROUND, PROTOCOL_DENSE_ROUND):
        _, _, _, hist = protocols._run_chunk(
            dg_edge, origins, gen_ticks, key, None, None, None, mode="pushpull",
            chunk_size=CHUNK, horizon=t, n_cov=None, plain=False)
        flat = hist.view(-1, w)
        draw = protocols._draw_rounds(dg_edge, key, None, None, None, t, t + 1, "pushpull")
        dst, src, ok = (draw[f][0].reshape(-1) for f in ("partners", "src", "attempted"))
        offsets, entries = kernels.scatter_or_plan(dst, src, ok, n_padded, flat.shape[0])
        pushed = kernels.scatter_or(flat, offsets, entries,
                                    out=torch.empty((n_padded, w), dtype=torch.int32,
                                                    device=dev))
        buffers = []
        for g in range(k):
            rows = slice(g * n_loc, min((g + 1) * n_loc, n))
            offsets, entries = kernels.scatter_or_plan(dst[rows], src[rows], ok[rows],
                                                       n_padded, flat.shape[0])
            buffers.append(kernels.scatter_or(
                flat, offsets, entries,
                out=torch.empty((n_padded, w), dtype=torch.int32, device=dev)))
        for d in range(k):
            mine = slice(d * n_loc, (d + 1) * n_loc)
            stack = torch.stack([b[mine] for b in buffers])
            case, got = or_fold_case(f"round {t}, destination {d}", stack, dev,
                                     reps if (t, d) == (PROTOCOL_DENSE_ROUND, 0) else 0)
            err = max(err, case["max_abs_err"])
            compare(f"or_fold[round {t}, destination {d}] vs the single-device pushes",
                    got, pushed[mine])
            if "ms" in case:
                timed = case
        del hist, flat, buffers, pushed
    torch.cuda.empty_cache()
    timed["max_abs_err"] = err
    log(f"or_fold, {k}-shard split of the phase-9 push-pull's pushes (rounds "
        f"{PROTOCOL_CAPTURE_ROUND} and {PROTOCOL_DENSE_ROUND}, n_loc {n_loc}, W={w}): every "
        f"destination's fold == plain == the single-device pushed rows; destination 0 of "
        f"round {PROTOCOL_DENSE_ROUND}: {timed['ms']:.4f} ms (bound {timed['bound_ms']:.4f}, "
        f"plain {timed['plain_ms']:.4f})")
    return timed


def protocol_run_kwargs(protocol, per_edge, coverage, delays, kw):
    return dict(protocol=protocol, fanout=2, ell_delays=delays if per_edge else None,
                chunk_size=CHUNK, seed=SEED, record_coverage=coverage, **kw)


def sharded_protocols_worker(graph, sched, cov_sched, delays, device):
    """Phase 15 (b), on every rank: the mesh of all ranks on the nodes axis
    and every SHARDED_PROTOCOL_RUNS run (a warm run, then the timed run
    between a launch-count reset and a read, with its peak device memory
    above what was allocated before it, then a one-round call for the
    set-up's share of the wall), then the replicated push-pull once more
    (the first rank's under the profiler). Every rank runs every
    call. ``device`` None means ``cuda:<rank>``; on the CPU nothing is
    profiled and no memory is read. Returns host values only."""
    import torch
    import torch.distributed as dist

    from p2p_gossip_tpu_torch.ops import kernels
    from p2p_gossip_tpu_torch.parallel import launch
    from p2p_gossip_tpu_torch.parallel.mesh import make_mesh
    from p2p_gossip_tpu_torch.parallel.protocols_sharded import run_sharded_partnered_sim

    dev = torch.device(device if device else f"cuda:{dist.get_rank()}")
    cuda = dev.type == "cuda"
    mesh = make_mesh(device=dev)
    out = {"shape": mesh.shape}
    for label, protocol, per_edge, coverage, kw in SHARDED_PROTOCOL_RUNS:
        call = protocol_run_kwargs(protocol, per_edge, coverage, delays, kw)
        sch = cov_sched if coverage else sched

        def run(sch=sch, call=call):
            return run_sharded_partnered_sim(graph, sch, HORIZON, mesh, **call)

        run()
        base = device_allocated(cuda)
        kernels.reset_launches()
        result, wall, peak = measured_run(run, base, cuda)
        stats, cov = result if coverage else (result, None)
        launches = dict(kernels.launches)
        # A one-round call: its wall is the call's set-up (host staging,
        # plan, final gathers) and one round, so the rounds' own time is the
        # difference over HORIZON - 1.
        one_round = measured_run(lambda sch=sch, call=call: run_sharded_partnered_sim(
            graph, sch, 1, mesh, **call), base, cuda)[1]
        out[label] = dict(stats=stats, coverage=cov, wall=wall, peak=peak,
                          launches=launches, one_round=one_round)
        launch.progress()

    def profiled():
        run_sharded_partnered_sim(graph, sched, HORIZON, mesh, **protocol_run_kwargs(
            *SHARDED_PROTOCOL_RUNS[0][1:4], delays, SHARDED_PROTOCOL_RUNS[0][4]))
        return HORIZON

    if mesh.is_first and cuda:
        profile_device("sharded push-pull (replicated ring)", profiled, top=15)
    else:
        profiled()
    return out


def protocol_references(graph, sched, cov_sched, delays, dev, base=None):
    """What each SHARDED_PROTOCOL_RUNS run must equal: label -> (stats,
    coverage or None) of the single-device port. ``base`` maps "pushpull",
    "pull", "pushk" and "coverage" to phase 9's runs (computed here when
    None); an async run is held to the single-device run on its delays
    clamped to max(d, K) (`async_ticks.clamp_partner_delays`)."""
    from p2p_gossip_tpu_torch.models.protocols import run_pushk_sim, run_pushpull_sim
    from p2p_gossip_tpu_torch.parallel.async_ticks import clamp_partner_delays

    def single(protocol, per_edge, coverage, d=None):
        kw = dict(ell_delays=(delays if d is None else d) if per_edge else None, seed=SEED,
                  device=dev, record_coverage=coverage)
        s = cov_sched if coverage else sched
        if not coverage:
            kw["chunk_size"] = CHUNK
        if protocol == "pushk":
            return run_pushk_sim(graph, s, HORIZON, fanout=2, **kw)
        return run_pushpull_sim(graph, s, HORIZON, mode=protocol, **kw)

    if base is None:
        base = {"pushpull": single("pushpull", True, False), "pull": single("pull", False, False),
                "pushk": single("pushk", False, False),
                "coverage": single("pushpull", True, True)}
    refs = {}
    for label, protocol, per_edge, coverage, kw in SHARDED_PROTOCOL_RUNS:
        k = kw.get("async_k", 0)
        if k:
            refs[label] = single(protocol, per_edge, coverage, clamp_partner_delays(delays, k))
        else:
            refs[label] = base["coverage" if coverage else protocol]
    return refs


def check_protocol_run(label, run, want):
    """Phase 15 (b)'s equality of one rank's `sharded_protocols_worker` entry
    with its `protocol_references` entry: counters and coverage rows."""
    stats, cov = want
    if not same_counts(run["stats"], stats):
        raise AssertionError(f"sharded protocols [{label}]: counters differ from the "
                             "single-device port's")
    if cov is not None and not np.array_equal(run["coverage"], cov):
        raise AssertionError(f"sharded protocols [{label}]: coverage rows differ")


def check_protocol_launches(label, protocol, run):
    """Phase 15 (b)'s launch counts of one run: or_fold once a round of the
    run's one pass where it pushes (push-pull, fanout push) and never on
    pull; the exchange kernels exactly on delta and hub; the round's other
    kernels launched; no flood or telemetry kernel."""
    launches = run["launches"]
    pushes = protocol != "pull"
    if launches["or_fold"] != (HORIZON if pushes else 0):
        raise AssertionError(f"sharded protocols [{label}]: or_fold launched "
                             f"{launches['or_fold']} times in {HORIZON} rounds")
    needed = ["popcount_rows"] + (["scatter_or"] if pushes else [])
    needed += ["coverage_per_slot"] if run["coverage"] is not None else []
    delta = run["stats"].extra["exchange"]["mode"] in ("delta", "hub")
    for name in needed + (list(SHARDED_KERNELS) if delta else []):
        if launches[name] == 0:
            raise AssertionError(f"sharded protocols [{label}]: {name} never launched")
    if not delta and any(launches[name] for name in SHARDED_KERNELS):
        raise AssertionError(f"sharded protocols [{label}]: exchange kernels launched")
    if launches["gather_or"] or launches["tick_digest"]:
        raise AssertionError(f"sharded protocols [{label}]: a flood or telemetry kernel ran")


def sharded_protocols_phase(graph, sched, delays, dg_edge, phase9, phase9_refs, dev, rng):
    """Phase 15: (a) or_fold on ragged shapes and on a 4-shard split of the
    phase-9 push-pull's pushes, timed beside its bound; (b) the sharded
    protocols at full width on ``torch.cuda.device_count()`` NCCL ranks
    (one rank: in this process) against phase 9's single-device runs; (c)
    2 and 4 gloo ranks on the one card at a reduced size; (d) the CLI on
    the card against the CPU."""
    import torch
    import torch.distributed as dist

    import p2p_gossip_tpu_torch as pt
    from p2p_gossip_tpu_torch.parallel import launch
    from p2p_gossip_tpu_torch.parallel.mesh import initialize_multihost

    t_phase = time.perf_counter()
    ragged_err = check_or_fold_ragged(dev, rng)
    fold = check_or_fold_split(graph, dg_edge, sched, dev, reps=10)
    fold["max_abs_err"] = max(fold["max_abs_err"], ragged_err)

    origins = np.random.default_rng(SEED + 1).integers(0, graph.n, COVERAGE_ORIGINS)
    cov_sched = pt.Schedule(graph.n, origins, np.zeros(COVERAGE_ORIGINS, dtype=np.int32))
    refs = protocol_references(graph, sched, cov_sched, delays, dev, phase9_refs)
    ranks = torch.cuda.device_count()
    if ranks == 1:
        initialize_multihost(backend="nccl", device=dev)
        try:
            runs = sharded_protocols_worker(graph, sched, cov_sched, delays, str(dev))
        finally:
            dist.destroy_process_group()
    else:
        runs = launch.spawn(sharded_protocols_worker, ranks, graph, sched, cov_sched, delays,
                            None, backend="nccl")[0]
    log(f"sharded protocols (b): {ranks} NCCL rank(s), mesh {runs['shape']}; each wall is "
        "the whole call (staging, plan, set-up and the final gathers included)")
    for label, protocol, _, coverage, _ in SHARDED_PROTOCOL_RUNS:
        r = runs[label]
        check_protocol_run(label, r, refs[label])
        check_protocol_launches(label, protocol, r)
        st = r["stats"]
        round_ms = r["wall"] / HORIZON * 1e3
        loop_ms = (r["wall"] - r["one_round"]) / (HORIZON - 1) * 1e3
        solo_ms = phase9["coverage" if coverage else protocol]["round_ms"]
        launched = {k: v for k, v in r["launches"].items() if v}
        log(f"  {label}: {HORIZON} rounds, whole call {r['wall']:.4f} s -> {round_ms:.3f} "
            f"ms/round; a one-round call {r['one_round']:.4f} s, so {loop_ms:.3f} ms a round "
            f"past the set-up (phase 9's single-device run, staged beforehand: "
            f"{solo_ms:.3f}, {loop_ms / solo_ms:.3f}x); == single-device (counters"
            f"{', coverage rows' if coverage else ''}); ring {st.extra['ring']['mode']}, "
            f"exchange {st.extra['exchange']['mode']}; launches {launched}")
        check_resident(label, r["peak"], st.extra["resident_bytes"])
    gloo = gloo_protocol_ranks(dev)
    check_sharded_protocol_cli(dev)
    seconds = time.perf_counter() - t_phase
    log(f"phase 15 took {seconds:.1f} s")
    return dict(or_fold=fold, runs=runs, gloo=gloo, seconds=seconds)


def gloo_protocols_worker(calls, device):
    """Phase 15 (c), on every rank: each call of ``calls`` (as
    `launch.call_on_meshes` takes them) between a launch-count reset and a
    read: (result, or_fold launches) a call."""
    from p2p_gossip_tpu_torch.ops import kernels
    from p2p_gossip_tpu_torch.parallel import launch

    out = []
    for call in calls:
        kernels.reset_launches()
        out.append((launch.call_on_meshes([call], device)[0], kernels.launches["or_fold"]))
    return out


def gloo_protocol_ranks(dev):
    """Phase 15 (c): GLOO_RANKS gloo ranks on the one card (gloo chosen, not
    a fallback) run push-pull with the dense and the delta exchange and
    fanout push on the sharded ring, at PROTOCOL_GLOO_NODES nodes: each
    equal to the single-device port on the card, each rank folding its k =
    2 or 4 stack with the or_fold kernel once a round. Walls are host
    transport and say nothing of a multi-GPU machine's speed."""
    import p2p_gossip_tpu_torch as pt
    from p2p_gossip_tpu_torch.models.protocols import run_pushk_sim, run_pushpull_sim
    from p2p_gossip_tpu_torch.parallel import launch

    graph = pt.erdos_renyi(PROTOCOL_GLOO_NODES, EDGE_P, seed=SEED)
    rng = np.random.default_rng(SEED)
    sched = pt.Schedule(graph.n, rng.integers(0, graph.n, PROTOCOL_GLOO_SHARES).astype(np.int32),
                        rng.integers(0, GEN_WINDOW, PROTOCOL_GLOO_SHARES).astype(np.int32))
    delays = pt.lognormal_delays(graph, mean_ticks=2.0, sigma=0.5, max_ticks=5, seed=SEED)
    h = PROTOCOL_GLOO_HORIZON
    sim = "p2p_gossip_tpu_torch.parallel.protocols_sharded:run_sharded_partnered_sim"
    modes = (("pushpull-dense", dict(protocol="pushpull", ell_delays=delays,
                                     ring_mode="sharded")),
             ("pushpull-delta", dict(protocol="pushpull", ell_delays=delays, exchange="delta")),
             ("pushk-sharded", dict(protocol="pushk", fanout=2, ring_mode="sharded")))
    want = {"pushpull": run_pushpull_sim(graph, sched, h, ell_delays=delays, seed=SEED,
                                         device=dev)[0],
            "pushk": run_pushk_sim(graph, sched, h, fanout=2, seed=SEED, device=dev)[0]}
    calls, labels = [], []
    for n in GLOO_RANKS:
        for mode, kw in modes:
            calls.append((n, 1, sim, (graph, sched, h), dict(seed=SEED, **kw)))
            labels.append((n, mode))
    t0 = time.perf_counter()
    ranks = launch.spawn(gloo_protocols_worker, max(GLOO_RANKS), calls, GLOO_DEVICE,
                         backend="gloo")
    wall = time.perf_counter() - t0
    for i, (n, mode) in enumerate(labels):
        if not all(same_counts(r[i][0], want[mode.split("-")[0]]) for r in ranks[:n]):
            raise AssertionError(f"gloo {n} ranks [{mode}]: differs from the single-device port")
    out = {}
    for i, (n, mode) in enumerate(labels):
        stats = ranks[0][i][0]
        folds = [r[i][1] for r in ranks[:n]]
        if folds != [h] * n:
            raise AssertionError(f"gloo {n} ranks [{mode}]: or_fold launched {folds} times "
                                 f"on the ranks in {h} rounds")
        out[f"{n}_{mode}"] = dict(exchange=stats.extra["exchange"]["mode"])
        log(f"  gloo (c) {n} ranks on one card [{mode}]: == single-device (counters), "
            f"or_fold once a round on every rank; exchange {stats.extra['exchange']['mode']}")
    log(f"gloo (c): {len(calls)} protocol runs (N={graph.n}, {PROTOCOL_GLOO_SHARES} shares, "
        f"{h} rounds) on {max(GLOO_RANKS)} spawned ranks in {wall:.1f} s (host transport, "
        "not a speed)")
    return out


def check_sharded_protocol_cli(dev):
    """Phase 15 (d): ``--protocol pushpull|pull|pushk --backend sharded``
    (with and without ``--floodCoverage``) on the card and on the CPU: the
    same report apart from the wall-time line."""
    import contextlib
    import io

    from p2p_gossip_tpu_torch.utils import cli

    small = ["--numNodes", "60", "--simTime", "2", "--Latency", "50", "--backend", "sharded"]
    configs = (
        ("pushpull lognormal", small + ["--protocol", "pushpull", "--delayModel", "lognormal"]),
        ("pull coverage, churn + loss", small + ["--protocol", "pull", "--floodCoverage", "20",
                                                 "--churnProb", "0.2", "--lossProb", "0.1"]),
        ("pushk coverage, replicated ring", small + ["--protocol", "pushk", "--fanout", "3",
                                                     "--floodCoverage", "12", "--ringMode",
                                                     "replicated"]),
        ("pushk", small + ["--protocol", "pushk", "--lossProb", "0.1"]),
    )
    for label, args in configs:
        lines = {}
        for device in (str(dev), "cpu"):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = cli.run(args + ["--device", device])
            if rc != 0:
                raise AssertionError(f"CLI {label} on {device} exited {rc}")
            lines[device] = buf.getvalue().splitlines()
        got, want = lines[str(dev)], lines["cpu"]
        if len(got) != len(want) or got[:-1] != want[:-1] or not any(
                ln.startswith("Mesh: ") for ln in got):
            raise AssertionError(f"CLI {label} --backend sharded: report differs from the CPU's")
        log(f"cli[sharded {label}] on {dev} and on the CPU: equal reports ({len(got)} lines)")


# --- phase 16 -----------------------------------------------------------------

def exchange_replicas_ragged(dev, rng):
    """Phase 16 (a): compress_deltas and scatter_deltas with a replica axis
    on ragged (B, n_loc, W, k, capacity): each B-replica launch bitwise
    its plain version (the per-replica loop of the one-run formulas), the
    rebuild from the exchanged (k, B, capacity) buffers too."""
    import torch

    from p2p_gossip_tpu_torch.ops import kernels

    cases = 0
    for b, n_loc, w, k, cap in EXCHANGE_RAGGED:
        changed = sparse_words(rng, (b * n_loc, w), dev, p_sector=0.3)
        need = torch.as_tensor(rng.random((n_loc, k)) < 0.6, device=dev)
        got = kernels.compress_deltas(changed, need, cap, replicas=b)
        want = kernels.compress_deltas(changed, need, cap, replicas=b, plain=True)
        for a, c, part in zip(got, want, ("idx", "val", "counts")):
            compare(f"compress_deltas[B={b} n_loc={n_loc} W={w} k={k} cap={cap} {part}]", a, c)
        ridx, rval = (x.transpose(0, 1).contiguous() for x in got[:2])
        canvas = kernels.scatter_deltas(ridx, rval, n_loc, w, k * n_loc, replicas=b)
        plain = kernels.scatter_deltas(ridx, rval, n_loc, w, k * n_loc, replicas=b, plain=True)
        compare(f"scatter_deltas[B={b} n_loc={n_loc} W={w} k={k} cap={cap}]", canvas, plain)
        cases += 1
    log(f"exchange kernels, replica axis: {cases} ragged (B, n_loc, W, k, capacity) cases, "
        "kernel == plain")


def check_exchange_replicas(graph, dg, gossip_set, dev, reps):
    """Phase 16 (a): compress_deltas and scatter_deltas with B = 8 replicas
    in one launch, on the SHARD_SPLIT-way split of the eight phase-11
    replicas' tick-3 and tick-10 frontiers (W = 256): every shard's
    compress at the planned capacity and at OVERFLOW_CAPACITY with one
    replica alone overflowing (the others' frontiers cut to a few words),
    and every receiver's rebuild of the (k, B, capacity) buffers the
    shards send it, bitwise against the plain versions. Timed on shard 0
    / receiver 0 of the tick-10 split at the planned capacity beside the
    bound (B x the one-run bytes; `need` read once), B launches of the
    one-run kernel, and the one-call torch counterparts."""
    import torch

    from p2p_gossip_tpu_torch.ops import kernels
    from p2p_gossip_tpu_torch.parallel import exchange as exch

    b, k = CAMPAIGN_REPLICAS, SHARD_SPLIT
    n_padded = graph.n + (-graph.n) % k
    n_loc = n_padded // k
    need_np = exch.plan_flood_exchange_csr(graph, n_padded, k)
    cut = need_np.reshape(k, n_loc, k).sum(axis=1)
    need = torch.as_tensor(need_np, device=dev)
    notes = []
    for t in DELTA_TICKS:
        frontier = capture_campaign(dg, gossip_set, CHUNK, t + 1, dev)[2]
        w = frontier.shape[1]
        padded = torch.zeros((b, n_padded, w), dtype=torch.int32, device=dev)
        padded[:, :graph.n] = frontier.view(b, graph.n, w)
        del frontier
        cap = exch.delta_capacity(int(cut.max()), n_loc, w)
        # The overflow case: replica ALONE keeps its frontier, the others a
        # few words, so only ALONE's counts pass OVERFLOW_CAPACITY.
        few = torch.zeros_like(padded)
        few[:, :16, 0] = 1
        few[ALONE] = padded[ALONE]
        for tag, batch, capacity in ((f"tick-{t}", padded, cap),
                                     (f"tick-{t} one replica over", few, OVERFLOW_CAPACITY)):
            sent = []
            over = []
            for sh in range(k):
                changed = batch[:, sh * n_loc:(sh + 1) * n_loc].reshape(b * n_loc, w)
                rows = need[sh * n_loc:(sh + 1) * n_loc]
                got = kernels.compress_deltas(changed, rows, capacity, replicas=b)
                want = kernels.compress_deltas(changed, rows, capacity, replicas=b, plain=True)
                for a, c, part in zip(got, want, ("idx", "val", "counts")):
                    compare(f"compress_deltas B={b} [{tag} shard {sh} {part}]", a, c)
                sent.append(got)
                over.append((got[2] > capacity).any(dim=1))
            over = torch.stack(over).any(dim=0).tolist()
            if capacity == OVERFLOW_CAPACITY and over != [r == ALONE for r in range(b)]:
                raise AssertionError(f"{tag}: replicas over capacity {over}, want {ALONE} alone")
            for d in range(k):
                ridx = torch.stack([c[0][:, d] for c in sent])  # (k sources, B, cap)
                rval = torch.stack([c[1][:, d] for c in sent])
                got = kernels.scatter_deltas(ridx, rval, n_loc, w, n_padded, replicas=b)
                want = kernels.scatter_deltas(ridx, rval, n_loc, w, n_padded, replicas=b,
                                              plain=True)
                compare(f"scatter_deltas B={b} [{tag} receiver {d}]", got, want)
            notes.append(f"{tag} cap {capacity}: replicas over {sum(over)}")
        del few
    changed = padded[:, :n_loc].reshape(b * n_loc, w)
    need0 = need[:n_loc]
    solo_changed = [changed[r * n_loc:(r + 1) * n_loc] for r in range(b)]
    per = n_loc * w * 4 + 2 * k * cap * 4 + k * 4  # a replica's slice, buffers, counts
    # compress_deltas' one-call counterpart (as phase 14's): torch.nonzero on
    # one destination's candidate mask over the batch, times k.
    mask = ((changed != 0) & need0[:, :1].repeat(b, 1)).reshape(-1)
    idx, val, counts = kernels.compress_deltas(changed, need0, cap, replicas=b)
    compress = dict(
        ms=time_ms(lambda: kernels.compress_deltas(changed, need0, cap, replicas=b), reps,
                   calls=KERNEL_CALLS),
        solo_launches_ms=time_ms(lambda: [kernels.compress_deltas(c, need0, cap)
                                          for c in solo_changed], reps),
        plain_ms=time_ms(lambda: kernels.compress_deltas(changed, need0, cap, replicas=b,
                                                         plain=True), 3),
        bound_ms=bound_ms(b * per + n_loc * k),
        library_ms=k * time_ms(lambda: torch.nonzero(mask), reps, calls=KERNEL_CALLS),
        entries=int(counts.clamp(max=cap).sum()),
    )
    sent = [kernels.compress_deltas(padded[:, sh * n_loc:(sh + 1) * n_loc].reshape(b * n_loc, w),
                                    need[sh * n_loc:(sh + 1) * n_loc], cap, replicas=b)
            for sh in range(k)]
    ridx = torch.stack([c[0][:, 0] for c in sent])
    rval = torch.stack([c[1][:, 0] for c in sent])
    canvas = torch.empty((b, n_padded, w), dtype=torch.int32, device=dev)
    solo_idx = [ridx[:, r].contiguous() for r in range(b)]
    solo_val = [rval[:, r].contiguous() for r in range(b)]
    offsets = (torch.arange(k, dtype=torch.int64, device=dev)[:, None, None] * (n_loc * w)
               + torch.arange(b, dtype=torch.int64, device=dev)[None, :, None] * (n_padded * w))

    def library_scatter():
        live = ridx >= 0
        return torch.zeros(b * n_padded * w, dtype=torch.int32, device=dev).index_put_(
            ((ridx.long() + offsets)[live],), rval[live])

    scatter = dict(
        ms=time_ms(lambda: kernels.scatter_deltas(ridx, rval, n_loc, w, n_padded, out=canvas,
                                                  replicas=b), reps, calls=KERNEL_CALLS),
        solo_launches_ms=time_ms(lambda: [kernels.scatter_deltas(
            solo_idx[r], solo_val[r], n_loc, w, n_padded, out=canvas[r]) for r in range(b)],
            reps),
        plain_ms=time_ms(lambda: kernels.scatter_deltas(ridx, rval, n_loc, w, n_padded,
                                                        out=canvas, replicas=b, plain=True), 3),
        bound_ms=bound_ms(b * (n_padded * w * 4 + 2 * k * cap * 4)),
        library_ms=time_ms(library_scatter, reps, calls=KERNEL_CALLS),
        entries=int((ridx >= 0).sum()),
    )
    log(f"exchange kernels B={b} ({k}-shard split of {b} replicas x N={graph.n}, W={w}, "
        f"capacity {cap}): kernel == plain for every shard and receiver; {'; '.join(notes)}. "
        f"Shard 0 / receiver 0 of tick {DELTA_TICKS[-1]}: compress {compress['ms']:.4f} ms "
        f"(bound {compress['bound_ms']:.4f}; {b} one-run launches "
        f"{compress['solo_launches_ms']:.4f}; nonzero x {k} {compress['library_ms']:.4f}; "
        f"plain {compress['plain_ms']:.3f}; {compress['entries']} entries); scatter "
        f"{scatter['ms']:.4f} ms (bound {scatter['bound_ms']:.4f}; {b} one-run launches "
        f"{scatter['solo_launches_ms']:.4f}; index_put_ {scatter['library_ms']:.4f}; plain "
        f"{scatter['plain_ms']:.3f}; {scatter['entries']} entries)")
    del padded, canvas, sent, changed, solo_changed
    torch.cuda.empty_cache()
    return {"compress_deltas": compress, "scatter_deltas": scatter}


def campaign_run_kwargs(kw):
    return dict(record_coverage=True, **kw)


def sharded_campaign_worker(graph, cov_set, pp_set, delays, device, dg=None):
    """Phase 16 (b) and (d), on every rank: the (replicas, nodes) mesh of
    all ranks on the nodes axis (rb = every replica), the coverage
    campaign in every SHARDED_MODES mode (a warm run, then the timed run
    between a launch-count reset and a read, with its peak device memory,
    then replica 0's solo sharded coverage for the wall ratio), the
    push-pull campaign in CAMPAIGN_PROTOCOL_MODES (timed, then replica
    0's solo sharded run), a delta coverage campaign more (the first
    rank's under the profiler), and (d) ``run_coverage_campaign(...,
    mesh=)`` over the (shares, nodes) mesh of the same ranks. Every rank
    runs every call. ``device`` None means ``cuda:<rank>``; on the CPU
    nothing is profiled and no memory is read. Returns host values."""
    import torch
    import torch.distributed as dist

    from p2p_gossip_tpu_torch.batch.campaign import run_coverage_campaign
    from p2p_gossip_tpu_torch.batch.campaign_sharded import (
        run_sharded_campaign,
        run_sharded_protocol_campaign,
    )
    from p2p_gossip_tpu_torch.ops import kernels
    from p2p_gossip_tpu_torch.parallel import launch
    from p2p_gossip_tpu_torch.parallel.engine_sharded import (
        run_sharded_flood_coverage,
        stage_sharded_graph,
    )
    from p2p_gossip_tpu_torch.parallel.mesh import make_mesh
    from p2p_gossip_tpu_torch.parallel.protocols_sharded import run_sharded_partnered_sim

    dev = torch.device(device if device else f"cuda:{dist.get_rank()}")
    cuda = dev.type == "cuda"
    rmesh = make_mesh(replicas=1, device=dev)
    smesh = make_mesh(device=dev)
    base = device_allocated(cuda)
    sg = stage_sharded_graph(graph, rmesh)
    gathers = sum(max(1, c) for c in sg.bucket_counts)
    out = {"shape": rmesh.shape, "gathers_per_tick": gathers}
    for mode, kw in SHARDED_MODES:
        def camp(kw=kw):
            return run_sharded_campaign(graph, cov_set, HORIZON, rmesh, sharded_graph=sg,
                                        **campaign_run_kwargs(kw))

        camp()
        kernels.reset_launches()
        res, wall, peak = measured_run(camp, base, cuda)
        launches = dict(kernels.launches)
        solo_wall = measured_run(lambda kw=kw: run_sharded_flood_coverage(
            graph, cov_set.origins[0], HORIZON, smesh, sharded_graph=sg, **kw), base, cuda)[1]
        out[mode] = dict(result=res, wall=wall, peak=peak, launches=launches,
                         solo_wall=solo_wall)
        launch.progress()
    for label, kw in CAMPAIGN_PROTOCOL_MODES:
        kernels.reset_launches()
        res, wall, peak = measured_run(lambda kw=kw: run_sharded_protocol_campaign(
            graph, pp_set, HORIZON, rmesh, protocol="pushpull", ell_delays=delays,
            record_coverage=True, **kw), base, cuda)
        launches = dict(kernels.launches)
        solo_wall = measured_run(lambda kw=kw: run_sharded_partnered_sim(
            graph, pp_set.replica_schedule(0, HORIZON), HORIZON, smesh, protocol="pushpull",
            ell_delays=delays, chunk_size=pp_set.shares_per_replica,
            seed=int(pp_set.seeds[0]), record_coverage=True, **kw), base, cuda)[1]
        out[label] = dict(result=res, wall=wall, peak=peak, launches=launches,
                          solo_wall=solo_wall)
        launch.progress()

    def profiled():
        kernels.reset_launches()
        run_sharded_campaign(graph, cov_set, HORIZON, rmesh, sharded_graph=sg,
                             **campaign_run_kwargs(dict(SHARDED_MODES)["delta"]))
        return kernels.launches["coverage_per_slot"]

    if rmesh.is_first and cuda:
        profile_device("sharded delta coverage campaign", profiled, top=15)
    else:
        profiled()
    launch.progress()
    del sg
    out["meshed"] = run_coverage_campaign(graph, cov_set, HORIZON, mesh=smesh,
                                          device_graph=dg)
    return out


def same_campaign(a, b, coverage=True) -> bool:
    return (np.array_equal(a.received, b.received) and np.array_equal(a.sent, b.sent)
            and np.array_equal(a.generated, b.generated)
            and (not coverage or np.array_equal(a.coverage, b.coverage)))


def gloo_campaign_ranks(graph, ranks, meshes, dev):
    """Phase 16 (c): ``ranks`` gloo ranks on the one card (gloo chosen, not
    a fallback), each (replicas, nodes) mesh of ``meshes``: the dense and
    delta coverage campaigns and the push-pull campaign (delta), every
    replica equal to the single-device campaign on the card. Walls are host
    transport, not a speed."""
    from p2p_gossip_tpu_torch.batch import campaign as bc
    from p2p_gossip_tpu_torch.parallel import launch

    cov_set = bc.flood_replicas(graph, GLOO_CAMPAIGN_SHARES,
                                np.arange(GLOO_CAMPAIGN_REPLICAS) + SEED, GLOO_CAMPAIGN_HORIZON)
    h = GLOO_CAMPAIGN_HORIZON
    want = {"coverage": bc.run_coverage_campaign(graph, cov_set, h, device=dev),
            "pushpull": bc.run_protocol_campaign(graph, cov_set, h, protocol="pushpull",
                                                 device=dev)}
    camp = "p2p_gossip_tpu_torch.batch.campaign_sharded:run_sharded_campaign"
    pcamp = "p2p_gossip_tpu_torch.batch.campaign_sharded:run_sharded_protocol_campaign"
    runs = (("dense", "coverage", camp, dict(ring_mode="sharded", record_coverage=True)),
            ("delta", "coverage", camp, dict(exchange="delta", record_coverage=True)),
            ("pushpull-delta", "pushpull", pcamp,
             dict(protocol="pushpull", exchange="delta", record_coverage=True)))
    calls, labels = [], []
    for r_shards, nodes in meshes:
        for label, ref, target, kw in runs:
            calls.append((dict(n_node_shards=nodes, replicas=r_shards), target,
                          (graph, cov_set, h), kw))
            labels.append((f"{r_shards}x{nodes}", label, ref))
    t0 = time.perf_counter()
    results = launch.spawn(launch.call_on_replica_meshes, ranks, calls, GLOO_DEVICE,
                           backend="gloo")
    wall = time.perf_counter() - t0
    out = {}
    for i, (shape, label, ref) in enumerate(labels):
        got = [r[i] for r in results if r[i] is not None]
        if not got or not all(same_campaign(g, want[ref]) for g in got):
            raise AssertionError(f"gloo {shape} [{label}]: differs from the single-device "
                                 "campaign")
        ex = got[0].extra["exchange"]
        out[f"{shape}_{label}"] = dict(mesh=got[0].extra["mesh"], exchange=ex["mode"])
        log(f"  gloo (c) {shape} (replicas x nodes) [{label}]: every replica == the "
            f"single-device campaign (counters, coverage rows); mesh {got[0].extra['mesh']}, "
            f"exchange {ex['mode']}"
            + (f", {ex['achieved_used_entries']} entries" if "achieved_used_entries" in ex
               else ""))
    log(f"gloo (c): {len(calls)} campaigns (N={graph.n}, R={GLOO_CAMPAIGN_REPLICAS}, "
        f"{GLOO_CAMPAIGN_SHARES} shares, horizon {h}) on {ranks} spawned ranks in {wall:.1f} s "
        "(host transport, not a speed)")
    return out


def campaign_references(graph, cov_set, ranks, phase11, dev):
    """What phase 16 (b)'s runs on ``ranks`` node shards must equal: kind ->
    CampaignResult of the single-device campaigns, phase 11's
    (``phase11``), and for async (K = 2) on several node shards the
    coverage campaign on the delays clamped to max(d, K) across shards
    (`async_ticks.clamp_flood_delays`; on one shard no edge crosses)."""
    from p2p_gossip_tpu_torch.batch.campaign import run_coverage_campaign
    from p2p_gossip_tpu_torch.parallel.async_ticks import clamp_flood_delays

    refs = dict(phase11, async_coverage=phase11["coverage"])
    k = dict(SHARDED_MODES)["async"]["async_k"]
    if ranks > 1:
        refs["async_coverage"] = run_coverage_campaign(
            graph, cov_set, HORIZON, ell_delays=clamp_flood_delays(graph, ranks, k), device=dev)
    return refs


def check_campaign_results(runs, refs, ref_meshed):
    """Phase 16 (b) and (d)'s equality of one rank's `sharded_campaign_worker`
    result with the single-device campaigns (``refs``, from
    `campaign_references`) and with the call without a mesh
    (``ref_meshed``): every replica's counters and coverage rows."""
    for mode, _ in SHARDED_MODES:
        want = refs["async_coverage" if mode == "async" else "coverage"]
        if not same_campaign(runs[mode]["result"], want):
            raise AssertionError(f"sharded campaign [{mode}]: a replica differs from phase "
                                 "11's single-device campaign")
    for label, _ in CAMPAIGN_PROTOCOL_MODES:
        if not same_campaign(runs[label]["result"], refs["pushpull"]):
            raise AssertionError(f"sharded campaign [{label}]: a replica differs from phase "
                                 "11's single-device push-pull campaign")
    if not same_campaign(runs["meshed"], ref_meshed):
        raise AssertionError("run_coverage_campaign(mesh=) differs from the call without one")


def check_campaign_launches(runs, b):
    """Phase 16 (b)'s launches: gather_or once per degree bucket a tick for
    the local batch, tick_update once a tick (the ticks counted by
    coverage_per_slot, once a tick), compress_deltas and scatter_deltas
    once a tick exactly on delta and hub (scatter fewer only after an
    overflow), or_fold and scatter_or once a round on the push-pull
    campaigns."""
    for mode, _ in SHARDED_MODES:
        r = runs[mode]
        res = r["result"]
        n = r["launches"]
        ticks = n["coverage_per_slot"]
        ex = res.extra["exchange"]
        delta = ex["mode"] in ("delta", "hub")
        want = {"gather_or": runs["gathers_per_tick"] * ticks, "tick_update": ticks,
                "compress_deltas": ticks if delta else 0,
                "scatter_deltas": ticks if delta and not ex["overflow_write_ticks"] else None}
        for name, count in want.items():
            if count is not None and n[name] != count:
                raise AssertionError(f"sharded campaign [{mode}]: {name} launched {n[name]} "
                                     f"times in {ticks} ticks, want {count}: {n}")
        if delta and n["scatter_deltas"] > ticks:
            raise AssertionError(f"sharded campaign [{mode}]: scatter_deltas {n}")
    for label, _ in CAMPAIGN_PROTOCOL_MODES:
        r = runs[label]
        res = r["result"]
        n = r["launches"]
        ex = res.extra["exchange"]
        if n["or_fold"] != HORIZON or n["scatter_or"] != HORIZON or n["gather_or"]:
            raise AssertionError(f"sharded campaign [{label}]: or_fold and scatter_or must "
                                 f"launch once a round for all {b} replicas: {n}")
        groups = res.extra["ring"]["delay_splits"]
        if ex["mode"] == "delta" and (n["compress_deltas"] != HORIZON or n["scatter_deltas"]
                                      > HORIZON * groups):
            raise AssertionError(f"sharded campaign [{label}]: exchange kernels {n}")


def sharded_campaign_phase(graph, dg, dgf_edge, cov_set, gossip_set, delays, phase11, dev, rng):
    """Phase 16: (a) the exchange kernels with a replica axis, (b) the
    sharded campaigns on ``torch.cuda.device_count()`` NCCL ranks (one
    rank: a 1 x 1 mesh with rb = 8, in this process) against phase 11's
    single-device campaigns (``phase11``: kind -> CampaignResult, None to
    run them here), (c) gloo ranks on the one card, (d) the coverage
    campaign's ``mesh=``."""
    import torch
    import torch.distributed as dist

    import p2p_gossip_tpu_torch as pt
    from p2p_gossip_tpu_torch.batch import campaign as bc
    from p2p_gossip_tpu_torch.parallel import launch
    from p2p_gossip_tpu_torch.parallel.mesh import initialize_multihost

    t_phase = time.perf_counter()
    b = CAMPAIGN_REPLICAS
    exchange_replicas_ragged(dev, rng)
    kernels_b8 = check_exchange_replicas(graph, dg, gossip_set, dev, reps=10)
    if phase11 is None:
        phase11 = {
            "coverage": bc.run_coverage_campaign(graph, cov_set, HORIZON, device_graph=dg,
                                                 device=dev),
            "pushpull": bc.run_protocol_campaign(graph, gossip_set, HORIZON,
                                                 protocol="pushpull", chunk_size=CHUNK,
                                                 device_graph=dgf_edge, device=dev),
        }
    ranks = torch.cuda.device_count()
    if ranks == 1:
        initialize_multihost(backend="nccl", device=dev)
        try:
            runs = sharded_campaign_worker(graph, cov_set, gossip_set, delays, str(dev), dg)
        finally:
            dist.destroy_process_group()
    else:
        runs = launch.spawn(sharded_campaign_worker, ranks, graph, cov_set, gossip_set, delays,
                            None, backend="nccl")[0]
    refs = campaign_references(graph, cov_set, ranks, phase11, dev)
    check_campaign_results(runs, refs, phase11["coverage"])
    check_campaign_launches(runs, b)
    log(f"sharded campaigns (b): {ranks} NCCL rank(s), mesh {runs['shape']}, R={b} (local "
        f"replicas {runs[SHARDED_MODES[0][0]]['result'].extra['mesh']['local_replicas']}); "
        "every replica == phase 11's single-device campaign (counters, coverage rows); walls "
        "are whole calls")
    for mode, _ in SHARDED_MODES + CAMPAIGN_PROTOCOL_MODES:
        r = runs[mode]
        res = r["result"]
        launched = {k: v for k, v in r["launches"].items() if v}
        log(f"  {mode}: wall {r['wall']:.4f} s, replica 0's solo sharded run "
            f"{r['solo_wall']:.4f} s, wall / (R x solo) {r['wall'] / (b * r['solo_wall']):.3f}; "
            f"exchange {res.extra['exchange']['mode']}; launches {launched}")
        check_resident(f"{mode} campaign", r["peak"], res.extra["resident_bytes"])
    log("  (d) run_coverage_campaign(mesh=) over the NCCL ranks == the call without a mesh")
    gloo_graph = pt.erdos_renyi(GLOO_CAMPAIGN_NODES, EDGE_P * N_NODES / GLOO_CAMPAIGN_NODES,
                                seed=SEED)
    gloo = gloo_campaign_ranks(gloo_graph, 4, GLOO_CAMPAIGN_MESHES, dev)
    log(f"phase 16 took {time.perf_counter() - t_phase:.1f} s")
    return dict(kernels=kernels_b8, runs=runs, gloo=gloo)


# --- phase 17 -----------------------------------------------------------------

SERVE_MESH_EXCHANGES = ("dense", "delta")
SERVE_MESH_KERNELS = ("gather_or", "coverage_per_slot", "compress_deltas", "scatter_deltas",
                      "scatter_or", "or_fold", "popcount_rows", "tick_update")
GLOO_SERVE_MESHES = ((2, 1), (1, 2))  # (replicas, nodes) on 2 ranks, then make_slot_mesh(4)


def _quiet(msg: str) -> None:
    pass


def serve_mesh_worker(graphs, trace, device):
    """Phase 17 (a) and (b), on every rank of the card's NCCL world:
    `make_slot_mesh(SERVE_SLOTS)`, the full trace through a mesh server once
    a SERVE_MESH_EXCHANGES exchange (launches counted by kind of dispatch,
    from a reset just before each drain), a flood and a push-pull dispatch
    of SERVE_SLOTS replicas profiled on the first rank, the peak device
    memory of the trace's largest flood and largest protocol dispatch
    (the mesh admission model's choice) with a fresh server each, staging
    included, and a request over an explicit budget. Every rank makes
    every call; ``device`` None means ``cuda:<rank>``. Returns host
    values."""
    import torch
    import torch.distributed as dist

    from p2p_gossip_tpu_torch.batch.campaign_sharded import _campaign_chunk
    from p2p_gossip_tpu_torch.ops import kernels
    from p2p_gossip_tpu_torch.parallel import launch
    from p2p_gossip_tpu_torch.parallel import protocols_sharded as ps
    from p2p_gossip_tpu_torch.parallel.mesh import make_slot_mesh
    from p2p_gossip_tpu_torch.serve import bench
    from p2p_gossip_tpu_torch.serve.scheduler import mesh_request_cost
    from p2p_gossip_tpu_torch.serve.server import GossipServer

    dev = torch.device(device if device else f"cuda:{dist.get_rank()}")
    cuda = dev.type == "cuda"
    mesh = make_slot_mesh(SERVE_SLOTS, device=dev)
    say = log if mesh.is_first else _quiet
    # A dispatch's kind: flood or protocol, on the ER or the BA topology.
    kind_of = {d["request_id"]: ("flood" if d["protocol"] == "flood" else "protocol")
               + f" {d['topology']['family']}" for d in trace}
    out = {"shape": dict(mesh.shape), "drains": {}}
    for ex in SERVE_MESH_EXCHANGES:
        by_kind: dict = {}
        last = dict.fromkeys(kernels.launches, 0)

        def on_step(step, by_kind=by_kind, last=last):
            if cuda:
                torch.cuda.synchronize()
            kind = kind_of[step["request_ids"][0]]
            got = by_kind.setdefault(kind, dict.fromkeys(kernels.launches, 0))
            for name, count in kernels.launches.items():
                got[name] += count - last[name]
                last[name] = count
            got.setdefault("walls", []).append(step["wall_s"])

        if cuda:
            torch.cuda.synchronize()
        kernels.reset_launches()
        server, summary = bench.run_trace(trace, SERVE_SLOTS, graphs=graphs, log=say,
                                          mesh=mesh, exchange=ex, on_step=on_step)
        if cuda:
            torch.cuda.synchronize()
        launches = dict(kernels.launches)
        out["drains"][ex] = dict(
            summary=summary, launches=launches, by_kind=by_kind,
            results={d["request_id"]: server.result(d["request_id"]) for d in trace})
        del server
        launch.progress()

    # A protocol dispatch stages its ELL on the host on every call: its cost
    # on each topology, alone.
    staging = {}
    for d in trace:
        family = d["topology"]["family"]
        if d["protocol"] == "pushpull" and family not in staging:
            t0 = time.perf_counter()
            ps.stage_partnered(trace_graph(graphs, d), mesh, "pushpull", 2, None, 1,
                               _campaign_chunk(d["shares"], None), "auto", "dense", 2, None)
            staging[family] = time.perf_counter() - t0
    out["protocol_staging_s"] = staging
    profiles = {}
    for kind in ("flood", "pushpull"):
        server = GossipServer(slots=SERVE_SLOTS, mesh=mesh)
        server._graphs.update(graphs)
        server.submit(serve_request(trace, kind, range(1000, 1000 + SERVE_SLOTS),
                                    f"profiled-{kind}"))
        if mesh.is_first and cuda:
            _, wall, by_name, calls = device_events(server.step)
            busy = sum(by_name.values())
            profiles[kind] = dict(wall_s=wall, busy_us=busy,
                                  busy_share=busy / (wall * 1e6) if wall else None,
                                  top=sorted(((us, calls[n], n) for n, us in by_name.items()),
                                             reverse=True)[:6])
        else:
            server.step()
        del server
        launch.progress()

    rs, ns = mesh.shape["replicas"], mesh.shape["nodes"]

    def modeled(d):
        g = trace_graph(graphs, d)
        return mesh_request_cost(_request(d), g.degree, SERVE_SLOTS, rs, ns)["dispatch_bytes"]

    largest = {"flood": max((d for d in trace if d["protocol"] == "flood"), key=modeled),
               "protocol": max((d for d in trace if d["protocol"] != "flood"), key=modeled)}
    memory = {}
    base = device_allocated(cuda)
    for label, d in largest.items():
        req = dict(d, request_id=f"mem-{label}", seeds=list(range(3000, 3000 + SERVE_SLOTS)))
        server = GossipServer(slots=SERVE_SLOTS, mesh=mesh)
        server._graphs.update(graphs)
        steps = []

        def drain(server=server, req=req, steps=steps):
            server.submit(req)
            while (step := server.step()) is not None:
                steps.append(step)

        _, wall, peak = measured_run(drain, base, cuda)
        tag = (f"{d['protocol']}{' lossy' if d.get('loss_prob') else ''}"
               f"{' churn' if d.get('churn_prob') else ''} {d['topology']['family']}")
        memory[label] = dict(peak=peak, model=server._states[req["request_id"]].cost[
            "dispatch_bytes"], runner=steps[0]["resident_bytes"], request=tag, wall_s=wall)
        del server
        launch.progress()
    over = GossipServer(slots=SERVE_SLOTS, mesh=mesh,
                        hbm_budget_bytes=memory["flood"]["model"] - 1)
    over._graphs.update(graphs)
    rid = over.submit(dict(largest["flood"], request_id="over-budget"))
    out.update(profiles=profiles, memory=memory,
               over_budget=(over.status(rid), over.drain()))
    return out


def gloo_serve_worker(trace, meshes, device):
    """Phase 17 (c), on every rank of a gloo world on the one card: the
    reduced trace through a mesh server on each (replicas, nodes) mesh of
    ``meshes`` (slots SERVE_SLOTS), then on `make_slot_mesh(4)` (slots 4).
    Returns each mesh's shape and results by request id."""
    from p2p_gossip_tpu_torch.parallel import launch
    from p2p_gossip_tpu_torch.parallel.mesh import make_mesh, make_slot_mesh
    from p2p_gossip_tpu_torch.serve import bench

    built = [(make_mesh(n, replicas=r, device=device), SERVE_SLOTS) for r, n in meshes]
    built.append((make_slot_mesh(4, device=device), 4))
    out = []
    for mesh, slots in built:
        server, _ = bench.run_trace(trace, slots, log=_quiet, mesh=mesh)
        out.append((dict(mesh.shape), {d["request_id"]: server.result(d["request_id"])
                                       for d in trace}))
        launch.progress()
    return out


def serve_mesh_references(graph, dev):
    """Phase 17's references when phase 13 did not run (``--phase 17``):
    the trace's graphs and the single-device server's results on the card."""
    from p2p_gossip_tpu_torch.serve import bench

    trace = serve_trace()
    graphs = serve_graphs(graph, trace)
    server, summary = bench.run_trace(trace, SERVE_SLOTS, dev, graphs=graphs, log=log)
    results = {d["request_id"]: server.result(d["request_id"]) for d in trace}
    return dict(summary=summary, results=results, graphs=graphs)


def check_serve_mesh(out, serve13):
    """Phase 17 (b)'s checks on one rank's worker result: every request of
    each drain bitwise phase 13's, every SERVE_MESH_KERNELS kernel launched
    (the exchange kernels on the delta drain), peaks within MEMORY_TOLERANCE
    of the mesh admission model, the over-budget request rejected."""
    from p2p_gossip_tpu_torch.serve import bench

    for ex, drain in out["drains"].items():
        bad = [rid for rid, want in serve13["results"].items()
               if not bench.same_result(drain["results"][rid], want)]
        if bad:
            raise AssertionError(f"serve mesh [{ex}]: {bad} differ from phase 13's results")
        n = drain["launches"]
        need = [k for k in SERVE_MESH_KERNELS
                if ex == "delta" or k not in ("compress_deltas", "scatter_deltas")]
        if any(n[k] == 0 for k in need):
            raise AssertionError(f"serve mesh [{ex}]: a kernel of the path was not launched: "
                                 f"{n}")
    for label, m in out["memory"].items():
        check_resident(f"serve mesh memory[{label}: {m['request']}, {SERVE_SLOTS} slots, "
                       "staging included, the mesh admission model]", m["peak"], m["model"])
    if out["over_budget"] != ("rejected", 0):
        raise AssertionError(f"serve mesh: the over-budget request was not rejected: "
                             f"{out['over_budget']}")


def gloo_serve_ranks(dev):
    """Phase 17 (c): two gloo ranks on the one card, the reduced trace on
    each GLOO_SERVE_MESHES mesh and `make_slot_mesh(4)`, every request equal
    to the single-device server's on the card."""
    from p2p_gossip_tpu_torch.parallel import launch
    from p2p_gossip_tpu_torch.serve import bench

    trace = serve_trace(SERVE_REDUCED_NODES, 10, 256, 32)
    want, _ = bench.run_trace(trace, SERVE_SLOTS, dev, log=_quiet)
    t0 = time.perf_counter()
    results = launch.spawn(gloo_serve_worker, 2, trace, GLOO_SERVE_MESHES, GLOO_DEVICE,
                           backend="gloo")
    wall = time.perf_counter() - t0
    for rank_out in results:
        for shape, got in rank_out:
            bad = [d["request_id"] for d in trace
                   if not bench.same_result(got[d["request_id"]], want.result(d["request_id"]))]
            if bad:
                raise AssertionError(f"gloo serve mesh {shape}: {bad} differ from the "
                                     "single-device server")
    shapes = [shape for shape, _ in results[0]]
    log(f"serve mesh (c): 2 gloo ranks, meshes {shapes} (replicas x nodes), {len(trace)} "
        f"requests (N={SERVE_REDUCED_NODES}) each: every request equals the single-device "
        f"server's on the card ({wall:.1f} s, host transport, not a speed)")
    return shapes


def scale_mesh(ba, scale12, dev):
    """Phase 17 (d): ``scale.py --mesh 1x1`` in-process on one NCCL rank, on
    phase 12's 1M BA graph through an npz cache (removed afterwards):
    processed, full coverage, the ttc99 median and max and the coverage rows
    equal phase 12's single-device flood; the rank's peak device memory
    within MEMORY_TOLERANCE of the sharded runner's ``resident_bytes``."""
    import contextlib
    import hashlib
    import io

    import torch.distributed as dist

    from p2p_gossip_tpu_torch import scale
    from p2p_gossip_tpu_torch.models.topology import load_or_build_graph_cache
    from p2p_gossip_tpu_torch.parallel.mesh import default_backend, initialize_multihost

    graph = ba["graph"]
    cache_dir = os.path.join("p2p_gossip_tpu_torch", "build", "phase17")
    os.makedirs(cache_dir, exist_ok=True)
    cache = os.path.join(cache_dir, "ba_mesh.npz")
    argv = ["--topology", "ba", "--nodes", str(graph.n), "--baM", str(SCALE_BA_M), "--prob", "0",
            "--shares", str(SCALE_ORIGINS), "--horizon", str(HORIZON), "--seed", str(SEED),
            "--cache", cache, "--mesh", "1x1"] + (["--cpu"] if dev.type == "cpu" else [])
    out, err = io.StringIO(), io.StringIO()
    try:
        load_or_build_graph_cache(cache, topology="ba", nodes=graph.n, prob=0.0,
                                  ba_m=SCALE_BA_M, seed=SEED, build=lambda: graph, log=_quiet)
        initialize_multihost(backend=default_backend(dev), device=dev)
        try:
            with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
                rc = scale.main(argv)
        finally:
            dist.destroy_process_group()
    finally:
        if os.path.exists(cache):
            os.remove(cache)
    rec = json.loads(next(ln for ln in err.getvalue().splitlines()
                          if ln.startswith("scale-record: "))[len("scale-record: "):])
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    want_sha = hashlib.sha256(np.asarray(ba["coverage"], dtype=np.int64).tobytes()).hexdigest()
    if rc or "(1x1 mesh)" not in line["metric"]:
        raise AssertionError(f"scale --mesh 1x1: exit {rc}, {line}")
    if not (rec["processed"] == SCALE_ORIGINS * graph.n and rec["full_coverage"]
            and rec["ttc99_median"] == scale12["ttc99_median"]
            and rec["ttc99_max"] == scale12["ttc99_max"]
            and rec["coverage_sha256"] == want_sha):
        raise AssertionError(f"scale --mesh 1x1 differs from phase 12's BA flood: {rec}")
    peak, model = rec["rank_peak_device_bytes"][0], rec["rank_resident_bytes"][0]
    log(f"scale --mesh 1x1 (1M BA, {SCALE_ORIGINS} shares, one NCCL rank): processed, full "
        f"coverage, ttc99 median {rec['ttc99_median']} / max {rec['ttc99_max']} and the "
        f"coverage rows == phase 12's single-device flood; {rec['ticks']} ticks, wall "
        f"{rec['wall_s']:.4f} s -> {rec['ms_per_tick']:.2f} ms/tick, "
        f"{rec['node_updates_per_s']:.4e} node-updates/s (phase 12: {scale12['wall_s']:.4f} s, "
        f"{scale12['ms_per_tick']:.2f} ms/tick, {scale12['rate']:.4e}); stage_s "
        f"{rec['stage_s']:.2f} (phase 12 {scale12['stage_s']:.2f}); cache load "
        f"{rec['cache_load_s']:.2f} s; rank RSS peak {rec['rank_rss_peak_bytes'][0] / 2**30:.2f} "
        "GiB")
    check_resident("scale --mesh 1x1 rank 0", peak, model)
    return rec


def serve_mesh_phase(serve13, ba, scale12, dev):
    """Phase 17: (a) `make_slot_mesh(SERVE_SLOTS)` on the card's NCCL ranks
    (one rank: 1 x 1, in this process), (b) the phase-13 trace through
    ``GossipServer(mesh=...)`` with the dense and the delta exchange, every
    request bitwise phase 13's (``serve13``), (c) two gloo ranks on the card,
    (d) ``scale.py --mesh 1x1`` on phase 12's 1M BA graph (``ba``, with its
    flood ``scale12``)."""
    import torch
    import torch.distributed as dist

    from p2p_gossip_tpu_torch.parallel import launch
    from p2p_gossip_tpu_torch.parallel.mesh import initialize_multihost

    t_phase = time.perf_counter()
    trace = serve_trace()
    graphs = serve13["graphs"]
    ranks = torch.cuda.device_count()
    if ranks == 1:
        initialize_multihost(backend="nccl", device=dev)
        try:
            out = serve_mesh_worker(graphs, trace, str(dev))
        finally:
            dist.destroy_process_group()
    else:
        out = launch.spawn(serve_mesh_worker, ranks, graphs, trace, None, backend="nccl")[0]
    log(f"serve mesh (a): make_slot_mesh({SERVE_SLOTS}) on {ranks} NCCL rank(s): "
        f"{out['shape']} (replicas x nodes)")
    check_serve_mesh(out, serve13)
    s13 = serve13["summary"]
    for ex, drain in out["drains"].items():
        s = drain["summary"]
        log(f"serve mesh (b) [{ex}]: {s['requests']} requests in {s['dispatches']} dispatches, "
            f"{s['wall_s']:.3f} s -> {s['requests_per_s']:.3f} requests/s (phase 13: "
            f"{s13['requests_per_s']:.3f}); p50 {s['p50_turnaround_s']:.4f} / p99 "
            f"{s['p99_turnaround_s']:.4f} s (phase 13: {s13['p50_turnaround_s']:.4f} / "
            f"{s13['p99_turnaround_s']:.4f}); occupancy {s['slot_occupancy']:.4f} (phase 13: "
            f"{s13['slot_occupancy']:.4f}); {s['ms_per_dispatch']:.2f} ms a dispatch (phase "
            f"13: {s13['ms_per_dispatch']:.2f}); every request == phase 13's")
        for kind, n in drain["by_kind"].items():
            walls = n["walls"]
            log(f"  {kind} dispatches: {len(walls)}, {1e3 * float(np.mean(walls)):.2f} ms "
                f"each; launches {({k: v for k, v in n.items() if k != 'walls' and v})}")
    for kind, p in out["profiles"].items():
        log(f"  profile ({kind} dispatch, {SERVE_SLOTS} replicas, wall {p['wall_s'] * 1e3:.2f} "
            f"ms): device busy {p['busy_us'] / 1e3:.2f} ms = {p['busy_share']:.3f} of wall")
        for us, calls, name in p["top"]:
            log(f"    {us / 1e3:9.3f} ms  x{calls:<5d} {name[:100]}")
    log("  a protocol dispatch's host staging of its ELL (every call), alone: "
        + ", ".join(f"{fam} {sec:.3f} s" for fam, sec in out["protocol_staging_s"].items()))
    log(f"  a request modeled at {out['memory']['flood']['model']} bytes a rank against a "
        f"budget of {out['memory']['flood']['model'] - 1} is rejected on every rank")
    shapes = gloo_serve_ranks(dev)
    rec = scale_mesh(ba, scale12, dev)
    record = {
        "mesh": out["shape"],
        **{f"serve_{ex}": {k: d["summary"][k] for k in (
            "requests_per_s", "p50_turnaround_s", "p99_turnaround_s", "slot_occupancy",
            "ms_per_dispatch", "dispatches", "wall_s")} for ex, d in out["drains"].items()},
        "phase13": {k: s13[k] for k in ("requests_per_s", "p50_turnaround_s",
                                        "p99_turnaround_s", "slot_occupancy",
                                        "ms_per_dispatch", "dispatches")},
        "launches_by_kind": {ex: {kind: {k: v for k, v in n.items() if k != "walls" and v}
                                  for kind, n in d["by_kind"].items()}
                             for ex, d in out["drains"].items()},
        "busy_share": {k: p["busy_share"] for k, p in out["profiles"].items()},
        "dispatch_ms_by_kind": {ex: {kind: 1e3 * float(np.mean(n["walls"]))
                                     for kind, n in d["by_kind"].items()}
                                for ex, d in out["drains"].items()},
        "protocol_staging_s": out["protocol_staging_s"],
        "memory": {k: {"peak": m["peak"], "model": m["model"], "runner": m["runner"]}
                   for k, m in out["memory"].items()},
        "gloo_meshes": shapes,
        "scale_mesh_1x1": {k: rec[k] for k in ("wall_s", "ms_per_tick", "node_updates_per_s",
                                               "stage_s", "ticks")},
    }
    log(json.dumps({"phase17": record}))
    log(f"phase 17 took {time.perf_counter() - t_phase:.1f} s")
    return out


# --- phase 18: the divergence bisector and the protocol comparison ----------

# (a): the bisector at its defaults. Tick 4 lies in every pair's streams
# (the flood campaigns' end at tick 6); at tick 7 the reports must equal
# the CPU's, which, as the JAX script's, miss on those two pairs.
BISECT_FAULT_TICK = 4
BISECT_LATE_FAULT_TICK = 7
# (b): the host-side pairs at full width, by pair (the solo flood's chunk
# is the whole schedule, so each run is one digest stream). The push-pull
# campaign runs its shares in passes of 128 with a stream each, so 128
# shares is the widest pair it forms; the event engine is host Python.
BISECT_FULL = {
    "native-sync": dict(n=2000, p=0.005, shares=64, horizon=32, chunk=64),
    "sync-campaign": dict(n=N_NODES, p=EDGE_P, shares=4096, horizon=HORIZON, chunk=4096),
    "pushpull-campaign": dict(n=N_NODES, p=EDGE_P, shares=128, horizon=HORIZON, chunk=128),
}
# (b): the sharded pairs on 4 gloo ranks at phase 16 (c)'s size.
BISECT_SHARDED_FULL = dict(n=GLOO_CAMPAIGN_NODES, p=EDGE_P * N_NODES / GLOO_CAMPAIGN_NODES,
                           shares=GLOO_CAMPAIGN_SHARES, horizon=GLOO_CAMPAIGN_HORIZON,
                           chunk=GLOO_CAMPAIGN_SHARES)
# (c): the protocol comparison's defaults (N = 2,000), and docs/RESULTS.md's
# on-chip configuration.
COMPARE_FULL = dict(nodes=N_NODES, prob=EDGE_P, shares=64, horizon=96, fanout=3)
BISECT_FULL_KERNELS = {"native-sync": ("gather_or", "tick_digest"),
                       "sync-campaign": ("gather_or", "coverage_per_slot", "tick_digest"),
                       "pushpull-campaign": ("scatter_or", "coverage_per_slot", "tick_digest")}
BISECT_CARD_KERNELS = ("gather_or", "coverage_per_slot", "scatter_or", "tick_digest")
BISECT_WORLD_KERNELS = ("gather_or", "tick_digest", "compress_deltas", "scatter_deltas")
COMPARE_KERNELS = ("gather_or", "coverage_per_slot", "scatter_or")


def bisect_args(**flags):
    """The bisector's flags: its defaults, with ``flags`` set."""
    from p2p_gossip_tpu_torch import divergence

    args = divergence.parse_args([])
    for key, value in flags.items():
        setattr(args, key, value)
    return args


def bisect_world(jobs):
    """Phase 18's spawned world of 4 gloo ranks: for each ``(names, flags,
    device)`` job, the sharded pairs' streams (on the first rank), each
    pair's wall and this rank's kernel launches in the job."""
    from p2p_gossip_tpu_torch import divergence
    from p2p_gossip_tpu_torch.ops import kernels

    meshes: dict = {}
    out = []
    for names, flags, device in jobs:
        mesh_set = meshes.setdefault(device, divergence.Meshes(device))
        kernels.reset_launches()
        streams, walls = {}, {}
        for name in names:
            t0 = time.perf_counter()
            streams.update(divergence.world_pairs([name], flags, device, mesh_set))
            walls[name] = time.perf_counter() - t0
        out.append(dict(streams=streams, walls=walls, launches=dict(kernels.launches)))
    return out


def check_kernel_launches(label, launches, names, on_card):
    """On the card every kernel of ``names`` launched; on the CPU none did."""
    bad = {n: launches[n] for n in names if (launches[n] > 0) != on_card}
    if bad:
        raise RuntimeError(f"{label}: launches {bad}, expected "
                           f"{'> 0 (the card)' if on_card else '0 (the CPU)'}")


def check_clean(label, name, report):
    if report.get("diverged") or not report.get("compared"):
        raise RuntimeError(f"{label}: pair {name} diverged at tick {report.get('tick')} "
                           f"({report.get('compared')} ticks compared): {report}")


def check_same_streams(name, card, cpu):
    from p2p_gossip_tpu_torch.telemetry import compare

    for side, got, want in (("a", card[0], cpu[0]), ("b", card[1], cpu[1])):
        if got != want:
            div = compare.first_divergence(got, want)
            raise RuntimeError(f"phase 18 (a): pair {name} stream {side} on the card differs "
                               f"from the CPU's at tick {div.tick} ({len(got)} / "
                               f"{len(want)} ticks)")


def bisect_phase(dev):
    """Phase 18 (a) and (b): the divergence bisector at its defaults on the
    card, against the same pairs on the CPU and with faults injected, then
    at full width. The sharded pairs of all three runs come from one world
    of 4 gloo ranks, which runs while this process runs the host-side
    pairs of (a)."""
    import contextlib
    import io
    from concurrent.futures import ThreadPoolExecutor

    from p2p_gossip_tpu_torch import divergence
    from p2p_gossip_tpu_torch.ops import kernels
    from p2p_gossip_tpu_torch.parallel import launch

    t_phase = time.perf_counter()
    card, on_card = str(dev), dev.type == "cuda"
    host_pairs = [name for name in divergence.PAIRS if name not in divergence.SHARDED_PAIRS]
    sharded = list(divergence.SHARDED_PAIRS)
    jobs = [(sharded, vars(bisect_args()), card), (sharded, vars(bisect_args()), "cpu"),
            (sharded, vars(bisect_args(**BISECT_SHARDED_FULL)), card)]
    with ThreadPoolExecutor(1) as pool:
        world = pool.submit(launch.spawn, bisect_world, divergence.WORLD, jobs)
        streams, launches = {}, {}
        for side, device in (("card", card), ("cpu", "cpu")):
            args = bisect_args(device=device)
            kernels.reset_launches()
            streams[side] = {name: divergence.pair_streams(name, args) for name in host_pairs}
            launches[side] = dict(kernels.launches)
        # The entry point a user calls, on the card, host-side pairs only
        # (the sharded ones would start a second world).
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = divergence.main(["--device", card, "--json",
                                  *(f for name in host_pairs for f in ("--pair", name))])
        cli = json.loads(out.getvalue().strip().splitlines()[-1])
        if rc != 0 or not cli["ok"]:
            raise RuntimeError(f"phase 18 (a): the bisector's CLI on the card: {cli}")
        ranks = world.result()
    world_s = time.perf_counter() - t_phase
    check_kernel_launches("phase 18 (a) card", launches["card"], BISECT_CARD_KERNELS, on_card)
    check_kernel_launches("phase 18 (a) cpu", launches["cpu"], BISECT_CARD_KERNELS, False)
    for label, job, card_job in (("small card", 0, on_card), ("small cpu", 1, False),
                                 ("full card", 2, on_card)):
        for r, rank in enumerate(ranks):
            check_kernel_launches(f"phase 18 world {label} rank {r}", rank[job]["launches"],
                                  BISECT_WORLD_KERNELS, card_job)
    for side, job in (("card", 0), ("cpu", 1)):
        streams[side].update(ranks[0][job]["streams"])

    # (a): clean, equal to the CPU digest for digest, faults located.
    reports = {}
    for name in divergence.PAIRS:
        check_same_streams(name, streams["card"][name], streams["cpu"][name])
        clean = divergence.run_pair(name, bisect_args(device=card), streams["card"][name])
        check_clean("phase 18 (a)", name, clean)
        fault = divergence.run_pair(name, bisect_args(device=card,
                                                      inject_fault=BISECT_FAULT_TICK),
                                    streams["card"][name])
        if not fault.get("fault_located") or fault["located_tick"] != BISECT_FAULT_TICK:
            raise RuntimeError(f"phase 18 (a): pair {name} missed the fault at tick "
                               f"{BISECT_FAULT_TICK}: {fault}")
        late = [divergence.run_pair(name, bisect_args(device=device,
                                                      inject_fault=BISECT_LATE_FAULT_TICK),
                                    streams[side][name])
                for side, device in (("card", card), ("cpu", "cpu"))]
        if late[0] != late[1]:
            raise RuntimeError(f"phase 18 (a): pair {name} at tick {BISECT_LATE_FAULT_TICK}: "
                               f"card {late[0]} != cpu {late[1]}")
        reports[name] = dict(compared=clean["compared"],
                             ticks=[len(s) for s in streams["card"][name]],
                             late_located=late[0].get("fault_located"))
        log(f"phase 18 (a) {name}: clean over {clean['compared']} ticks, card == cpu "
            f"digest for digest, fault at tick {BISECT_FAULT_TICK} located; tick "
            f"{BISECT_LATE_FAULT_TICK}: {divergence.format_report(late[0])}")

    # (b): full width. The sharded pairs came from the world's third job.
    walls = {}
    for name in sharded:
        check_clean("phase 18 (b)", name,
                    divergence.run_pair(name, bisect_args(**BISECT_SHARDED_FULL),
                                        ranks[0][2]["streams"][name]))
        walls[name] = ranks[0][2]["walls"][name]
        log(f"phase 18 (b) {name}: clean at N={BISECT_SHARDED_FULL['n']} "
            f"({BISECT_SHARDED_FULL['shares']} shares, horizon "
            f"{BISECT_SHARDED_FULL['horizon']}, 4 gloo ranks on {card}), "
            f"{walls[name]:.2f} s")
    for name in host_pairs:
        flags = BISECT_FULL[name]
        kernels.reset_launches()
        t0 = time.perf_counter()
        report = divergence.run_pair(name, bisect_args(device=card, **flags))
        walls[name] = time.perf_counter() - t0
        check_clean("phase 18 (b)", name, report)
        check_kernel_launches(f"phase 18 (b) {name}", kernels.launches,
                              BISECT_FULL_KERNELS[name], on_card)
        log(f"phase 18 (b) {name}: clean over {report['compared']} ticks at N={flags['n']} "
            f"({flags['shares']} shares, horizon {flags['horizon']}), {walls[name]:.2f} s")
    record = dict(pairs_a=reports, world_s=world_s, walls_b_s=walls,
                  sizes_b=dict(BISECT_FULL, sharded=BISECT_SHARDED_FULL))
    log(json.dumps({"phase18_bisect": record}))
    log(f"phase 18 (a)-(b) took {time.perf_counter() - t_phase:.1f} s")
    return record


def compare_phase(dev):
    """Phase 18 (c): the protocol comparison at its defaults on the card
    and on the CPU (equal rows apart from ``wall_s``), then at
    docs/RESULTS.md's on-chip configuration, its table printed."""
    from p2p_gossip_tpu_torch import protocol_compare
    from p2p_gossip_tpu_torch.ops import kernels

    import p2p_gossip_tpu_torch as pt

    t_phase = time.perf_counter()
    on_card = dev.type == "cuda"
    rows = {}
    for side, device in (("card", str(dev)), ("cpu", "cpu")):
        kernels.reset_launches()
        rows[side] = protocol_compare.compare_protocols(
            protocol_compare.parse_args(["--device", device]))
        check_kernel_launches(f"phase 18 (c) {side}", kernels.launches, COMPARE_KERNELS,
                              on_card and side == "card")
    strip = [[{k: v for k, v in r.items() if k != "wall_s"} for r in rows[side]]
             for side in ("card", "cpu")]
    if strip[0] != strip[1]:
        raise RuntimeError(f"phase 18 (c): card rows {strip[0]} != cpu rows {strip[1]}")
    log(f"phase 18 (c): the comparison's rows at N=2000 equal on {dev} and the CPU; walls "
        + ", ".join(f"{r['protocol']} {r['wall_s']} s / {c['wall_s']} s"
                    for r, c in zip(rows["card"], rows["cpu"])))
    argv = ["--device", str(dev)] + [f for k, v in COMPARE_FULL.items()
                                     for f in (f"--{k}", str(v))]
    args = protocol_compare.parse_args(argv)
    graph = pt.erdos_renyi(args.nodes, args.prob, seed=args.seed)
    kernels.reset_launches()
    full = protocol_compare.compare_protocols(args, graph)
    check_kernel_launches("phase 18 (c) full", kernels.launches, COMPARE_KERNELS, on_card)
    log(protocol_compare.format_table(args, graph, full))
    record = dict(rows_2000=rows, rows_full=full, config_full=COMPARE_FULL)
    log(json.dumps({"phase18_compare": record}))
    log(f"phase 18 (c) took {time.perf_counter() - t_phase:.1f} s")
    return record


# --- phase 19: the benchmark entry point -------------------------------------

BENCH_REPEATS = 3
# Legs 1-4's kernels: the flood's three and the campaign's coverage count.
BENCH_KERNELS = ("gather_or", "sector_occupancy", "tick_update", "coverage_per_slot")
BENCH_TIMEOUT_S = 600


def bench_config() -> dict:
    """The bench's headline sizes at this script's (phase 5's) workload."""
    return dict(nodes=N_NODES, prob=EDGE_P, shares=N_SHARES, gen_window=GEN_WINDOW,
                horizon=HORIZON, chunk=CHUNK)


def check_bench_row(row, phase5, launches, on_card) -> None:
    """Phase 19's checks of the bench row its legs 1-4 made on phase 5's
    workload (``phase5``: the main path's timed run): the documented keys,
    phase 5's ticks and node-updates, ``value`` the median of
    `BENCH_REPEATS` rates, the card named, and the kernels launched on the
    card (none on the CPU)."""
    from p2p_gossip_tpu_torch import bench

    if set(row) != set(bench.ROW_KEYS):
        raise AssertionError(f"bench row keys {sorted(row)} are not the documented "
                             f"{sorted(bench.ROW_KEYS)}")
    if row["ticks"] != phase5.extra["ticks_executed"]:
        raise AssertionError(f"bench ticks {row['ticks']} != phase 5's "
                             f"{phase5.extra['ticks_executed']}")
    if row["processed"] != phase5.totals()["processed"]:
        raise AssertionError(f"bench processed {row['processed']} != phase 5's")
    if len(row["runs"]) != BENCH_REPEATS or row["value"] != float(np.median(row["runs"])):
        raise AssertionError(f"bench value {row['value']} is not the median of {row['runs']}")
    if on_card and not (row["device"] and row["power_limit"] and row["pct_hbm_peak"]):
        raise AssertionError(f"bench row does not name the card: {row['device']}, "
                             f"{row['power_limit']}, pct_hbm_peak {row['pct_hbm_peak']}")
    check_kernel_launches("phase 19", launches, BENCH_KERNELS, on_card)


def bench_phase(graph, dg, sched, dev, phase5):
    """Phase 19 in the default run: the bench's legs 1-4 (headline with
    the roofline, baseline, flood campaign) in this process on phase 5's
    graph, schedule and staging, each timed run's per-node counters and
    ticks required equal to ``phase5`` (the main path's timed run).
    Returns the row and the legs' kernel launches."""
    import torch

    from p2p_gossip_tpu_torch import bench
    from p2p_gossip_tpu_torch.ops import kernels

    t_phase = time.perf_counter()
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.synchronize()
    kernels.reset_launches()
    head = bench.headline(graph, sched, dg, bench_config(), BENCH_REPEATS, dev,
                          reference=phase5)
    row = dict(head, **bench.baseline(graph, sched, HORIZON, head["value"]))
    row["campaign"] = bench.campaign(dev)
    launches = dict(kernels.launches)
    # staticcheck_ok: null here, as the mesh legs are; phase 20 runs the gate
    # itself, on the card.
    row.update(dict.fromkeys(bench.MESH_LEGS), serve=None, protocol_campaign=None,
               telemetry=bench.telemetry_summary(), staticcheck_ok=None)
    check_bench_row(row, phase5, launches, on_card)
    c = row["campaign"]
    log(f"bench (phase 19) on {row['device']}, {row['power_limit']}: median "
        f"{row['value']:.6e} node-updates/s of runs {row['runs']} (spread {row['spread']:.4f}), "
        f"{row['ms_per_tick']:.4f} ms/tick, {row['ticks']} ticks == phase 5's, every run's "
        f"counters == phase 5's; achieved {row['achieved_gbps']} GB/s of must-move bytes = "
        f"{row['pct_hbm_peak']} % of 3,350 GB/s; vs_baseline {row['vs_baseline']:.2f}; campaign "
        f"R={c['replicas']} {c['value']:.4e} node-updates/s, {c['wall_s']:.4f} s, warm loop "
        f"{c['warm_loop_wall_s']:.4f} s; launches {launches}")
    log(f"phase 19 took {time.perf_counter() - t_phase:.1f} s")
    return dict(row=row, launches=launches)


def check_bench_whole(row, ticks) -> None:
    """``--phase 19``'s checks of the whole bench's row: full coverage at
    bench.py's size, ``ticks`` (a flood's of the bench's graph), every
    sharded-campaign replica bitwise, the serve leg bitwise, every
    exchange family ok, the card named."""
    from p2p_gossip_tpu_torch import bench

    bad = []
    if set(row) != set(bench.ROW_KEYS):
        bad.append(f"keys {sorted(set(row) ^ set(bench.ROW_KEYS))}")
    if row.get("processed") != N_SHARES * N_NODES:
        bad.append(f"processed {row.get('processed')} != {N_SHARES * N_NODES}")
    if row.get("ticks") != ticks:
        bad.append(f"ticks {row.get('ticks')} != {ticks}")
    if len(row.get("runs") or []) < BENCH_REPEATS:
        bad.append(f"runs {row.get('runs')}")
    cs = row.get("campaign_sharded") or {}
    if not cs or cs.get("bitwise_equal_replicas") != cs.get("replicas"):
        bad.append(f"campaign_sharded {cs.get('bitwise_equal_replicas')} of "
                   f"{cs.get('replicas')} replicas bitwise")
    if (row.get("serve") or {}).get("bitwise_ok") is not True:
        bad.append(f"serve bitwise_ok {(row.get('serve') or {}).get('bitwise_ok')}")
    families = (row.get("exchange") or {}).get("families") or []
    if not families or not all(f.get("ok") for f in families):
        bad.append(f"exchange families {[(f.get('family'), f.get('ok')) for f in families]}")
    if len((row.get("async_ticks") or {}).get("legs") or []) != 2 + len(bench.ASYNC_KS):
        bad.append("async_ticks legs")
    if not (row.get("device") and row.get("power_limit")):
        bad.append(f"device {row.get('device')}, power_limit {row.get('power_limit')}")
    if row.get("staticcheck_ok") is not True:
        bad.append(f"staticcheck_ok {row.get('staticcheck_ok')}")
    if bad:
        raise AssertionError("python -m p2p_gossip_tpu_torch.bench: " + "; ".join(bad))


def check_staticcheck(cpu: dict, card: dict, on_card: bool) -> list[str]:
    """Phase 20's cross-checks of the card's audit against the CPU's, per
    entry: host reads a tick equal; syncs CUDA flagged within the budget
    of the CPU audit's host reads and stagings; the kernels launched the
    plain twins the CPU audit called. On the CPU (a rehearsal) both sides
    ran the plain twins and flagged no sync."""
    bad = []
    want = {r["entry"]: r for r in cpu["entries"]}
    for r in card["entries"]:
        c = want.get(r["entry"])
        if c is None:
            bad.append(f"{r['entry']}: no CPU audit")
            continue
        if r.get("host_reads_per_tick") != c.get("host_reads_per_tick"):
            bad.append(f"{r['entry']}: {r.get('host_reads_per_tick')} host reads a tick on "
                       f"the card, {c.get('host_reads_per_tick')} on the CPU")
        if on_card and r.get("syncs") is not None and r["syncs"] > c["host_reads"] + c["h2d"]:
            bad.append(f"{r['entry']}: {r['syncs']} syncs flagged, budget "
                       f"{c['host_reads']} host reads + {c['h2d']} stagings "
                       f"(at {r.get('sync_sites')})")
        if set(r.get("kernels") or {}) != set(c.get("kernels") or {}):
            bad.append(f"{r['entry']}: launched {sorted(r.get('kernels') or {})}, its CPU "
                       f"audit's plain twins {sorted(c.get('kernels') or {})}")
    return bad


def staticcheck_phase(dev) -> dict:
    """Phase 20: the static-analysis gate on ``dev``
    (`p2p_gossip_tpu_torch.staticcheck`), beside the same audit on the CPU.
    Raises on any violation or disagreement (`check_staticcheck`) and on a
    kernel no entry launched. Returns the ``staticcheck`` line's record
    and the launches by kernel summed over the entries."""
    import concurrent.futures

    import torch
    import torch.distributed as dist

    from p2p_gossip_tpu_torch.parallel import launch
    from p2p_gossip_tpu_torch.parallel.mesh import default_backend, initialize_multihost
    from p2p_gossip_tpu_torch.staticcheck import op_audit, restage, telemetry_off

    t_phase = time.perf_counter()
    on_card = dev.type == "cuda"
    mode = torch.cuda.get_sync_debug_mode() if on_card else None
    # The sharded entries' CPU audit runs beside the card's, in two halves,
    # each in a world of one gloo rank (the card's sharded entries run on
    # one rank); the single-device entries' CPU audit runs here after the
    # card's.
    pool = concurrent.futures.ThreadPoolExecutor(2)
    cpu_worlds = [pool.submit(launch.spawn, op_audit.sharded_audit, 1, "cpu", False, (k, 2))
                  for k in range(2)]
    split = {}
    t0 = time.perf_counter()
    card = op_audit.run_audit(device=str(dev), sync_debug=on_card)
    split["card_audit"] = time.perf_counter() - t0
    tel = telemetry_off.run_telemetry_check(device=str(dev))
    build = restage.build_sentinel() if on_card else {"violations": []}
    split["telemetry_build"] = time.perf_counter() - t0 - split["card_audit"]
    initialize_multihost(backend=default_backend(dev), device=dev)
    try:
        sharded = op_audit.sharded_audit(str(dev), on_card)
    finally:
        dist.destroy_process_group()
    split["sharded"] = time.perf_counter() - t0 - sum(split.values())
    cpu = op_audit.run_audit(device="cpu")
    split["cpu_audit"] = time.perf_counter() - t0 - sum(split.values())
    halves = [f.result()[0] for f in cpu_worlds]
    pool.shutdown()
    cpu_sharded = dict(entries=[r for h in halves for r in h["entries"]],
                       violations=[v for h in halves for v in h["violations"]],
                       telemetry=dict(violations=[v for h in halves
                                                  for v in h["telemetry"]["violations"]]))
    split["cpu_wait"] = time.perf_counter() - t0 - sum(split.values())
    split["cpu_audits"] = sum(r["wall_s"] for r in cpu["entries"] + cpu_sharded["entries"])
    if on_card and torch.cuda.get_sync_debug_mode() != mode:
        raise RuntimeError("phase 20: the sync-debug mode was not restored")
    violations = (cpu["violations"] + card["violations"] + tel["violations"]
                  + build["violations"] + sharded["violations"]
                  + sharded["telemetry"]["violations"] + cpu_sharded["violations"]
                  + cpu_sharded["telemetry"]["violations"])
    entries = card["entries"] + sharded["entries"]
    violations += op_audit.kernel_coverage(entries)
    bad = [f"[{v['rule']}] {v.get('entry', '')} {v['message']}" for v in violations]
    bad += check_staticcheck(dict(entries=cpu["entries"] + cpu_sharded["entries"]),
                             dict(entries=entries), on_card)
    if bad:
        raise RuntimeError("phase 20: the static-analysis gate failed:\n  "
                           + "\n  ".join(bad))
    launches: dict = {}
    for r in entries:
        for name, n in (r.get("kernels") or {}).items():
            launches[name] = launches.get(name, 0) + n
    record = {r["entry"]: {"host_reads_per_tick": r["host_reads_per_tick"],
                           "syncs": r["syncs"], "launches": r["kernels"]} for r in entries}
    wall = time.perf_counter() - t_phase
    log(f"phase 20: {len(entries)} entries ({sharded['entries_audited']} sharded on one "
        f"{default_backend(dev)} rank), {tel['pairs_checked']} + "
        f"{sharded['telemetry']['pairs_checked']} telemetry pairs, clean; host reads a tick "
        f"equal to the CPU audit's; second build {build.get('second_build_s')} s; "
        f"launches {launches}")
    log(f"phase 20 took {wall:.1f} s: " + ", ".join(f"{k} {v:.1f} s" for k, v in split.items()))
    return dict(record=record, launches=launches, wall_s=wall)


# --- phase 21: the tick update ------------------------------------------------

# (N, W, S): burst32k's flood (100,000 nodes, 32,768 shares) and
# coverage4k's (10^6 nodes, 4,096 origins), S the generation events a tick
# carries; then ragged shapes.
TICK_UPDATE_SHAPES = ((100_000, 1024, 32_768), (1_000_000, 128, 4_096))
TICK_UPDATE_RAGGED = ((777, 3), (1000, 1), (513, 4), (4099, 33))
# A sparse frontier's 16-byte units of arrivals kept (the rest zero).
TICK_UPDATE_SPARSE = 0.05


def tick_update_inputs(rng, n, w, s, dev, sparse=None):
    """A tick's update inputs: random seen; arrivals random words, or with
    only a ``sparse`` share of their 16-byte units kept; S events on random
    rows (pairs sharing a word, bit 31 among them, a sixteenth active, one
    row out of range); counters near 2^31 so they wrap; degrees up to
    1,000."""
    import torch

    seen = random_words(rng, (n, w), dev)
    arrivals = random_words(rng, (n, w), dev)
    if sparse is not None:
        keep = rng.random((n, -(-w // 4))) < sparse
        mask = torch.as_tensor(np.repeat(keep, 4, axis=1)[:, :w], device=dev)
        arrivals = torch.where(mask, arrivals, 0)
    rows = rng.integers(0, n, s)
    rows[1::2] = rows[0::2][: s // 2]  # slots 2k and 2k + 1 share a word
    rows[-1] = n  # dropped
    slots = np.arange(s) % (32 * w)
    active = rng.random(s) < 1 / 16
    active[31 % s] = True
    i32 = lambda a: torch.as_tensor(np.asarray(a, dtype=np.int32), device=dev)  # noqa: E731
    return dict(
        seen=seen, arrivals=arrivals,
        rows=torch.as_tensor(rows, dtype=torch.int64, device=dev),
        slots=torch.as_tensor(slots, dtype=torch.int64, device=dev),
        active=torch.as_tensor(active, device=dev),
        gen_cnt=i32(rng.integers(0, 3, n)), degree=i32(rng.integers(1, 1001, n)),
        received=i32(rng.integers(2**31 - 50, 2**31, n)),
        sent=i32(rng.integers(-2**31, 2**31 - 1, n)),
    )


def run_tick_update(case, *, frontier=True, plain=False):
    """One `kernels.tick_update` call on copies of ``case``'s state:
    (out, newly_cnt, seen, received, sent) after it."""
    import torch

    from p2p_gossip_tpu_torch.ops import kernels

    seen, received, sent = (case[k].clone() for k in ("seen", "received", "sent"))
    out, cnt = kernels.tick_update(
        seen, case["arrivals"], case["rows"], case["slots"], case["active"], case["gen_cnt"],
        received, sent, case["degree"], frontier=frontier, out=torch.empty_like(seen),
        plain=plain)
    return out, cnt, seen, received, sent


def check_tick_update_case(label, case, frontier=True) -> int:
    names = ("out", "newly_cnt", "seen", "received", "sent")
    got = run_tick_update(case, frontier=frontier)
    want = run_tick_update(case, frontier=frontier, plain=True)
    return max(compare(f"tick_update{label} {k}", a, b) for k, a, b in zip(names, got, want))


def tick_update_bytes(case) -> tuple[int, int]:
    """Least bytes of the case's update: arrivals read and out written, 8 B
    a word; seen read and written where a 16-byte unit of arrivals holds a
    bit, 32 B a unit; 28 B of counters a row (gen_cnt, degree, received and
    sent read and written, newly_cnt written); 17 B an event. Returns
    (bytes, nonzero units)."""
    import torch

    n, w = case["seen"].shape
    units = torch.nn.functional.pad(case["arrivals"], (0, (-w) % 4)).view(n, -1, 4)
    nonzero = int((units != 0).any(dim=2).sum())
    return n * w * 8 + nonzero * 32 + n * 28 + case["rows"].numel() * 17, nonzero


def previous_tick_update(case, seen, received, sent, out):
    """The flood tick's update as the engine ran it before the kernel: the
    generation plane (`ops.bitmask.slot_scatter`), then torch passes with
    the ``popcount_rows`` kernel."""
    import torch

    from p2p_gossip_tpu_torch.ops import bitmask

    n, w = seen.shape
    gen_bits = bitmask.slot_scatter(n, w, case["rows"], case["slots"], case["active"])
    newly = case["arrivals"] & ~seen
    newly_cnt = bitmask.popcount_rows(newly)
    seen |= case["arrivals"]
    seen |= gen_bits
    torch.bitwise_or(newly, gen_bits, out=out)
    received += newly_cnt
    sent += (newly_cnt + case["gen_cnt"]) * case["degree"]


def time_tick_update(case, reps, how="kernel") -> float:
    """Median milliseconds of one update over ``reps`` runs, each from the
    case's state (restored by a copy outside the timed events; the copy
    keeps the device busy while the host enqueues the call): ``how`` the
    kernel, its plain passes ("plain") or the engine's update before the
    kernel ("previous")."""
    import torch

    from p2p_gossip_tpu_torch.ops import kernels

    seen, received, sent = (case[k].clone() for k in ("seen", "received", "sent"))
    out = torch.empty_like(seen)

    def run():
        if how == "previous":
            return previous_tick_update(case, seen, received, sent, out)
        return kernels.tick_update(seen, case["arrivals"], case["rows"], case["slots"],
                                   case["active"], case["gen_cnt"], received, sent,
                                   case["degree"], out=out, plain=how == "plain")

    times = []
    for i in range(reps + 1):
        seen.copy_(case["seen"])
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        if i:  # the first run warms up
            times.append(start.elapsed_time(end))
    return float(np.median(times))


def tick_update_phase(dev, reps=10) -> dict:
    """Phase 21: the tick update kernel against its plain torch passes,
    bitwise, on ragged shapes (with the generations in the frontier and,
    as before the connect tick, out of it) and at burst32k's and
    coverage4k's shapes with dense and sparse arrivals; timed at those
    shapes beside the least bytes at 3.35 TB/s, its plain passes and the
    engine's update before it (`previous_tick_update`)."""
    import torch

    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED)
    err = 0
    for n, w in TICK_UPDATE_RAGGED:
        for sparse in (None, TICK_UPDATE_SPARSE):
            case = tick_update_inputs(rng, n, w, 3 * w + 5, dev, sparse)
            for frontier in (True, False):
                err = max(err, check_tick_update_case(f"({n}, {w})", case, frontier))
    out = {}
    for n, w, s in TICK_UPDATE_SHAPES:
        for kind, sparse in (("dense", None), ("sparse", TICK_UPDATE_SPARSE)):
            case = tick_update_inputs(rng, n, w, s, dev, sparse)
            err = max(err, check_tick_update_case(f"({n}, {w}) {kind}", case))
            nbytes, nonzero = tick_update_bytes(case)
            row = dict(ms=time_tick_update(case, reps),
                       plain_ms=time_tick_update(case, max(2, reps // 4), "plain"),
                       previous_ms=time_tick_update(case, reps, "previous"),
                       bound_ms=bound_ms(nbytes), units_nonzero=nonzero)
            out[f"{n}x{w}_{kind}"] = row
            log(f"tick_update ({n}, {w}) {kind}, S = {s}: bitwise equal; kernel "
                f"{row['ms']:.4f} ms, the engine's passes before it {row['previous_ms']:.4f} "
                f"ms, plain {row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
                f"({nonzero} of {n * -(-w // 4)} units nonzero)")
            del case
            torch.cuda.empty_cache()
    dense = out[f"{TICK_UPDATE_SHAPES[0][0]}x{TICK_UPDATE_SHAPES[0][1]}_dense"]
    record = dict(max_abs_err=err, ms=dense["ms"], plain_ms=dense["plain_ms"],
                  bound_ms=dense["bound_ms"], library_ms=None,
                  previous_ms=dense["previous_ms"],
                  **{f"{k}_{key}": v[key] for k, v in out.items()
                     for key in ("ms", "plain_ms", "previous_ms", "bound_ms")})
    log(f"phase 21 took {time.perf_counter() - t0:.1f} s")
    return record


# --- phase 22: the gather masked by seen --------------------------------------

# (label, configuration in gossipbench/configs, shares, generation ticks
# [0, hi), ticks at which the gather is checked and timed): burst32k's
# flood (ER 100K, 32,768 shares over 16 ticks, W = 1,024) at dense ticks of
# its burst, and coverage4k's (1M BA, 4,096 origins on tick 0, W = 128)
# across its flood. The graphs are the benchmark's (its frozen generators).
SEEN_CASES = (
    ("burst32k", "er100k", 32_768, 16, (4, 6, 10, 14, 18)),
    ("coverage4k", "ba1m", 4_096, 1, (3, 5, 7, 9)),
)
SEEN_PLAIN_TICKS = 2  # the first ticks of a case held against the plain version too
SEEN_TIMING_TURNS = 3  # masked and unmasked kernels timed in turns


def seen_case_inputs(config: str, shares: int, hi: int, dev):
    """A cell's graph drawn by the benchmark's generator, staged as the
    benchmark stages it, and one simulation's schedule (origins uniform,
    ticks uniform in [0, hi), in tick order)."""
    import p2p_gossip_tpu_torch as pt
    from gossipbench.gen import schedule as gen_schedule
    from gossipbench.gen import topology as gen_topology
    from p2p_gossip_tpu_torch.engine.sync import DeviceGraph
    from p2p_gossip_tpu_torch.models.topology import Graph

    root = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, "gossipbench", "configs", f"{config}.json")) as f:
        cfg = json.load(f)
    n = int(cfg["graph"]["n"])
    graph = Graph.from_edges(n, gen_topology.edges_of(cfg["graph"], [SEED, 22]))
    dg = DeviceGraph.build(graph, constant_delay=int(cfg["delay_ticks"]), device=dev)
    origins, ticks = gen_schedule.uniform_ticks(n, shares, 0, hi,
                                                np.random.default_rng([SEED, 22]))
    return graph, dg, pt.Schedule(n, origins, ticks)


def check_seen_tick(label, dg, hist, occ, seen, t, reps, plain):
    """The gather of tick ``t`` on the engine's own state: the masked kernel
    against the unmasked kernel & ~seen and (``plain``) the plain version,
    bitwise; then the two kernels timed in turns."""
    from p2p_gossip_tpu_torch.ops.ell import propagate_bucketed

    n = dg.n

    def run(seen_arg=None, plain_=False):
        return propagate_bucketed(
            hist, t, dg.buckets, n_out=n, ring_size=dg.ring_size,
            uniform_delay=dg.uniform_delay, occ=occ, seen=seen_arg, plain=plain_)

    got = run(seen)
    raw = run()
    err = compare(f"gather_or[{label} tick {t}, seen] vs unmasked & ~seen", got, raw & ~seen)
    if plain:
        err = max(err, compare(f"gather_or[{label} tick {t}, seen] vs plain", got,
                               run(seen, plain_=True)))
    del raw
    times = {"masked": [], "unmasked": []}
    for _ in range(SEEN_TIMING_TURNS):
        times["masked"].append(time_ms(lambda: run(seen), reps, calls=KERNEL_CALLS))
        times["unmasked"].append(time_ms(lambda: run(), reps, calls=KERNEL_CALLS))
    row = {k: float(np.median(v)) for k, v in times.items()}
    row.update(new_bits=set_bits(got), max_abs_err=err)
    log(f"gather_or[{label} tick {t}, seen]: bitwise equal (unmasked & ~seen"
        f"{', plain' if plain else ''}); masked {row['masked']:.4f} ms, unmasked "
        f"{row['unmasked']:.4f} ms; {row['new_bits']} new bits")
    return row


def seen_phase(dev, reps=10) -> dict:
    """Phase 22: the gather masked by the destinations' seen-sets
    (`kernels.gather_or` with ``seen``) on the engine's own state at
    burst32k's and coverage4k's shapes: bitwise against the unmasked kernel
    & ~seen at every captured tick and against the plain version at the
    first SEEN_PLAIN_TICKS; the masked and unmasked kernels timed in
    turns."""
    import torch

    from p2p_gossip_tpu_torch.engine.sync import _chunk_state, _tick

    t0 = time.perf_counter()
    record = {"max_abs_err": 0}
    for label, config, shares, hi, ticks in SEEN_CASES:
        t1 = time.perf_counter()
        graph, dg, sched = seen_case_inputs(config, shares, hi, dev)
        log(f"phase 22 {label}: N={graph.n} edges={graph.num_edges} dmax={graph.max_degree}, "
            f"{len(dg.buckets)} buckets, {shares} shares in ticks [0, {hi}) "
            f"({time.perf_counter() - t1:.1f} s to draw and stage)")
        chunk = max(shares, 4096)
        origins, gen_ticks = sched.padded(chunk, HORIZON)
        origins = torch.as_tensor(origins.astype(np.int64), device=dev)
        gen_ticks = torch.as_tensor(gen_ticks, device=dev)
        slots = torch.arange(chunk, dtype=torch.int64, device=dev)
        seen, hist, occ, received, sent = _chunk_state(dg, chunk // 32)
        rows = {}
        for t in range(max(ticks) + 1):
            if t in ticks:
                rows[t] = check_seen_tick(label, dg, hist, occ, seen, t, reps,
                                          plain=t in ticks[:SEEN_PLAIN_TICKS])
            _tick(dg, t, seen, hist, occ, received, sent, origins, slots, gen_ticks, False)
        total = {k: sum(r[k] for r in rows.values()) for k in ("masked", "unmasked")}
        log(f"phase 22 {label}, ticks {list(ticks)}: masked {total['masked']:.4f} ms, "
            f"unmasked {total['unmasked']:.4f} ms ({total['masked'] / total['unmasked']:.3f} "
            f"of it)")
        record["max_abs_err"] = max(record["max_abs_err"],
                                    max(r["max_abs_err"] for r in rows.values()))
        record[label] = dict(
            ms=total["masked"], unmasked_ms=total["unmasked"],
            ticks={t: {k: v for k, v in r.items() if k != "max_abs_err"}
                   for t, r in rows.items()})
        del seen, hist, occ, received, sent, dg, graph
        torch.cuda.empty_cache()
    log(f"phase 22 took {time.perf_counter() - t0:.1f} s")
    return record


def phase_22_alone(dev) -> int:
    """``python3 chip_smoke.py --phase 22``: phase 22 by itself, after the
    kernels' build. Prints its record; the default run (every phase) is the
    script's contract."""
    import torch

    from p2p_gossip_tpu_torch.ops import build

    path, nvcc_s = build.build()
    log(f"kernels built in {nvcc_s:.2f} s -> {path}")
    print(json.dumps({"phase22_gather_seen": seen_phase(dev)}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


def phase_21_alone(dev) -> int:
    """``python3 chip_smoke.py --phase 21``: phase 21 by itself, after the
    kernels' build. Prints its record; the default run (every phase) is the
    script's contract."""
    import torch

    from p2p_gossip_tpu_torch.ops import build

    path, nvcc_s = build.build()
    log(f"kernels built in {nvcc_s:.2f} s -> {path}")
    print(json.dumps({"phase21_tick_update": tick_update_phase(dev)}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


def phase_20_alone(dev) -> int:
    """``python3 chip_smoke.py --phase 20``: phase 20 by itself, after the
    kernels' build. Prints its ``staticcheck`` line; the default run (every
    phase) is the script's contract."""
    import torch

    from p2p_gossip_tpu_torch.ops import build

    t_start = time.perf_counter()
    path, nvcc_s = build.build()
    log(f"kernels built in {nvcc_s:.2f} s -> {path}")
    phase20 = staticcheck_phase(dev)
    print(json.dumps({"staticcheck": phase20["record"]}))
    log(f"--phase 20 took {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


def phase_19_alone(dev) -> int:
    """``python3 chip_smoke.py --phase 19``: ``python -m
    p2p_gossip_tpu_torch.bench`` whole in a subprocess, its row held to
    `check_bench_whole`, ``ticks`` to one flood of the bench's own graph
    and schedule (`bench.workload`: the C++ builder's graph), run here
    first, which also builds the kernels. Prints the row; the default run
    (every phase) is the script's contract."""
    import torch

    from p2p_gossip_tpu_torch import bench
    from p2p_gossip_tpu_torch.engine.sync import run_sync_sim
    from p2p_gossip_tpu_torch.ops import build

    t_start = time.perf_counter()
    path, nvcc_s = build.build()
    log(f"kernels built in {nvcc_s:.2f} s -> {path}")
    cfg = bench.FULL
    graph, sched, dg = bench.workload(cfg, dev)
    ticks = run_sync_sim(graph, sched, cfg["horizon"], chunk_size=cfg["chunk"], device_graph=dg,
                         device=dev).extra["ticks_executed"]
    log(f"the bench's flood (its graph): {ticks} ticks ({time.perf_counter() - t_start:.1f} s)")
    del graph, dg
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "p2p_gossip_tpu_torch.bench"],
                          capture_output=True, text=True, timeout=BENCH_TIMEOUT_S,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    wall = time.perf_counter() - t0
    sys.stderr.write(proc.stderr[-8000:])
    if proc.returncode != 0:
        raise RuntimeError(f"python -m p2p_gossip_tpu_torch.bench exited {proc.returncode}")
    lines = proc.stdout.strip().splitlines()
    if len(lines) != 1:
        raise AssertionError(f"the bench printed {len(lines)} lines on stdout, not 1")
    row = json.loads(lines[0])
    check_bench_whole(row, ticks)
    log(f"python -m p2p_gossip_tpu_torch.bench: {wall:.1f} s; median {row['value']:.6e} "
        f"node-updates/s of runs {row['runs']} (spread {row['spread']:.4f}), "
        f"{row['ms_per_tick']:.4f} ms/tick, {row['ticks']} ticks, on {row['device']}, "
        f"{row['power_limit']}; every leg's checks passed")
    log(json.dumps({"phase19_bench": row}))
    log(f"--phase 19 took {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


def phase_18_alone(dev) -> int:
    """``python3 chip_smoke.py --phase 18``: phase 18 by itself (it needs
    no earlier phase's results). Prints its records; the default run
    (every phase) is the script's contract."""
    import torch

    from p2p_gossip_tpu_torch.ops import build

    t_start = time.perf_counter()
    path, nvcc_s = build.build()
    log(f"kernels built in {nvcc_s:.2f} s -> {path}")
    bisect_phase(dev)
    compare_phase(dev)
    log(f"--phase 18 took {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


def phase_17_alone(dev) -> int:
    """``python3 chip_smoke.py --phase 17``: phase 17 by itself, with its
    references built here: phase 13's single-device server results on the
    phase-5 graph and phase 12's 1M BA graph and flood. Prints phase 17's
    record; the default run (every phase) is the script's contract."""
    import torch

    import p2p_gossip_tpu_torch as pt
    from p2p_gossip_tpu_torch.engine.sync import DeviceGraph, run_flood_coverage
    from p2p_gossip_tpu_torch.engine.sync import time_to_coverage
    from p2p_gossip_tpu_torch.ops import build, kernels
    from p2p_gossip_tpu_torch.runtime import native

    t_start = time.perf_counter()
    path, nvcc_s = build.build()
    log(f"kernels built in {nvcc_s:.2f} s -> {path}")
    graph = pt.erdos_renyi(N_NODES, EDGE_P, seed=SEED)
    serve13 = serve_mesh_references(graph, dev)
    native.build()
    ba_graph = native.native_barabasi_albert(SCALE_CONFIGS[0][1], m=SCALE_BA_M, seed=SEED)
    origins = np.random.default_rng(SEED).integers(0, ba_graph.n,
                                                   SCALE_ORIGINS).astype(np.int32)
    t0 = time.perf_counter()
    dg = DeviceGraph.build(ba_graph, device=dev)
    torch.cuda.synchronize()
    stage_s = time.perf_counter() - t0
    run_flood_coverage(ba_graph, origins, HORIZON, device_graph=dg, device=dev)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    stats, cov = run_flood_coverage(ba_graph, origins, HORIZON, device_graph=dg, device=dev)
    wall = time.perf_counter() - t0
    ticks = kernels.launches["coverage_per_slot"]  # once a tick
    ttc = time_to_coverage(cov, ba_graph.n, 0.99)
    scale12 = dict(ttc99_median=float(np.median(ttc)), ttc99_max=int(ttc.max()),
                   wall_s=wall, ms_per_tick=wall / ticks * 1e3,
                   rate=stats.totals()["processed"] / wall, stage_s=stage_s)
    del dg
    torch.cuda.empty_cache()
    serve_mesh_phase(serve13, dict(graph=ba_graph, coverage=cov), scale12, dev)
    log(f"--phase 17 took {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


def phase_3n_alone(dev) -> int:
    """``python3 chip_smoke.py --phase 3n``: phase 3's `scatter_or` checks
    on ragged shapes (`check_scatter_ragged`, narrow rows among them) and
    its narrow-row calls at the push-pull cells' shapes
    (`check_scatter_narrow`) by themselves. Prints the calls' record; the
    default run (every phase) is the script's contract."""
    import torch

    from p2p_gossip_tpu_torch.ops import build

    path, nvcc_s = build.build()
    log(f"kernels built in {nvcc_s:.2f} s -> {path}")
    check_scatter_ragged(dev, np.random.default_rng(SEED))
    print(json.dumps({"scatter_or_narrow": check_scatter_narrow(dev, reps=10)}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


def phase_16_alone(dev) -> int:
    """``python3 chip_smoke.py --phase 16``: phase 16 by itself, on its own
    graph and stagings, with phase 11's single-device campaigns run here as
    its references. Prints the exchange kernels' B = 8 record; the default
    run (every phase) is the script's contract."""
    import torch

    import p2p_gossip_tpu_torch as pt
    from p2p_gossip_tpu_torch.batch.campaign import flood_replicas
    from p2p_gossip_tpu_torch.engine.sync import DeviceGraph
    from p2p_gossip_tpu_torch.models.protocols import PartnerGraph
    from p2p_gossip_tpu_torch.ops import build

    path, nvcc_s = build.build()
    log(f"kernels built in {nvcc_s:.2f} s -> {path}")
    graph = pt.erdos_renyi(N_NODES, EDGE_P, seed=SEED)
    dg = DeviceGraph.build(graph, device=dev)
    delays = pt.lognormal_delays(graph, mean_ticks=2.0, sigma=0.5, max_ticks=5, seed=SEED)
    dgf_edge = PartnerGraph.build(graph, delays, device=dev)
    cov_set = flood_replicas(graph, COVERAGE_ORIGINS, np.arange(CAMPAIGN_REPLICAS) + SEED,
                             HORIZON)
    gossip_set = campaign_replicas(graph, N_SHARES)
    out = sharded_campaign_phase(graph, dg, dgf_edge, cov_set, gossip_set, delays, None, dev,
                                 np.random.default_rng(SEED))
    print(json.dumps({"phase16_kernels": out["kernels"]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


def phase_14a_alone(dev) -> int:
    """``python3 chip_smoke.py --phase 14a``: the exchange kernels' checks and
    timings by themselves: phase 14 (a) (compress_deltas' edge cases, the
    4-way split of the 100K flood's frontiers, the 1M BA split and the
    look-back stress case) and phase 16 (a) (the replica axis), on their
    own graphs and stagings. Prints their records; the default run (every
    phase) is the script's contract."""
    import torch

    import p2p_gossip_tpu_torch as pt
    from p2p_gossip_tpu_torch.engine.sync import DeviceGraph
    from p2p_gossip_tpu_torch.ops import build
    from p2p_gossip_tpu_torch.runtime import native

    t_start = time.perf_counter()
    path, nvcc_s = build.build()
    log(f"kernels built in {nvcc_s:.2f} s -> {path}")
    rng = np.random.default_rng(SEED)
    graph = pt.erdos_renyi(N_NODES, EDGE_P, seed=SEED)
    dg = DeviceGraph.build(graph, device=dev)
    check_compress_edges(dev, rng)
    k100 = check_delta_kernels(graph, delta_frontiers(dg, flood_schedule(graph), dev), dev,
                               reps=10)
    native.build()
    topology, nodes, _ = SCALE_CONFIGS[0]
    ba = native.native_barabasi_albert(nodes, m=SCALE_BA_M, seed=SEED)
    ba_dg = DeviceGraph.build(ba, device=dev)
    origins = np.random.default_rng(SEED).integers(0, ba.n, SCALE_ORIGINS).astype(np.int32)
    frontier = capture_state(ba_dg, pt.Schedule(ba.n, origins, np.zeros(len(origins),
                                                                        dtype=np.int32)),
                             SCALE_ORIGINS, SCALE_CAPTURE_TICK, dev)[5]
    k1m = ba_exchange(ba, ba_dg, origins, frontier, dev)
    del ba_dg, frontier
    torch.cuda.empty_cache()
    exchange_replicas_ragged(dev, rng)
    k16 = check_exchange_replicas(graph, dg, campaign_replicas(graph, N_SHARES), dev, reps=10)
    log(f"--phase 14a took {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"phase14a_kernels": {
        name: dict(k100[name], **{f"{key}_1m_{topology}": k1m["delta"][name][key]
                                  for key in ("ms", "bound_ms", "plain_ms", "library_ms")},
                   **{f"{key}_b{CAMPAIGN_REPLICAS}": k16[name][key]
                      for key in ("ms", "bound_ms", "plain_ms", "library_ms",
                                  "solo_launches_ms")},
                   **({f"{key}_stress_b{STRESS_TICKS}_1m_{topology}": k1m["stress"][key]
                       for key in ("ms", "bound_ms", "library_ms", "tiles")}
                      if name == "compress_deltas" else {}))
        for name in SHARDED_KERNELS}}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    log(smi.stdout.strip().splitlines()[0])
    log(f"torch {torch.__version__} cuda {torch.version.cuda}, python "
        f"{sys.version.split()[0]}")

    import p2p_gossip_tpu_torch as pt
    from p2p_gossip_tpu_torch.engine.sync import DeviceGraph
    from p2p_gossip_tpu_torch.models.protocols import PartnerGraph
    from p2p_gossip_tpu_torch.ops import build

    # Phases 3-9 measure and count the telemetry-off path; phase 10 turns
    # telemetry on itself.
    for var in ("P2P_TELEMETRY", "P2P_HEARTBEAT"):
        os.environ.pop(var, None)
    dev = torch.device("cuda", 0)
    if sys.argv[1:2] == ["--north-star"]:
        build.build()
        north_star(sys.argv[2], dev)
        return 0
    if sys.argv[1:3] == ["--phase", "16"]:
        return phase_16_alone(dev)
    if sys.argv[1:3] == ["--phase", "14a"]:
        return phase_14a_alone(dev)
    if sys.argv[1:3] == ["--phase", "17"]:
        return phase_17_alone(dev)
    if sys.argv[1:3] == ["--phase", "18"]:
        return phase_18_alone(dev)
    if sys.argv[1:3] == ["--phase", "19"]:
        return phase_19_alone(dev)
    if sys.argv[1:3] == ["--phase", "20"]:
        return phase_20_alone(dev)
    if sys.argv[1:3] == ["--phase", "21"]:
        return phase_21_alone(dev)
    if sys.argv[1:3] == ["--phase", "22"]:
        return phase_22_alone(dev)
    if sys.argv[1:3] == ["--phase", "3n"]:
        return phase_3n_alone(dev)
    t_start = time.perf_counter()
    path, nvcc_s = build.build()
    build.load_library()
    log(f"kernels built in {nvcc_s:.2f} s -> {path}")

    t0 = time.perf_counter()
    graph = pt.erdos_renyi(N_NODES, EDGE_P, seed=SEED)
    log(f"graph: N={graph.n} edges={graph.num_edges} dmax={graph.max_degree} "
        f"({time.perf_counter() - t0:.1f} s host build)")
    t0 = time.perf_counter()
    dg = DeviceGraph.build(graph, device=dev)
    delays = pt.lognormal_delays(graph, mean_ticks=2.0, sigma=0.5, max_ticks=5, seed=SEED)
    dg_edge = DeviceGraph.build(graph, delays, device=dev)
    log(f"staging: {time.perf_counter() - t0:.1f} s, {len(dg.buckets)} buckets, "
        f"per-edge ring D={dg_edge.ring_size}")

    t0 = time.perf_counter()
    # The protocols' CSR stagings: uniform delay, and the push-pull run's
    # log-normal per-edge delays (D = 6).
    dgf = PartnerGraph.build(graph, device=dev)
    dgf_edge = PartnerGraph.build(graph, delays, device=dev)
    log(f"partner staging: {time.perf_counter() - t0:.1f} s, {dgf.num_entries} CSR "
        f"entries, per-edge ring D={dgf_edge.ring_size}")

    rng = np.random.default_rng(SEED)
    w_flood, w_cov = CHUNK // 32, COVERAGE_ORIGINS // 32
    log("tolerance: bitwise (integer ops), max_abs_err must be 0")
    check_gather_ragged(dev, rng)
    check_gather_options_ragged(dev, rng)
    check_occupancy_ragged(dev, rng)
    check_scatter_ragged(dev, rng)
    gather = check_gather(dg, dg_edge, graph.n, w_flood, dev, rng, reps=10)
    occupancy = check_occupancy(graph.n, w_flood, dev, rng, reps=20)
    sched = flood_schedule(graph)
    captured = check_captured(dg, dg_edge, sched, graph.n, dev, reps=10)
    popcount = check_popcount(graph.n, w_flood, dev, rng, reps=20)
    coverage = check_coverage(graph.n, w_cov, dev, rng, reps=20)
    frontier = check_coverage_frontier(graph, dg, dev, reps=20)
    scatter = check_scatter(graph, dgf_edge, sched, dev, reps=10)
    scatter.update(check_scatter_narrow(dev, reps=10))
    del dg_edge
    torch.cuda.empty_cache()

    check_engine_paths(dev)
    check_protocol_paths(dev)
    check_protocol_cli(dev)
    launches, base = main_path(graph, dg, sched, dev)
    options_launches, option_models = options_path(graph, dg, sched, dev, base)
    profile_flood(graph, sched, dg, dev)
    profile_flood(graph, sched, dg, dev, "options flood", **option_models)
    protocol_launches, phase9, phase9_refs = protocols_path(graph, dgf, dgf_edge, sched, dev)
    check_digest_ragged(dev, rng)
    digest = check_digest(dg, sched, dev, rng, reps=20)
    telemetry_launches, flood_cost = telemetry_flood(graph, dg, sched, dev)
    pushpull_launches, round_cost = telemetry_pushpull(graph, dgf_edge, sched, dev)
    check_telemetry_streams(dev)

    from p2p_gossip_tpu_torch import telemetry
    from p2p_gossip_tpu_torch.batch.campaign import flood_replicas

    telemetry.reset()  # campaigns run with telemetry's rings off
    cov_set = flood_replicas(graph, COVERAGE_ORIGINS, np.arange(CAMPAIGN_REPLICAS) + SEED,
                             HORIZON)
    gossip_set = campaign_replicas(graph, N_SHARES)
    check_gather_replicas_ragged(dev, rng)
    campaign_kernels = check_campaign_kernels(graph, dg, cov_set, gossip_set, dev, rng,
                                              reps=10)
    check_small_campaigns(dev)
    campaign_launches, phase11 = campaigns_path(graph, dg, dgf_edge, cov_set, gossip_set, dev)
    ck = campaign_kernels
    scale, ba = scale_phase(dev)
    serve = serve_phase(graph, dev, rng)
    sharded = sharded_phase(graph, dg, sched, ba, dev)
    protocols15 = sharded_protocols_phase(graph, sched, delays, dgf_edge, phase9, phase9_refs,
                                          dev, rng)
    campaigns16 = sharded_campaign_phase(
        graph, dg, dgf_edge, cov_set, gossip_set, delays,
        {kind: phase11[kind]["campaign"] for kind in ("coverage", "pushpull")}, dev, rng)
    serve17 = serve_mesh_phase(serve, ba, scale["ba"], dev)
    torch.cuda.empty_cache()
    bisect_phase(dev)
    compare_phase(dev)
    bench19 = bench_phase(graph, dg, sched, dev, base["stats"])
    phase20 = staticcheck_phase(dev)
    print(json.dumps({"staticcheck": phase20["record"]}))
    tick21 = tick_update_phase(dev)
    seen22 = seen_phase(dev)
    log(f"chip_smoke phases 1-22 took {time.perf_counter() - t_start:.1f} s")

    cu, ce = captured["uniform"], captured["per_edge"]
    measured = {
        # ms / bound_ms: the random (dense) ring with uniform delay, the shape
        # the gather was first timed at; the captured ring's beside it, with
        # and without the loss coin and up mask.
        "gather_or": dict(
            gather["uniform"], max_abs_err=max(gather["uniform"]["max_abs_err"],
                                               gather["per_edge"]["max_abs_err"],
                                               cu["max_abs_err"], ce["max_abs_err"]),
            ms_captured=cu["ms"], bound_ms_captured=cu["bound_ms"],
            plain_ms_captured=cu["plain_ms"], sector_share_captured=cu["sector_share"],
            ms_per_edge=gather["per_edge"]["ms"],
            bound_ms_per_edge=gather["per_edge"]["bound_ms"],
            ms_per_edge_captured=ce["ms"], bound_ms_per_edge_captured=ce["bound_ms"],
            sector_share_per_edge_captured=ce["sector_share"],
            ms_captured_loss=cu["ms_loss"], bound_ms_captured_loss=cu["bound_ms_loss"],
            plain_ms_captured_loss=cu["plain_ms_loss"],
            ms_captured_again=cu["ms_again"],
            ms_per_edge_captured_loss=ce["ms_loss"],
            bound_ms_per_edge_captured_loss=ce["bound_ms_loss"],
            plain_ms_per_edge_captured_loss=ce["plain_ms_loss"],
            ms_per_edge_captured_again=ce["ms_again"],
            # Phase 22: masked by seen on the engine's own state, summed over
            # the captured ticks of burst32k's and coverage4k's floods.
            max_abs_err_seen=seen22["max_abs_err"],
            **{f"{key}_seen_{label}": seen22[label][key]
               for label, *_ in SEEN_CASES
               for key in ("ms", "unmasked_ms")},
            # Phase 11: B = 8 replicas in one launch a bucket, on campaign
            # (b)'s tick-10 ring and (a)'s tick-2 ring, (b)'s also with the
            # per-replica loss coins and an up mask.
            **{f"{key}_campaign{tag}": ck[label][key]
               for tag, label in (("", "gather_gossip"), ("_loss_up", "gather_loss_up_gossip"),
                                  ("_coverage", "gather_coverage"),
                                  ("_coverage_loss_up", "gather_loss_up_coverage"))
               for key in ("ms", "bound_ms", "plain_ms")},
        ),
        "sector_occupancy": dict(occupancy, ms_captured=cu["occupancy_ms"],
                                 plain_ms_captured=cu["occupancy_plain_ms"]),
        "popcount_rows": popcount,
        # Phase 21: dense arrivals at burst32k's (100,000, 1,024), sparse and
        # coverage4k's (10^6, 128) beside it.
        "tick_update": tick21,
        "coverage_per_slot": dict(coverage, max_abs_err=max(coverage["max_abs_err"],
                                                            frontier["max_abs_err"]),
                                  ms_frontier=frontier["ms"],
                                  bound_ms_frontier=frontier["bound_ms"],
                                  plain_ms_frontier=frontier["plain_ms"],
                                  # Phase 11: (8, 100,000, 128) -> (8, 4,096).
                                  **{f"{key}_campaign_{tag}": ck[f"coverage_{tag}"][key]
                                     for tag in ("dense", "frontier")
                                     for key in ("ms", "bound_ms", "plain_ms")}),
        # ms / bound_ms: the push-pull push (M = N) from zeros on the
        # round-10 ring, given its plan; fanout 2's beside it, both on the
        # dense round-40 ring, and the push-pull round's own call (pull +
        # push, base = seen) on both rings.
        "scatter_or": dict(
            {k: scatter["pushpull M=N"][k] for k in ("max_abs_err", "ms", "plain_ms",
                                                     "bound_ms", "plan_ms",
                                                     "plan_device_ms")},
            max_abs_err=max(r["max_abs_err"] for r in scatter.values()),
            **{f"{key}_{tag}": scatter[label][key]
               for tag, label in (
                   ("fanout2", "fanout2 M=2N"),
                   ("dense", f"pushpull M=N round {PROTOCOL_DENSE_ROUND}"),
                   ("fanout2_dense", f"fanout2 M=2N round {PROTOCOL_DENSE_ROUND}"),
                   ("round_call", "round call"),
                   ("round_call_dense", f"round call round {PROTOCOL_DENSE_ROUND}"))
               for key in ("ms", "bound_ms", "plain_ms")},
            # The push-pull cells' round calls at their own shapes.
            **{f"{key}_{label.replace(' ', '_').replace('=', '')}": scatter[label][key]
               for label, *_ in NARROW_CASES for key in ("ms", "bound_ms", "lanes", "max_run")},
        ),
        # ms / bound_ms: dense random words at 100,000 x 256, the flood's
        # lo-only fold; with sent_hi (the protocols') and on the flood's own
        # tick-10 state beside it, and the paths' ms/tick and ms/round with
        # telemetry off and on (in turns, one call).
        "tick_digest": dict(
            digest["dense"],
            **{f"{key}_{tag}": digest[label][key]
               for tag, label in (("sent_hi", "dense_sent_hi"), ("captured", "captured"))
               for key in ("ms", "bound_ms", "plain_ms")},
            **flood_cost, **round_cost,
            launches_telemetry_pushpull=pushpull_launches["tick_digest"],
            # Phase 13: B = 8 replicas of (100,000, W) in one launch.
            **{f"{key}_b{DIGEST_REPLICAS}_w{w}": serve["digest"][w][key]
               for w in (128, 256) for key in ("ms", "bound_ms", "plain_ms")},
            **{f"launches_serve_rings_{kind}": serve["rings"][kind]["tick_digest"]
               for kind in serve["rings"]},
        ),
    }
    # Phase 12: the four flood kernels on each million-node graph's tick-3
    # state (plain_ms on SCALE_SUBSET_ROWS rows), and their launches a run.
    for topology in (cfg[0] for cfg in SCALE_CONFIGS):
        for name, m in scale[topology]["kernels"].items():
            measured[name]["max_abs_err"] = max(measured[name]["max_abs_err"],
                                                m["max_abs_err"])
            measured[name].update({f"{key}_1m_{topology}": m[key]
                                   for key in ("ms", "bound_ms", "plain_ms")})
    # Phase 14 (a): the exchange kernels on a 4-shard split of the 100K
    # flood's tick-10 frontier (the timed call; tick 3 and the overflow
    # capacity checked too) and of the 1M BA tick-2 state.
    for name in SHARDED_KERNELS:
        m1 = sharded["kernels_1m"][name]
        measured[name] = dict(
            sharded["kernels_100k"][name],
            max_abs_err=max(sharded["kernels_100k"][name]["max_abs_err"], m1["max_abs_err"]),
            **{f"{key}_1m_ba": m1[key]
               for key in ("ms", "bound_ms", "plain_ms", "library_ms")})
    # compress_deltas' look-back stress case: shard 0 of the 1M BA split,
    # eight frontiers as B = 8.
    measured["compress_deltas"].update(
        {f"{key}_stress_b{STRESS_TICKS}_1m_ba": sharded["stress"][key]
         for key in ("ms", "bound_ms", "library_ms", "tiles")})
    # exchange.overlay_hub (a torch index_copy_, no kernel of its own) beside
    # the scatter it completes, on the same split with pinned hub rows.
    measured["scatter_deltas"].update(
        {f"overlay_hub_{key}": sharded["kernels_100k"]["overlay_hub"][key]
         for key in ("ms", "bound_ms", "hub_rows")})
    # Phase 15 (a): or_fold on destination 0's stack of the 4-shard split
    # of the phase-9 push-pull's round-40 pushes (ragged shapes checked too);
    # no torch call OR-reduces int32 words over an axis: library_ms null.
    measured["or_fold"] = dict(protocols15["or_fold"], library_ms=None)
    # Phase 16 (a): B = 8 replicas in one launch on the split of phase 11's
    # replicas' tick-10 frontiers, beside B launches of the one-run kernel.
    for name in SHARDED_KERNELS:
        measured[name].update({f"{key}_b{CAMPAIGN_REPLICAS}": campaigns16["kernels"][name][key]
                               for key in ("ms", "bound_ms", "plain_ms", "library_ms",
                                           "solo_launches_ms")})
    base_keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "library_ms")
    record = []
    for name, m in measured.items():
        # `launches`: the path the kernel serves — the flood's main path, for
        # scatter_or (the protocols' kernel) the protocols' path, for
        # tick_digest the telemetry-on flood + coverage (phase 10), for the
        # exchange kernels the sharded delta flood + coverage (phase 14 (b)),
        # for or_fold the sharded push-pull on the replicated ring (15 (b)).
        if name in FLOOD_KERNELS:
            path_launches = launches[name]
        elif name in TELEMETRY_KERNELS:
            path_launches = telemetry_launches[name]
        elif name in SHARDED_KERNELS:
            path_launches = sharded["runs"]["delta"]["launches"][name]
        elif name == "or_fold":
            path_launches = protocols15["runs"]["pushpull-replicated"]["launches"][name]
        else:
            path_launches = protocol_launches[name]
        record.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name],
            "launches": path_launches,
            **{k: m.get(k) for k in base_keys},
            "bound_by": "bytes",
            "launches_options": options_launches[name],
            "launches_protocols": protocol_launches[name],
            "launches_telemetry": telemetry_launches[name],
            **{f"launches_campaign_{kind}": campaign_launches[kind][name]
               for kind in campaign_launches},
            **{f"launches_1m_{topology}": scale[topology]["launches"][name]
               for topology in (cfg[0] for cfg in SCALE_CONFIGS)},
            "launches_serve": serve["launches"][name],
            **{f"launches_sharded_{mode}": sharded["runs"][mode]["launches"][name]
               for mode, _ in SHARDED_MODES},
            "launches_sharded_1m_ba": sharded["runs"]["ba"]["launches"][name],
            **{f"launches_sharded_protocols_{label}":
               protocols15["runs"][label]["launches"][name]
               for label, *_ in SHARDED_PROTOCOL_RUNS},
            **{f"launches_sharded_campaign_{mode}": campaigns16["runs"][mode]["launches"][name]
               for mode, _ in SHARDED_MODES + CAMPAIGN_PROTOCOL_MODES},
            **{f"launches_serve_mesh_{ex}": serve17["drains"][ex]["launches"][name]
               for ex in SERVE_MESH_EXCHANGES},
            "launches_bench": bench19["launches"][name],
            "launches_staticcheck": phase20["launches"].get(name, 0),
            **{k: v for k, v in m.items() if k not in base_keys},
        })
    print(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
