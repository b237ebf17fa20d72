#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``p2p_gossip_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU (an H100):

    python3 chip_smoke.py

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
4. Run the engine twice on small graphs, with the kernels and with the
   plain versions, and require equal counters and executed ticks; run
   the CLI's reference default config on the card.
5. The main path at full size: ``bench.py``'s flood configuration —
   100K-node Erdős–Rényi p=0.001, 8,192 shares over a 16-tick window,
   horizon 64, one 8,192-share chunk — one warm run, one timed run.
6. ``run_flood_coverage`` on the same graph with 4,096 origins.
7. One more flood run under ``torch.profiler``: device time by kernel and
   the device's busy share of the run's wall time.

Kernel launch counts are zeroed just before the timed run of phase 5 and
read after phase 6. The second-to-last line is the kernels' JSON record;
the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
N_NODES, EDGE_P, SEED = 100_000, 0.001, 0
N_SHARES, GEN_WINDOW, HORIZON, CHUNK = 8192, 16, 64, 8192
COVERAGE_ORIGINS = 4096
CAPTURE_TICK = 10  # a mid-flood tick: shares of generation ticks 6-9 spreading
SOURCE = "p2p_gossip_tpu_torch/csrc/gossip_kernels.cu"
REPLACES = {
    "gather_or": "p2p_gossip_tpu/ops/ell.py:157",
    # No TPU counterpart: the gather's companion pass, filed under the XLA
    # gather-OR it serves.
    "sector_occupancy": "p2p_gossip_tpu/ops/ell.py:157",
    "popcount_rows": "p2p_gossip_tpu/ops/pallas_kernels.py:152",
    "coverage_per_slot": "p2p_gossip_tpu/ops/pallas_kernels.py:122",
}


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


def capture_ring(dg, sched, chunk, ticks, dev):
    """Run the engine's own tick on one chunk of ``sched`` for ``ticks``
    ticks from t = 0 and return its frontier ring, occupancy ring and the
    last tick's new frontier."""
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
        results[label] = dict(
            max_abs_err=max(err, occ_err), ms=ms, ms_no_occupancy=ms_full,
            plain_ms=plain_ms, bound_ms=bound_ms(nbytes), sector_share=share,
            occupancy_ms=occ_ms, occupancy_plain_ms=occ_plain_ms,
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
        del hist, occ
    return results


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
    check_cli(dev)
    origins = np.arange(0, 300, 3)
    _, ck = run_flood_coverage(ba, origins, 60, ell_delays=d, device=dev)
    _, cp = run_flood_coverage(ba, origins, 60, ell_delays=d, device=dev, plain=True)
    if not np.array_equal(ck, cp):
        raise AssertionError("coverage: kernel and plain paths differ")
    log(f"coverage[BA 300]: {len(origins)} origins, kernel == plain over 60 ticks")


def check_cli(dev):
    """``python -m p2p_gossip_tpu_torch``'s reference default run on the
    card: its per-node lines equal the plain path's report."""
    import contextlib
    import io

    import p2p_gossip_tpu_torch as pt
    from p2p_gossip_tpu_torch.engine.sync import run_sync_sim
    from p2p_gossip_tpu_torch.utils import cli
    from p2p_gossip_tpu_torch.utils.stats import format_final_statistics

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.run(["--device", str(dev)])
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"CLI exited {rc}")
    g = pt.erdos_renyi(10, 0.3, seed=0)
    sched = pt.uniform_renewal_schedule(10, 60.0, 0.005, seed=0)
    want = format_final_statistics(run_sync_sim(g, sched, 12000, device=dev, plain=True))
    node_lines = [ln for ln in buf.getvalue().splitlines() if ln.startswith("Node ")]
    if len(node_lines) != 10 or node_lines != [
        ln for ln in want.splitlines() if ln.startswith("Node ")
    ]:
        raise AssertionError("CLI report differs from the plain path's")
    log(f"cli: reference default config on {dev}, {wall:.2f} s, per-node lines "
        "equal the plain path's")


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
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"kernel {name} never launched on the main path")
    return launches


def profile_flood(graph, sched, dg, dev):
    """Device time of one flood run by kernel name, from torch.profiler's
    CUDA kernel events, and the share of the run's wall time the device
    was busy (kernels run on one stream, so their durations add)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from p2p_gossip_tpu_torch.engine.sync import run_sync_sim

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        stats = run_sync_sim(graph, sched, HORIZON, chunk_size=CHUNK,
                             device_graph=dg, device=dev)
        wall = time.perf_counter() - t0
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    ticks = stats.extra["ticks_executed"]
    if not by_name:
        log("profile: no device events recorded; breakdown not measured")
        return
    busy_us = sum(by_name.values())
    log(
        f"profile (profiled flood run, {ticks} ticks, wall {wall * 1e3:.2f} ms): "
        f"device busy {busy_us / 1e3:.2f} ms = {busy_us / (wall * 1e6):.3f} of wall"
    )
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        log(f"  {us / 1e3:9.3f} ms  {us / busy_us:6.3f}  {name[:110]}")


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
    from p2p_gossip_tpu_torch.ops import build

    dev = torch.device("cuda", 0)
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

    rng = np.random.default_rng(SEED)
    w_flood, w_cov = CHUNK // 32, COVERAGE_ORIGINS // 32
    log("tolerance: bitwise (integer ops), max_abs_err must be 0")
    check_gather_ragged(dev, rng)
    check_occupancy_ragged(dev, rng)
    gather = check_gather(dg, dg_edge, graph.n, w_flood, dev, rng, reps=10)
    occupancy = check_occupancy(graph.n, w_flood, dev, rng, reps=20)
    sched = flood_schedule(graph)
    captured = check_captured(dg, dg_edge, sched, graph.n, dev, reps=10)
    popcount = check_popcount(graph.n, w_flood, dev, rng, reps=20)
    coverage = check_coverage(graph.n, w_cov, dev, rng, reps=20)
    frontier = check_coverage_frontier(graph, dg, dev, reps=20)
    del dg_edge
    torch.cuda.empty_cache()

    check_engine_paths(dev)
    launches = main_path(graph, dg, sched, dev)
    profile_flood(graph, sched, dg, dev)

    cu, ce = captured["uniform"], captured["per_edge"]
    measured = {
        # ms / bound_ms: the random (dense) ring with uniform delay, the shape
        # the gather was first timed at; the captured ring's beside it.
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
        ),
        "sector_occupancy": dict(occupancy, ms_captured=cu["occupancy_ms"],
                                 plain_ms_captured=cu["occupancy_plain_ms"]),
        "popcount_rows": popcount,
        "coverage_per_slot": dict(coverage, max_abs_err=max(coverage["max_abs_err"],
                                                            frontier["max_abs_err"]),
                                  ms_frontier=frontier["ms"],
                                  bound_ms_frontier=frontier["bound_ms"],
                                  plain_ms_frontier=frontier["plain_ms"]),
    }
    base = ("max_abs_err", "ms", "plain_ms", "bound_ms")
    record = []
    for name, m in measured.items():
        record.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            **{k: m[k] for k in base},
            "bound_by": "bytes", "library_ms": None,
            **{k: v for k, v in m.items() if k not in base},
        })
    print(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
