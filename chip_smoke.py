#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``p2p_gossip_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU (an H100):

    python3 chip_smoke.py

Phases (any failure raises and the script exits nonzero):

1. Print the card's name and power limit (``nvidia-smi``); no CUDA -> exit 1.
2. Build the CUDA kernels from ``p2p_gossip_tpu_torch/csrc`` (``nvcc``).
3. Hold each kernel against its plain torch version on the card at the
   main path's shapes (bitwise: every op is integer), and time both with
   CUDA events beside the least time the bytes allow at 3.35 TB/s.
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
SOURCE = "p2p_gossip_tpu_torch/csrc/gossip_kernels.cu"
REPLACES = {
    "gather_or": "p2p_gossip_tpu/ops/ell.py:157",
    "popcount_rows": "p2p_gossip_tpu/ops/pallas_kernels.py:152",
    "coverage_per_slot": "p2p_gossip_tpu/ops/pallas_kernels.py:122",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median milliseconds of ``fn`` over ``reps`` runs, each bracketed by
    CUDA events on the current stream."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound_ms(nbytes: int) -> float:
    return nbytes / PEAK_BYTES_PER_S * 1e3


def random_words(rng, shape, dev):
    """uint32 words with every bit in play, as the int32 bit pattern."""
    import torch

    n = int(np.prod(shape))
    words = np.frombuffer(rng.bytes(4 * n), dtype=np.int32).reshape(shape)
    return torch.as_tensor(words.copy(), device=dev)


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
    """gather_or on awkward shapes: W of 1, 3 and 300 (> one block of
    threads), per-edge and uniform slots, destination rows in shuffled
    order with some outside [0, N) (dropped), and a zero-width ELL."""
    import torch

    from p2p_gossip_tpu_torch.ops import kernels

    for n, cap, w, ring, per_edge in ((1237, 7, 3, 4, True), (513, 5, 1, 2, False),
                                      (300, 9, 300, 6, True), (64, 0, 2, 2, False)):
        hist = random_words(rng, (ring, n, w), dev)
        idx = torch.as_tensor(rng.integers(0, n, (n, cap)).astype(np.int32), device=dev)
        mask = torch.as_tensor(rng.random((n, cap)) < 0.7, device=dev)
        delay = (torch.as_tensor(rng.integers(1, ring, (n, cap)).astype(np.int32),
                                 device=dev) if per_edge else None)
        rows = rng.permutation(n + 6)[:n].astype(np.int32) - 3
        rows = torch.as_tensor(rows, device=dev)
        slot = None if per_edge else 1
        outs = []
        for plain in (False, True):
            out = torch.zeros((n, w), dtype=torch.int32, device=dev)
            outs.append(kernels.gather_or(hist, 5, idx, mask, delay, uniform_slot=slot,
                                          rows=rows, out=out, plain=plain))
        compare(f"gather_or[n={n} cap={cap} w={w} D={ring}]", *outs)
    log("gather_or ragged shapes (W 1/3/300, per-edge, out-of-range rows, "
        "cap 0): bitwise equal")


def check_gather(dg, dg_edge, n, w, dev, rng, reps):
    """gather_or at the main path's buckets (uniform delay 1, W words) and
    with per-edge delays (ring D from the staged delays)."""
    import torch

    from p2p_gossip_tpu_torch.ops.ell import propagate_bucketed

    rows_bytes = 4 * n
    results = {}
    for label, g in (("uniform", dg), ("per_edge", dg_edge)):
        hist = random_words(rng, (g.ring_size, n, w), dev)
        tick = 2 * g.ring_size + 1

        def run(plain, g=g, hist=hist, tick=tick):
            return propagate_bucketed(
                hist, tick, g.buckets, n_out=n, ring_size=g.ring_size,
                uniform_delay=g.uniform_delay, plain=plain,
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
        nbytes = src_rows * w * 4 + staged * per_entry + rows_bytes + n * w * 4
        ms = time_ms(lambda: run(False), reps)
        plain_ms = time_ms(lambda: run(True), max(2, reps // 4), warmup=1)
        results[label] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms(nbytes),
            ring=g.ring_size, buckets=len(g.buckets), staged_entries=staged,
        )
        log(
            f"gather_or[{label}] N={n} W={w} D={g.ring_size} buckets="
            f"{len(g.buckets)} entries={staged}: bitwise equal; one tick (all "
            f"buckets): kernel {ms:.3f} ms, "
            f"plain {plain_ms:.3f} ms, bound {bound_ms(nbytes):.4f} ms "
            f"({nbytes / 1e6:.1f} MB)"
        )
        del hist
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
    ms = time_ms(lambda: kernels.popcount_rows(words), reps)
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
    words = random_words(rng, (n, w), dev)
    slots = w * 32
    err = compare("coverage_per_slot", kernels.coverage_per_slot(words, slots),
                  kernels.coverage_per_slot_plain(words, slots))
    ms = time_ms(lambda: kernels.coverage_per_slot(words, slots), reps)
    plain_ms = time_ms(lambda: kernels.coverage_per_slot_plain(words, slots), reps)
    nbytes = n * w * 4 + slots * 4
    log(
        f"coverage_per_slot ({n}, {w}) -> {slots}: bitwise equal; kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms(nbytes):.4f} ms"
    )
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms(nbytes))


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

def main_path(graph, dg, dev):
    import torch

    import p2p_gossip_tpu_torch as pt
    from p2p_gossip_tpu_torch.engine.sync import (
        run_flood_coverage,
        run_sync_sim,
        time_to_coverage,
    )
    from p2p_gossip_tpu_torch.ops import kernels

    rng = np.random.default_rng(SEED)
    sched = pt.Schedule(
        graph.n,
        rng.integers(0, graph.n, N_SHARES).astype(np.int32),
        rng.integers(0, GEN_WINDOW, N_SHARES).astype(np.int32),
    )
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
    modeled = dg.hbm_bytes_per_tick(w) * ticks
    log(
        f"main path: N={graph.n} shares={N_SHARES} W={w} ticks={ticks} "
        f"wall={wall:.4f} s -> {totals['processed'] / wall:.4e} node-updates/s, "
        f"{wall / ticks * 1e3:.3f} ms/tick, modeled {modeled / wall / 1e9:.1f} GB/s "
        f"({dg.hbm_bytes_per_tick(w) / 1e9:.3f} GB/tick model); "
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
    return launches, sched


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
    gather = check_gather(dg, dg_edge, graph.n, w_flood, dev, rng, reps=10)
    popcount = check_popcount(graph.n, w_flood, dev, rng, reps=20)
    coverage = check_coverage(graph.n, w_cov, dev, rng, reps=20)
    del dg_edge
    torch.cuda.empty_cache()

    check_engine_paths(dev)
    launches, sched = main_path(graph, dg, dev)
    profile_flood(graph, sched, dg, dev)

    measured = {"gather_or": gather["uniform"], "popcount_rows": popcount,
                "coverage_per_slot": coverage}
    record = []
    for name, m in measured.items():
        record.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": m["max_abs_err"], "ms": m["ms"],
            "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": "bytes", "library_ms": None,
        })
    print(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
