"""Headline benchmark of the port — prints ONE JSON line on stdout.

    python -m p2p_gossip_tpu_torch.bench                       # on the card
    python -m p2p_gossip_tpu_torch.bench --device cpu --smoke  # the tests' size
    python -m p2p_gossip_tpu_torch.bench --repeats 5 --out bench.jsonl
    P2P_BENCH_PROFILE_DIR=trace/ python -m p2p_gossip_tpu_torch.bench

The counterpart of the JAX package's root ``bench.py``. Workload
(BASELINE.json config 3 as bench.py counts it): Erdős–Rényi N = 100,000,
p = 0.001 (mean degree ~100, built by the C++ builder, `runtime.native`),
8,192 shares from ``numpy.random.default_rng(0)``: uniform origins and
generation ticks in [0, 16), horizon 64, one 8,192-share chunk, flooded to
full coverage through `engine.sync.run_sync_sim`. Metric: node-updates/s,
one node-update being one node processing one new share (the reference's
``processed``). After one warm-up run (which builds the kernel library on
first use), ``--repeats`` K timed runs, each ending in the device-to-host
copy of the counters and each required to equal the warm-up's counters;
``value`` is the median of the K rates, ``runs`` every rate, ``spread``
(max - min) / median.

The row, key by key (bench.py's, without ``cost``, which reads XLA's
cost analysis):

- ``metric``, ``value``, ``unit``, ``ticks``: as bench.py, the metric
  naming the card (``torch.cuda.get_device_name``) or "CPU";
- ``runs``, ``spread``, ``ms_per_tick`` (median wall / ticks),
  ``processed`` (summed over nodes: shares x N at full coverage),
  ``device`` and ``power_limit`` (``nvidia-smi``'s ``power.limit``; null on
  the CPU): the port's additions;
- ``vs_baseline``: the rate against the C++ event engine
  (`runtime.native.run_native_sim`) on the first 2 shares;
- ``achieved_gbps``: `engine.sync.DeviceGraph.must_move_bytes_per_tick` x
  ticks / median wall (null on the CPU); ``pct_hbm_peak`` against 3,350
  GB/s (the H100 SXM's HBM3) and ``modeled_bytes_total``: null on the CPU
  and with ``--smoke``;
- ``campaign``: R = 32 replicas of a 1,024-node flood through
  `batch.campaign.run_coverage_campaign` against a warm loop of solo
  `engine.sync.run_flood_coverage` runs (``sequential_wall_s_est`` and
  ``speedup_vs_sequential`` are null: they timed JAX's jit-cache clears,
  and PyTorch keeps no jit cache); ``protocol_campaign``: the push-pull
  campaign cold and warm against a warm loop of solo `run_pushpull_sim`;
  both carry their ``processed``;
- ``serve``: the last line of ``python -m p2p_gossip_tpu_torch.serve.bench
  --smoke`` on this bench's device;
- ``exchange``, ``exchange_hub``, ``campaign_sharded``, ``async_ticks``:
  the mesh legs, on one world of 8 gloo CPU ranks
  (`parallel.launch.spawn`) at the JAX scripts' sizes, each labelled
  ``"platform": "cpu"``;
- ``telemetry``: host spans by phase (device rings stay off), the event
  count and the stream (``P2P_TELEMETRY``);
- ``staticcheck_ok``: whether the port's static-analysis gate (``python
  -m p2p_gossip_tpu_torch.staticcheck --json --device cpu``, run in a
  subprocess before the warm-up, outside every timed window) passed: true
  or false; a gate that crashes or times out raises.

``serve`` and the mesh legs are null with ``--smoke``, as in bench.py.
With ``P2P_BENCH_PROFILE_DIR`` set, one extra timed run goes under
``torch.profiler``: its Chrome trace is written there and the row gains
``profiled``, ``profile_trace``, ``profiled_wall_s``, ``busy_share`` and
``top_kernels`` (the ten kernels with the most device time, with their
launches); ``value`` always comes from the unprofiled runs.

``--device`` defaults to cuda and raises without it: there is no CPU
fallback, and no leg catches its own failure. ``--smoke`` takes bench.py's
smoke sizes (N = 2,000, p = 0.01, 256 shares); ``--device cpu`` runs the
kernels' plain versions, at the smoke sizes only. Diagnostics go to
stderr.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

# bench.py's sizes of the headline flood (bench.py:135-142; smoke :124-129).
FULL = dict(nodes=100_000, prob=0.001, shares=8192, gen_window=16, horizon=64, chunk=8192)
SMOKE = dict(nodes=2_000, prob=0.01, shares=256, gen_window=16, horizon=64, chunk=256)
SEED = 0
BASELINE_SHARES = 2
HBM_PEAK_GBPS = 3350.0  # H100 SXM HBM3, NVIDIA data sheet
# The campaign legs (bench.py:268-273).
CAMPAIGN = dict(replicas=32, nodes=1024, prob=0.01, shares=4, horizon=64)
CAMPAIGN_SMOKE = dict(replicas=4, nodes=256, prob=0.05, shares=2, horizon=32)
# The mesh legs: one world of MESH_RANKS gloo ranks. The exchange report is
# scripts/cost_report.py's (n = 96, horizon 24, 8 origins, a (4 nodes x 2
# shares) mesh); the sharded campaign and the async legs are
# scripts/mesh_rehearsal.py's with bench.py's argv (bench.py:481-485, :520-524).
MESH_RANKS = 8
MESH_LEGS = ("exchange", "exchange_hub", "campaign_sharded", "async_ticks")
EXCHANGE_FAMILIES = ("erdos_renyi", "barabasi_albert")
EXCHANGE = dict(n=96, horizon=24, origins=8, chunk=32, hub_rows=8, mesh=(4, 2))
REHEARSAL = dict(nodes=4000, prob=0.003, shares=32, horizon=32, delay_max_ticks=4)
REHEARSAL_REPLICAS, REHEARSAL_REPLICA_SHARDS = 4, 2
ASYNC_KS = (1, 2)
TOP_KERNELS = 10

# The row's keys (without the profiled run's).
ROW_KEYS = (
    "metric", "value", "unit", "runs", "spread", "ticks", "ms_per_tick", "processed",
    "device", "power_limit", "vs_baseline", "achieved_gbps", "pct_hbm_peak",
    "modeled_bytes_total", *MESH_LEGS, "serve", "campaign", "protocol_campaign", "telemetry",
    "staticcheck_ok",
)
STATICCHECK_TIMEOUT_S = 600
PROFILE_KEYS = ("profiled", "profile_trace", "profiled_wall_s", "busy_share", "top_kernels")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _bare_uuid(uuid: str) -> str:
    uuid = uuid.strip().lower()
    return uuid[4:] if uuid.startswith("gpu-") else uuid


def card(device) -> tuple[str, str | None]:
    """(the device's name, its power limit as ``nvidia-smi`` prints it):
    ("cpu", None) on the CPU. ``nvidia-smi`` lists every card in its own
    order whatever ``CUDA_VISIBLE_DEVICES`` hides, so its line is the one
    whose UUID is the device's. Raises when ``nvidia-smi`` fails or lists
    no such card."""
    import torch

    if device.type != "cuda":
        return "cpu", None
    uuid = _bare_uuid(str(torch.cuda.get_device_properties(device).uuid))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=uuid,name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return torch.cuda.get_device_name(device), smi_power_limit(smi.stdout, uuid)


def smi_power_limit(smi_csv: str, uuid: str) -> str:
    """The power limit on the line of ``nvidia-smi --query-gpu=uuid,name,
    power.limit --format=csv,noheader`` whose UUID is ``uuid``."""
    for line in smi_csv.strip().splitlines():
        fields = [f.strip() for f in line.split(",")]
        if _bare_uuid(fields[0]) == _bare_uuid(uuid):
            log(", ".join(fields[1:]))
            return fields[-1]
    raise RuntimeError(f"nvidia-smi lists no card with UUID {uuid}:\n{smi_csv}")


def workload(cfg: dict, device):
    """The headline's graph (the C++ builder), schedule and staging."""
    import p2p_gossip_tpu_torch as pt
    from p2p_gossip_tpu_torch.engine.sync import DeviceGraph
    from p2p_gossip_tpu_torch.runtime import native
    from p2p_gossip_tpu_torch.telemetry import span

    t0 = time.perf_counter()
    with span("build_graph", n=cfg["nodes"]):
        graph = native.native_erdos_renyi(cfg["nodes"], cfg["prob"], seed=SEED)
    log(f"graph: N={graph.n} edges={graph.num_edges} dmax={graph.max_degree} "
        f"({time.perf_counter() - t0:.1f}s)")
    rng = np.random.default_rng(SEED)
    sched = pt.Schedule(
        graph.n,
        rng.integers(0, graph.n, cfg["shares"]).astype(np.int32),
        rng.integers(0, cfg["gen_window"], cfg["shares"]).astype(np.int32),
    )
    with span("stage"):
        dg = DeviceGraph.build(graph, device=device)
        _sync(device)
    return graph, sched, dg


def _label(device, smoke: bool) -> str:
    import torch

    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "CPU"
    return where + (", SMOKE" if smoke else "")


def headline(graph, sched, dg, cfg: dict, repeats: int, device, *, smoke: bool = False,
             reference=None, profile_dir: str | None = None) -> dict:
    """The flood: a warm-up run, then ``repeats`` timed runs whose per-node
    counters and executed ticks must equal ``reference``'s (default: the
    warm-up's), and full coverage. Returns the row's headline keys; with
    ``profile_dir``, also the profiled run's (`profile`)."""
    from p2p_gossip_tpu_torch.engine.sync import run_sync_sim
    from p2p_gossip_tpu_torch.telemetry import span

    if repeats < 1:
        raise ValueError(f"repeats must be >= 1, got {repeats}")
    name, power_limit = card(device)
    horizon, chunk = cfg["horizon"], cfg["chunk"]

    def flood():
        return run_sync_sim(graph, sched, horizon, chunk_size=chunk, device_graph=dg,
                            device=device)

    t0 = time.perf_counter()
    with span("warmup_compile"):
        warm = flood()
    log(f"warmup (incl. the kernel build on first use): {time.perf_counter() - t0:.2f}s")
    want = warm if reference is None else reference
    walls = []
    for i in range(repeats):
        _sync(device)
        t0 = time.perf_counter()
        with span("execute", run=i):
            stats = flood()
        walls.append(time.perf_counter() - t0)
        _check_same(f"timed run {i}", stats, want)
    processed = stats.totals()["processed"]
    if processed != sched.num_shares * graph.n:
        raise AssertionError(f"flood did not reach full coverage: processed {processed}, "
                             f"not {sched.num_shares} x {graph.n}")
    ticks = stats.extra["ticks_executed"]
    rates = [processed / w for w in walls]
    wall = float(np.median(walls))
    value = float(np.median(rates))
    bytes_tick = dg.must_move_bytes_per_tick(chunk // 32)
    on_card = device.type == "cuda"
    achieved_gbps = bytes_tick * ticks / wall / 1e9 if on_card else None
    full = on_card and not smoke
    log(f"flood: {processed} node-updates, {ticks} ticks, walls {walls} s -> median "
        f"{value:.4e}/s, {wall / ticks * 1e3:.3f} ms/tick"
        + (f"; {achieved_gbps:.1f} GB/s of must-move bytes" if on_card else ""))
    profiled = {}
    if profile_dir:
        stats, profiled = profile(flood, device, profile_dir)
        _check_same("the profiled run", stats, want)
    return {
        "metric": (f"node-updates/sec ({graph.n // 1000}K-node p={cfg['prob']:g} gossip "
                   f"flood, {_label(device, smoke)})"),
        "value": value,
        "unit": "node-updates/s",
        "runs": rates,
        "spread": (max(rates) - min(rates)) / value,
        "ticks": ticks,
        "ms_per_tick": wall / ticks * 1e3,
        "processed": processed,
        "device": name,
        "power_limit": power_limit,
        "achieved_gbps": achieved_gbps,
        "pct_hbm_peak": 100 * achieved_gbps / HBM_PEAK_GBPS if full else None,
        "modeled_bytes_total": bytes_tick * ticks if full else None,
        **profiled,
    }


def _check_same(label: str, stats, want) -> None:
    if not (stats.equal_counts(want)
            and stats.extra["ticks_executed"] == want.extra["ticks_executed"]):
        raise AssertionError(f"{label} differs from the reference run")


def baseline(graph, sched, horizon: int, rate: float) -> dict:
    """The C++ event engine on the first `BASELINE_SHARES` shares (the
    NS-3 role): ``vs_baseline`` = ``rate`` / its node-updates/s."""
    import p2p_gossip_tpu_torch as pt
    from p2p_gossip_tpu_torch.runtime import native
    from p2p_gossip_tpu_torch.telemetry import span

    base_sched = pt.Schedule(graph.n, sched.origins[:BASELINE_SHARES].copy(),
                             sched.gen_ticks[:BASELINE_SHARES].copy())
    t0 = time.perf_counter()
    with span("baseline"):
        base = native.run_native_sim(graph, base_sched, horizon)
    wall = time.perf_counter() - t0
    processed = base.totals()["processed"]
    log(f"baseline (native-c++): {processed} node-updates, "
        f"{base.extra['events_processed']} events in {wall:.2f}s = {processed / wall:.3g}/s")
    return {"vs_baseline": rate / (processed / wall)}


def _campaign_inputs(smoke: bool):
    import p2p_gossip_tpu_torch as pt
    from p2p_gossip_tpu_torch.batch.campaign import flood_replicas

    cfg = CAMPAIGN_SMOKE if smoke else CAMPAIGN
    graph = pt.erdos_renyi(cfg["nodes"], cfg["prob"], seed=SEED)
    reps = flood_replicas(graph, cfg["shares"], list(range(cfg["replicas"])), cfg["horizon"])
    return cfg, graph, reps


def _solo_origins(graph, s: int, shares: int) -> np.ndarray:
    return np.random.default_rng(s).integers(0, graph.n, shares).astype(np.int32)


def _check_campaign(label: str, camp, want) -> None:
    """``camp``'s per-replica counters and coverage equal ``want``'s
    (another campaign's result, from either package), else raise."""
    for key in ("generated", "received", "sent", "coverage"):
        got, ref = getattr(camp, key), getattr(want, key)
        if (got is None) != (ref is None) or (
                got is not None and not np.array_equal(np.asarray(got), np.asarray(ref))):
            raise AssertionError(f"{label}: {key} differs from the reference campaign")


def campaign(device, smoke: bool = False, reference=None) -> dict:
    """R flood replicas in one `run_coverage_campaign` (its first call:
    staging included) against a warm loop of R solo `run_flood_coverage`
    runs on one staging. With ``reference`` (a campaign result), the
    campaign's per-replica counters and coverage must equal it."""
    from p2p_gossip_tpu_torch.batch.campaign import run_coverage_campaign
    from p2p_gossip_tpu_torch.engine.sync import DeviceGraph, run_flood_coverage
    from p2p_gossip_tpu_torch.telemetry import span

    cfg, graph, reps = _campaign_inputs(smoke)
    r, horizon = cfg["replicas"], cfg["horizon"]
    _sync(device)
    t0 = time.perf_counter()
    with span("campaign", replicas=r):
        camp = run_coverage_campaign(graph, reps, horizon, device=device)
    wall = time.perf_counter() - t0
    if reference is not None:
        _check_campaign("campaign", camp, reference)
    processed = int((camp.generated + camp.received).sum())
    dg = DeviceGraph.build(graph, device=device)

    def solo(s):
        run_flood_coverage(graph, _solo_origins(graph, s, cfg["shares"]), horizon,
                           device_graph=dg, device=device)

    solo(0)  # warm, outside the timed loop
    t0 = time.perf_counter()
    for s in range(r):
        solo(s)
    warm_loop = time.perf_counter() - t0
    label = _label(device, smoke)
    log(f"campaign: R={r} x N={cfg['nodes']} flood in {wall:.4f}s = {processed / wall:.4g} "
        f"node-updates/s; warm loop {warm_loop:.4f}s -> {warm_loop / wall:.2f}x ({label})")
    return {
        "metric": (f"campaign node-updates/s (R={r} x {cfg['nodes']}-node flood, one "
                   f"batch, {label})"),
        "value": processed / wall,
        "replicas": r,
        "processed": processed,
        "wall_s": wall,
        "sequential_wall_s_est": None,
        "warm_loop_wall_s": warm_loop,
        "speedup_vs_sequential": None,
        "speedup_vs_warm_loop": warm_loop / wall,
    }


def protocol_campaign(device, smoke: bool = False, reference=None) -> dict:
    """The push-pull campaign on the flood campaign's replicas, cold (its
    first call) and warm, against a warm loop of R solo `run_pushpull_sim`
    runs recording coverage. The warm run's per-replica counters must
    equal the cold run's, or ``reference``'s when given."""
    import p2p_gossip_tpu_torch as pt
    from p2p_gossip_tpu_torch.batch.campaign import run_protocol_campaign
    from p2p_gossip_tpu_torch.models.protocols import run_pushpull_sim
    from p2p_gossip_tpu_torch.telemetry import span

    cfg, graph, reps = _campaign_inputs(smoke)
    r, horizon = cfg["replicas"], cfg["horizon"]

    def run():
        return run_protocol_campaign(graph, reps, horizon, protocol="pushpull", device=device)

    _sync(device)
    t0 = time.perf_counter()
    with span("protocol_campaign", replicas=r):
        camp = run()
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    again = run()
    warm = time.perf_counter() - t0
    if reference is not None:
        _check_campaign("protocol campaign, cold", camp, reference)
    _check_campaign("protocol campaign, warm", again, camp)
    processed = int((camp.generated + camp.received).sum())

    def solo(s):
        sched = pt.Schedule(graph.n, _solo_origins(graph, s, cfg["shares"]),
                            np.zeros(cfg["shares"], dtype=np.int32))
        run_pushpull_sim(graph, sched, horizon, seed=int(s), record_coverage=True,
                         device=device)

    solo(0)  # warm, outside the timed loop
    t0 = time.perf_counter()
    for s in range(r):
        solo(s)
    warm_loop = time.perf_counter() - t0
    label = _label(device, smoke)
    log(f"protocol campaign: R={r} x N={cfg['nodes']} pushpull in {cold:.4f}s cold / "
        f"{warm:.4f}s warm; warm loop {warm_loop:.4f}s -> {warm_loop / cold:.2f}x cold / "
        f"{warm_loop / warm:.2f}x warm ({label})")
    return {
        "metric": (f"pushpull campaign node-updates/s (R={r} x {cfg['nodes']}-node, one "
                   f"batch, {label})"),
        "value": processed / warm,
        "replicas": r,
        "processed": processed,
        "wall_s": cold,
        "warm_wall_s": warm,
        "sequential_warm_loop_s": warm_loop,
        "speedup_incl_compile": warm_loop / cold,
        "speedup_warm_vs_warm_loop": warm_loop / warm,
    }


def serve(device, smoke: bool = False) -> dict | None:
    """The serving leg: ``python -m p2p_gossip_tpu_torch.serve.bench
    --smoke`` on ``device`` in a subprocess (every request verified
    bitwise against its solo campaign); its JSON line. Null with
    ``--smoke``; a failing subprocess raises."""
    if smoke:
        return None
    from p2p_gossip_tpu_torch.telemetry import span

    env = {k: v for k, v in os.environ.items() if k not in ("P2P_TELEMETRY", "P2P_HEARTBEAT")}
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with span("serve"):
        proc = subprocess.run(
            [sys.executable, "-m", "p2p_gossip_tpu_torch.serve.bench", "--smoke",
             "--device", str(device)],
            capture_output=True, text=True, timeout=600, env=env, cwd=root,
        )
    if proc.returncode != 0:
        raise RuntimeError(f"serve leg failed (exit {proc.returncode}):\n"
                           f"{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
    row = json.loads(proc.stdout.strip().splitlines()[-1])
    log(f"serve leg: {row['requests']} requests @ {row['requests_per_s']}/s, p99 "
        f"{row['p99_turnaround_s']}s, occupancy {row['slot_occupancy']}, bitwise_ok="
        f"{row['bitwise_ok']} ({row['device']})")
    return row


# --- the mesh legs: every rank of the world runs each ----------------------


def _family_graph(family: str, n: int):
    from p2p_gossip_tpu_torch.models import topology

    if family == "erdos_renyi":
        return topology.erdos_renyi(n, 0.08, seed=SEED)
    if family == "barabasi_albert":
        return topology.barabasi_albert(n, 2, seed=SEED)
    raise ValueError(f"unknown family {family!r}")


def exchange_report(mesh) -> dict:
    """scripts/cost_report.py's ``run_exchange_report`` on the port: per
    topology family, the sharded flood once with the frontier-delta
    exchange and once with the hub/tail transport (8 hub rows forced),
    its ``stats.extra['exchange']`` reports, the cheapest path
    (``winner``) and the achieved-word ratios."""
    import p2p_gossip_tpu_torch as pt
    from p2p_gossip_tpu_torch.parallel import launch
    from p2p_gossip_tpu_torch.parallel.engine_sharded import run_sharded_sim

    cfg = EXCHANGE
    rows = []
    for family in EXCHANGE_FAMILIES:
        graph = _family_graph(family, cfg["n"])
        origins = np.random.default_rng(SEED).integers(0, graph.n, cfg["origins"])
        gens = (np.arange(cfg["origins"], dtype=np.int32) % 3) * 2
        sched = pt.Schedule(graph.n, origins.astype(np.int32), gens)
        ex = dict(run_sharded_sim(graph, sched, cfg["horizon"], mesh, chunk_size=cfg["chunk"],
                                  exchange="delta").extra["exchange"])
        hub = dict(run_sharded_sim(graph, sched, cfg["horizon"], mesh, chunk_size=cfg["chunk"],
                                   exchange="hub", hub_rows=cfg["hub_rows"]).extra["exchange"])
        launch.progress()
        dense = ex.get("modeled_dense_words_per_tick", 0)
        achieved = ex.get("achieved_delta_words_per_tick", 0.0)
        hub_achieved = hub.get("achieved_delta_words_per_tick", 0.0)
        costs = {"dense": dense or None, "delta": achieved or None, "hub": hub_achieved or None}
        rows.append({
            "family": family, "n": graph.n, **ex, "hub": hub,
            "winner": min((k for k, v in costs.items() if v), key=lambda k: costs[k],
                          default="dense"),
            "dense_over_delta": round(dense / achieved, 3) if achieved else None,
            "delta_over_hub": round(achieved / hub_achieved, 3) if hub_achieved else None,
            "ok": True,
        })
    return {"ok": True, "platform": mesh.device.type, "families": rows}


def exchange_hub_summary(exchange: dict) -> dict:
    """bench.py's ``exchange_hub``: each family's hub leg, distilled."""
    return {"platform": exchange["platform"], "families": [
        {"family": fam["family"], "hub_count": fam["hub"].get("hub_count"),
         "crossover_h": fam["hub"].get("crossover_h"),
         "modeled_hub_words_per_tick": fam["hub"].get("modeled_hub_words_per_tick"),
         "achieved_words_per_tick": fam["hub"].get("achieved_delta_words_per_tick"),
         "delta_over_hub": fam["delta_over_hub"], "winner": fam["winner"]}
        for fam in exchange["families"]]}


def _rehearsal_delays(graph):
    from p2p_gossip_tpu_torch.models.latency import lognormal_delays

    return lognormal_delays(graph, mean_ticks=2.0, sigma=0.6,
                            max_ticks=REHEARSAL["delay_max_ticks"], seed=SEED)


def campaign_sharded_leg(graph, mesh_c, mesh_s) -> dict | None:
    """scripts/mesh_rehearsal.py's campaign leg (``--replicas 4
    --replica-shards 2``): R flood replicas in `run_sharded_campaign` on
    the (replicas, nodes) mesh ``mesh_c``, cold and warm, against a warm
    loop of solo `run_sharded_sim` runs on ``mesh_s`` (the same node-shard
    count), every replica required bitwise equal to its solo run. The row
    on the first rank, None elsewhere."""
    from p2p_gossip_tpu_torch.batch.campaign import flood_replicas
    from p2p_gossip_tpu_torch.batch.campaign_sharded import run_sharded_campaign
    from p2p_gossip_tpu_torch.ops.bitmask import num_words
    from p2p_gossip_tpu_torch.parallel import launch
    from p2p_gossip_tpu_torch.parallel.engine_sharded import run_sharded_sim

    cfg, r = REHEARSAL, REHEARSAL_REPLICAS
    horizon = cfg["horizon"]
    delays = _rehearsal_delays(graph)
    reps = flood_replicas(graph, cfg["shares"], list(range(SEED, SEED + r)), horizon)

    def run_campaign():
        return run_sharded_campaign(graph, reps, horizon, mesh_c, ell_delays=delays)

    t0 = time.perf_counter()
    result = run_campaign()
    fresh = time.perf_counter() - t0
    t0 = time.perf_counter()
    result = run_campaign()
    warm = time.perf_counter() - t0
    launch.progress()
    if mesh_s.coordinate is None:
        return None

    def run_solo(i):
        return run_sharded_sim(graph, reps.replica_schedule(i, horizon), horizon, mesh_s,
                               ell_delays=delays, chunk_size=reps.shares_per_replica)

    t0 = time.perf_counter()
    run_solo(0)
    solo_fresh = time.perf_counter() - t0
    equal = []
    t0 = time.perf_counter()
    for i in range(r):
        st = run_solo(i)
        equal.append(bool(np.array_equal(st.received, result.received[i])
                          and np.array_equal(st.sent, result.sent[i])))
    solo_loop = time.perf_counter() - t0
    launch.progress()
    if not mesh_s.is_first:
        return None
    if not all(equal):
        raise AssertionError(f"sharded campaign differs from its solo runs: {equal}")
    ring = result.extra["ring"]
    row = {
        "rehearsal": "campaign_sharded", "platform": mesh_c.device.type,
        "nodes": graph.n, "topology": "er", "edges": graph.num_edges,
        "devices": len(mesh_c.ranks), "replicas": r,
        "replica_shards": result.extra["mesh"]["replica_shards"],
        "node_shards": result.extra["mesh"]["node_shards"],
        "local_replicas": result.extra["mesh"]["local_replicas"],
        "shares_per_replica": cfg["shares"], "horizon": horizon,
        "delay_values": int(len(np.unique(delays[graph.ell()[1]]))),
        "exchange_mode": "dense", "ring_mode": ring["mode"],
        "ring_bytes_per_chip": ring["bytes_per_chip"],
        "pad_shares": num_words(cfg["shares"]) * 32,
        "bitwise_equal_replicas": int(sum(equal)),
        "campaign_fresh_s": fresh, "campaign_warm_s": warm,
        "campaign_warm_per_replica_s": warm / r,
        "solo_fresh_s": solo_fresh, "solo_loop_warm_s": solo_loop,
        "solo_warm_per_replica_s": solo_loop / r,
        "speedup_warm_per_replica": solo_loop / warm,
        "exchange": result.extra["exchange"],
    }
    log(f"campaign-sharded leg: {row['bitwise_equal_replicas']}/{r} replicas bitwise, warm "
        f"x{row['speedup_warm_per_replica']:.2f} vs the solo loop (cpu ranks)")
    return row


def async_legs(graph, mesh) -> dict | None:
    """scripts/mesh_rehearsal.py's flood legs with ``--async-k 1,2`` on an
    all-nodes mesh: the replicated and sharded rings (dense), then the
    async exchange at each K. Every leg is checked against the
    single-device flood before its row is kept: bitwise for the
    synchronous legs and K = 1, the fixed point (counters and final
    coverage row) for K >= 2. The legs on the first rank, None elsewhere."""
    from p2p_gossip_tpu_torch.engine.sync import run_flood_coverage
    from p2p_gossip_tpu_torch.parallel import launch
    from p2p_gossip_tpu_torch.parallel.engine_sharded import run_sharded_flood_coverage

    cfg = REHEARSAL
    horizon = cfg["horizon"]
    delays = _rehearsal_delays(graph)
    origins = np.random.default_rng(SEED).integers(0, graph.n, cfg["shares"]).astype(np.int32)
    first = mesh.is_first
    if first:
        ref, ref_cov = run_flood_coverage(graph, origins, horizon, ell_delays=delays,
                                          device=mesh.device)
    legs = [("replicated", "dense", 0), ("sharded", "dense", 0)]
    legs += [("sharded", "async-dense", k) for k in ASYNC_KS]
    rows = []
    for ring_mode, exchange, k in legs:
        t0 = time.perf_counter()
        stats, cov = run_sharded_flood_coverage(
            graph, origins, horizon, mesh, ell_delays=delays, ring_mode=ring_mode,
            exchange=exchange, **({"async_k": k} if k else {}))
        wall = time.perf_counter() - t0
        launch.progress()
        if not first:
            continue
        stats.check_conservation()
        name = f"{ring_mode}/{exchange}" + (f"/K{k}" if k else "")
        if k >= 2:  # bounded staleness shifts the ticks; the fixed point stays
            same = stats.equal_counts(ref) and np.array_equal(ref_cov[-1], cov[-1])
        else:
            same = stats.equal_counts(ref) and np.array_equal(ref_cov, cov)
        if not same:
            raise AssertionError(f"async leg {name} differs from the single-device flood")
        rows.append({
            "ring_mode": stats.extra["ring"]["mode"], "exchange_mode": exchange,
            "async_k": k, "wall_s": wall, "wall_per_tick_s": wall / max(horizon, 1),
            "modeled_overlap_fraction": stats.extra["exchange"].get("modeled_overlap_fraction"),
        })
    if not first:
        return None
    log("async-ticks leg: " + "; ".join(
        f"{lg['exchange_mode']}" + (f"/K{lg['async_k']}" if lg["async_k"] else "")
        + f" {lg['wall_per_tick_s']:.4f}s/tick" for lg in rows) + " (cpu ranks, checked)")
    return {"platform": mesh.device.type, "legs": rows}


def mesh_worker(graph) -> dict | None:
    """A worker for `parallel.launch.spawn` on `MESH_RANKS` gloo CPU
    ranks: builds every mesh (a collective, in one order on every rank),
    then the three jobs on them. ``graph`` is the rehearsal graph. The
    mesh legs' keys on the first rank, None elsewhere."""
    from p2p_gossip_tpu_torch.parallel import launch
    from p2p_gossip_tpu_torch.parallel.mesh import make_mesh

    for var in ("P2P_TELEMETRY", "P2P_HEARTBEAT"):  # the parent's stream only
        os.environ.pop(var, None)
    device = "cpu"
    node_shards = MESH_RANKS // REHEARSAL_REPLICA_SHARDS
    ex_mesh = make_mesh(*EXCHANGE["mesh"], device=device)
    camp_mesh = make_mesh(node_shards, replicas=REHEARSAL_REPLICA_SHARDS, device=device)
    solo_mesh = make_mesh(node_shards, 1, device=device)
    async_mesh = make_mesh(MESH_RANKS, 1, device=device)
    launch.progress()
    exchange = exchange_report(ex_mesh)
    sharded = campaign_sharded_leg(graph, camp_mesh, solo_mesh)
    ticks = async_legs(graph, async_mesh)
    if not ex_mesh.is_first:
        return None
    return {"exchange": exchange, "exchange_hub": exchange_hub_summary(exchange),
            "campaign_sharded": sharded, "async_ticks": ticks}


def mesh_legs(smoke: bool = False) -> dict:
    """The mesh legs' row keys from one spawned world of `MESH_RANKS` gloo
    CPU ranks; all null with ``--smoke``."""
    if smoke:
        return dict.fromkeys(MESH_LEGS)
    from p2p_gossip_tpu_torch.parallel import launch
    from p2p_gossip_tpu_torch.runtime import native
    from p2p_gossip_tpu_torch.telemetry import span

    graph = native.native_erdos_renyi(REHEARSAL["nodes"], REHEARSAL["prob"], seed=SEED)
    t0 = time.perf_counter()
    with span("mesh_legs", ranks=MESH_RANKS):
        out = launch.spawn(mesh_worker, MESH_RANKS, graph)[0]
    log(f"mesh legs: {MESH_RANKS} gloo ranks in {time.perf_counter() - t0:.1f}s; exchange "
        + ", ".join(f"{f['family']} winner {f['winner']}" for f in out["exchange"]["families"]))
    return out


def staticcheck_ok() -> bool:
    """The port's static-analysis gate on the CPU, in a subprocess: its
    JSON report's ``ok``. Raises if the gate crashed (no report) or timed
    out."""
    from p2p_gossip_tpu_torch.telemetry import span

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    t0 = time.perf_counter()
    with span("staticcheck"):
        proc = subprocess.run(
            [sys.executable, "-m", "p2p_gossip_tpu_torch.staticcheck", "--json",
             "--device", "cpu"],
            capture_output=True, text=True, timeout=STATICCHECK_TIMEOUT_S, cwd=root)
    lines = proc.stdout.strip().splitlines()
    report = json.loads(lines[-1]) if lines and lines[-1].startswith("{") else None
    if proc.returncode not in (0, 1) or report is None or report["ok"] != (proc.returncode == 0):
        raise RuntimeError(f"the static-analysis gate crashed (exit {proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")
    log(f"staticcheck: {'ok' if report['ok'] else 'FAIL'}, {report['violations_total']} "
        f"violation(s) in {time.perf_counter() - t0:.1f}s")
    return bool(report["ok"])


# --- telemetry and the profiled run -----------------------------------------


def telemetry_summary() -> dict:
    """Span seconds by phase, the event count and the stream's path."""
    from p2p_gossip_tpu_torch import telemetry

    span_s: dict = {}
    for ev in telemetry.events():
        if ev.get("type") == "span":
            span_s[ev["name"]] = span_s.get(ev["name"], 0.0) + ev["dur"]
    return {"events": telemetry.event_count(), "span_s_by_phase": span_s,
            "stream": telemetry.path()}


def profile(flood, device, profile_dir: str):
    """One more timed ``flood()`` under ``torch.profiler``, its Chrome
    trace written to ``profile_dir``; the wall stops inside the
    profiler's context. Returns (its stats, the row's profile keys):
    ``busy_share`` is the CUDA kernels' summed device time over that wall
    and ``top_kernels`` the `TOP_KERNELS` kernels with the most device
    time (null and empty on the CPU)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from p2p_gossip_tpu_torch.telemetry import span

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    _sync(device)
    with torch_profile(activities=activities) as prof:
        t0 = time.perf_counter()
        with span("profile"):
            stats = flood()
        wall = time.perf_counter() - t0
    trace = os.path.join(profile_dir, "bench_trace.json")
    prof.export_chrome_trace(trace)
    device_us: dict[str, float] = {}
    launches: dict[str, int] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            device_us[e.name] = device_us.get(e.name, 0.0) + e.time_range.elapsed_us()
            launches[e.name] = launches.get(e.name, 0) + 1
    top = sorted(device_us.items(), key=lambda kv: -kv[1])[:TOP_KERNELS]
    busy = sum(device_us.values()) / (wall * 1e6) if device_us else None
    log(f"profiler trace written to {trace}; device busy share {busy}")
    return stats, {
        "profiled": True, "profile_trace": trace, "profiled_wall_s": wall,
        "busy_share": busy,
        "top_kernels": [{"name": n, "device_ms": us / 1e3, "launches": launches[n]}
                        for n, us in top],
    }


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain torch versions and "
                         "needs --smoke)")
    ap.add_argument("--smoke", action="store_true",
                    help="bench.py's smoke sizes (N = 2,000, p = 0.01, 256 shares); no serve "
                         "and no mesh legs")
    ap.add_argument("--repeats", type=int, default=3, help="timed runs of the flood (K)")
    ap.add_argument("--out", help="also append the JSON line to FILE")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    from p2p_gossip_tpu_torch import telemetry
    from p2p_gossip_tpu_torch.utils.device import resolve_device

    args = parse_args(argv)
    device = resolve_device(args.device)
    if device.type != "cuda" and not args.smoke:
        raise SystemExit(f"--device {device.type} runs the plain versions at --smoke sizes "
                         "only; add --smoke")
    cfg = SMOKE if args.smoke else FULL
    # Host spans only: the device rings would change the kernels timed.
    telemetry.configure(os.environ.get("P2P_TELEMETRY") or None, rings=False)
    try:
        gate_ok = staticcheck_ok()
        graph, sched, dg = workload(cfg, device)
        head = headline(graph, sched, dg, cfg, args.repeats, device, smoke=args.smoke,
                        profile_dir=os.environ.get("P2P_BENCH_PROFILE_DIR") or None)
        row = dict(head, **baseline(graph, sched, cfg["horizon"], head["value"]))
        row["campaign"] = campaign(device, args.smoke)
        row["protocol_campaign"] = protocol_campaign(device, args.smoke)
        row.update(mesh_legs(args.smoke))
        row["serve"] = serve(device, args.smoke)
        row["telemetry"] = telemetry_summary()
        row["staticcheck_ok"] = gate_ok
    finally:
        telemetry.close()
    line = json.dumps(row)
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
