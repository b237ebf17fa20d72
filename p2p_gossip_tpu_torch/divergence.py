"""Cross-engine divergence bisector — compare digest streams, name the tick.

    python -m p2p_gossip_tpu_torch.divergence                  # all pairs, on the card
    python -m p2p_gossip_tpu_torch.divergence --device cpu     # the plain versions
    python -m p2p_gossip_tpu_torch.divergence --pair native-sync --n 128 --horizon 32
    python -m p2p_gossip_tpu_torch.divergence --inject-fault 7  # self-test: must name 7
    python -m p2p_gossip_tpu_torch.divergence --json           # one JSON line on stdout
    torchrun --nproc-per-node 4 -m p2p_gossip_tpu_torch.divergence  # sharded pairs on NCCL

The JAX package's ``scripts/divergence.py`` on the port, with its pairs,
flags, report and exit code. It runs the same seeded workload through two
engine configurations, collects their per-tick state digests
(`telemetry.digest`), and reports the first tick where the streams
disagree (`telemetry.compare`). Engines that agree produce bit-identical
digests, so a clean run reports zero divergence across every pair, and a
disagreement is located exactly, with no second run.

Pairs (the same workload and engine knobs as the JAX script's):

  native-sync        the host event engine digested after every tick
                     (`telemetry.compare.capture_event_digests`) vs the
                     device flood (`engine.sync.run_sync_sim`)
  sync-campaign      solo flood vs replica 0 of a flood campaign
                     (`batch.campaign.run_coverage_campaign`)
  pushpull-campaign  solo push-pull vs replica 0 of the push-pull
                     campaign (`run_protocol_campaign`)
  sync-sharded       solo flood vs `parallel.engine_sharded.run_sharded_sim`
                     on a 2 x 2 mesh (nodes x shares)
  sync-delta         the sharded flood with the ring sharded vs the same
                     runner with the frontier-delta exchange
  sharded-campaign   the sharded flood on a 2 x 1 node mesh vs replica 0
                     of `batch.campaign_sharded.run_sharded_campaign` on a
                     (2 replicas x 2 nodes) mesh
  sync-async         the sharded flood on delays clamped to K = 2
                     (`parallel.async_ticks.clamp_flood_delays`) vs the
                     async exchange (``async_k=2``) on the original delays
  sync-hub           the sharded flood, dense vs ``exchange="hub"`` with
                     ``hub_rows=8``

The five sharded pairs need a world of at least 4 ranks. A process that
is a rank of one (``torchrun``) runs them on its meshes, every rank
entering every collective and the first rank alone printing. Otherwise one
world of 4 gloo ranks (`parallel.launch.spawn`) on the chosen device runs
all of them and returns their streams.

``--inject-fault T`` flips one bit of each pair's second stream at tick T
and requires the comparison to name exactly T: exit 0 iff every pair
locates it. Without it, exit 0 iff no pair diverges; a divergence also
dumps both streams' digests within ``--window`` ticks of it, and for
native-sync the host engine's frontier there. The JAX script's
``--with-cost`` (XLA's cost analysis) has no counterpart.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np

PAIRS = (
    "native-sync",
    "sync-campaign",
    "pushpull-campaign",
    "sync-sharded",
    "sync-delta",
    "sharded-campaign",
    "sync-async",
    "sync-hub",
)
SHARDED_PAIRS = PAIRS[3:]
WORLD = 4  # ranks of the sharded pairs' meshes: 2 x 2


def _capture_events(run) -> list:
    """Run ``run()`` with the telemetry sink pointed at a throwaway file
    and its device rings on, and hand back the captured event list."""
    from p2p_gossip_tpu_torch import telemetry

    fd, path = tempfile.mkstemp(suffix=".jsonl", prefix="divergence_")
    os.close(fd)
    telemetry.configure(path, rings=True)
    try:
        run()
    finally:
        telemetry.close()
    events = list(telemetry.events())
    telemetry.reset()
    try:
        os.unlink(path)
    except OSError:
        pass
    return events


def _stream(events, kernel, **where) -> dict:
    from p2p_gossip_tpu_torch.telemetry import compare

    return compare.select_stream(compare.digest_streams(events), kernel=kernel, **where)


def _workload(args):
    """The shared seeded workload: an ER graph and a staggered flood
    schedule (three generation waves exercise the delay line)."""
    from p2p_gossip_tpu_torch.models.generation import Schedule
    from p2p_gossip_tpu_torch.models.topology import erdos_renyi

    graph = erdos_renyi(args.n, args.p, seed=args.seed)
    rng = np.random.default_rng(args.seed)
    origins = rng.integers(0, args.n, args.shares).astype(np.int32)
    gen = (np.arange(args.shares, dtype=np.int32) % 3) * 2
    return graph, Schedule(graph.n, origins, gen)


def _replicas(args, graph):
    from p2p_gossip_tpu_torch.batch.campaign import flood_replicas

    return flood_replicas(graph, args.shares, [args.seed, args.seed + 1], args.horizon)


def pair_native_sync(args):
    from p2p_gossip_tpu_torch.engine.sync import run_sync_sim
    from p2p_gossip_tpu_torch.telemetry import compare

    graph, sched = _workload(args)
    cap = compare.capture_event_digests(graph, sched, args.horizon)
    events = _capture_events(lambda: run_sync_sim(graph, sched, args.horizon,
                                                  chunk_size=args.chunk, device=args.device))
    return cap.digests, _stream(events, "engine.sync")


def pair_sync_campaign(args):
    from p2p_gossip_tpu_torch.batch.campaign import run_coverage_campaign
    from p2p_gossip_tpu_torch.engine.sync import run_sync_sim

    graph, _ = _workload(args)
    reps = _replicas(args, graph)
    solo = _capture_events(lambda: run_sync_sim(
        graph, reps.replica_schedule(0, args.horizon), args.horizon,
        chunk_size=args.chunk, device=args.device))
    camp = _capture_events(lambda: run_coverage_campaign(graph, reps, args.horizon,
                                                         device=args.device))
    return (_stream(solo, "engine.sync"),
            _stream(camp, "batch.campaign", replica=0))


def pair_pushpull_campaign(args):
    from p2p_gossip_tpu_torch.batch.campaign import run_protocol_campaign
    from p2p_gossip_tpu_torch.models.generation import Schedule
    from p2p_gossip_tpu_torch.models.protocols import run_pushpull_sim

    graph, _ = _workload(args)
    reps = _replicas(args, graph)
    # The campaign's solo reference: flood-style origins from the replica
    # seed, all generated at t=0 (batch/campaign.py's replica contract).
    origins = (np.random.default_rng(args.seed)
               .integers(0, graph.n, args.shares).astype(np.int32))
    sched = Schedule(graph.n, origins, np.zeros(args.shares, dtype=np.int32))
    solo = _capture_events(lambda: run_pushpull_sim(
        graph, sched, args.horizon, seed=args.seed, churn=reps.replica_churn(0),
        record_coverage=True, device=args.device))
    camp = _capture_events(lambda: run_protocol_campaign(
        graph, reps, args.horizon, protocol="pushpull", device=args.device))
    return (_stream(solo, "models.protocols"),
            _stream(camp, "run_protocol_campaign", replica=0))


# --- the sharded pairs: every rank of the world calls each of them --------


class Meshes:
    """The sharded pairs' meshes over the world's first ranks, each built
    on first use (a collective: every rank builds them in one order)."""

    def __init__(self, device):
        self.device = device
        self._built: dict = {}

    def get(self, *shape, **kwargs):
        from p2p_gossip_tpu_torch.parallel.mesh import make_mesh

        key = (shape, tuple(sorted(kwargs.items())))
        if key not in self._built:
            self._built[key] = make_mesh(*shape, device=self.device, **kwargs)
        return self._built[key]


def _on_mesh(mesh, run, kernel, **where):
    """``run()``'s stream on this mesh's first rank, None on its other
    ranks; a rank outside the mesh does not call ``run``."""
    if mesh.coordinate is None:
        return None
    events = _capture_events(run)
    return _stream(events, kernel, **where) if mesh.is_first else None


def _sharded_run(args, graph, sched, mesh, **kw):
    from p2p_gossip_tpu_torch.parallel.engine_sharded import run_sharded_sim

    return _on_mesh(mesh, lambda: run_sharded_sim(graph, sched, args.horizon, mesh,
                                                  chunk_size=args.chunk, **kw),
                    "engine_sharded", shard=0)


def world_sync_sharded(args, meshes):
    from p2p_gossip_tpu_torch.engine.sync import run_sync_sim

    graph, sched = _workload(args)
    mesh = meshes.get(2, 2)
    solo = None
    if mesh.is_first:
        solo = _stream(_capture_events(lambda: run_sync_sim(
            graph, sched, args.horizon, chunk_size=args.chunk, device=mesh.device)),
            "engine.sync")
    # Shard 0 owns the pass's first chunk_size share slots: with the whole
    # schedule in one chunk, the solo stream's share set.
    return solo, _sharded_run(args, graph, sched, mesh)


def world_sync_delta(args, meshes):
    graph, sched = _workload(args)
    mesh = meshes.get(2, 2)
    return (_sharded_run(args, graph, sched, mesh, ring_mode="sharded"),
            _sharded_run(args, graph, sched, mesh, exchange="delta"))


def world_sharded_campaign(args, meshes):
    from p2p_gossip_tpu_torch.batch.campaign_sharded import run_sharded_campaign
    from p2p_gossip_tpu_torch.parallel.engine_sharded import run_sharded_sim

    graph, _ = _workload(args)
    reps = _replicas(args, graph)
    # A factorized (2 replicas x 2 nodes) mesh vs a solo nodes-only mesh
    # with the same node-shard count: the campaign's bitwise contract.
    mesh_s = meshes.get(2, 1)
    mesh_c = meshes.get(2, replicas=2)
    solo = _on_mesh(mesh_s, lambda: run_sharded_sim(
        graph, reps.replica_schedule(0, args.horizon), args.horizon, mesh_s,
        chunk_size=args.shares), "engine_sharded", shard=0)
    camp = _on_mesh(mesh_c, lambda: run_sharded_campaign(graph, reps, args.horizon, mesh_c),
                    "run_sharded_campaign", replica=0)
    return solo, camp


def world_sync_async(args, meshes):
    from p2p_gossip_tpu_torch.models.latency import lognormal_delays
    from p2p_gossip_tpu_torch.parallel import async_ticks

    graph, sched = _workload(args)
    mesh = meshes.get(2, 2)
    delays = lognormal_delays(graph, mean_ticks=2.0, sigma=0.5, max_ticks=4, seed=args.seed)
    k = 2
    # The async contract: async(K) == sync with cross-shard delays clamped
    # to max(d, K) host-side, tick for tick.
    ref_delays = async_ticks.clamp_flood_delays(graph, 2, k, ell_delays=delays)
    return (_sharded_run(args, graph, sched, mesh, ring_mode="sharded", ell_delays=ref_delays),
            _sharded_run(args, graph, sched, mesh, exchange="async", async_k=k,
                         ell_delays=delays))


def world_sync_hub(args, meshes):
    graph, sched = _workload(args)
    mesh = meshes.get(2, 2)
    # hub_rows=8 forces a non-empty hub set: the small ER workload is too
    # flat for the modeled crossover to pick one, and an empty hub would
    # make this the delta pair.
    return (_sharded_run(args, graph, sched, mesh, ring_mode="sharded"),
            _sharded_run(args, graph, sched, mesh, exchange="hub", hub_rows=8))


_WORLD_FNS = {
    "sync-sharded": world_sync_sharded,
    "sync-delta": world_sync_delta,
    "sharded-campaign": world_sharded_campaign,
    "sync-async": world_sync_async,
    "sync-hub": world_sync_hub,
}


def world_pairs(names, arg_dict: dict, device, meshes: Meshes | None = None) -> dict:
    """Every rank of a world of at least `WORLD` ranks: the named sharded
    pairs' two streams, ``{name: (a, b)}`` on the first rank (None halves
    elsewhere), for the flags ``arg_dict`` on ``device``. A worker for
    `parallel.launch.spawn`, and what each rank of a ``torchrun`` world
    calls. ``meshes`` (this device's) carries meshes over from an earlier
    call."""
    from p2p_gossip_tpu_torch.parallel import launch

    args = argparse.Namespace(**dict(arg_dict, device=device))
    meshes = Meshes(device) if meshes is None else meshes
    out = {}
    for name in names:
        out[name] = _WORLD_FNS[name](args, meshes)
        launch.progress()
    return out


def _in_world() -> bool:
    """This process is a rank of a world that can hold the 2 x 2 meshes."""
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized() and dist.get_world_size() >= WORLD


def sharded_streams(names, args) -> dict:
    """The sharded pairs ``names``' streams ``{name: (a, b)}``, from one
    world: this process's, when it is a rank of a world of at least
    `WORLD` ranks (every rank must call; the first gets the streams),
    else 4 gloo ranks spawned on ``args.device``."""
    names = list(names)
    if not names:
        return {}
    if _in_world():
        return world_pairs(names, vars(args), args.device)
    from p2p_gossip_tpu_torch.parallel import launch
    from p2p_gossip_tpu_torch.utils.device import resolve_device

    return launch.spawn(world_pairs, WORLD, names, vars(args),
                        str(resolve_device(args.device)))[0]


def _sharded_pair(name):
    def run(args):
        return sharded_streams([name], args)[name]

    run.__name__ = f"pair_{name.replace('-', '_')}"
    return run


_PAIR_FNS = {
    "native-sync": pair_native_sync,
    "sync-campaign": pair_sync_campaign,
    "pushpull-campaign": pair_pushpull_campaign,
    **{name: _sharded_pair(name) for name in SHARDED_PAIRS},
}


def pair_streams(name: str, args):
    """One pair's two digest streams ``(a, b)``, each ``{tick: value}``."""
    return _PAIR_FNS[name](args)


def _frontier_window(args, tick: int) -> dict:
    """Host frontier capture around a divergent tick (native-sync)."""
    from p2p_gossip_tpu_torch.telemetry import compare

    graph, sched = _workload(args)
    lo = max(tick - args.window, 0)
    hi = min(tick + args.window, args.horizon - 1)
    cap = compare.capture_event_digests(graph, sched, args.horizon, window=(lo, hi))
    return {
        str(t): {
            "received_total": int(cap.received[t].sum()),
            "seen_total": int(cap.seen_counts[t].sum()),
            "top_received": [
                [int(i), int(cap.received[t][i])]
                for i in np.argsort(cap.received[t])[-5:][::-1]
            ],
        }
        for t in sorted(cap.received)
    }


def run_pair(name: str, args, built=None) -> dict:
    """One pair's report; ``built`` is its two streams when they were
    collected beforehand (`sharded_streams`), else the pair runs here."""
    from p2p_gossip_tpu_torch.telemetry import compare

    a, b = pair_streams(name, args) if built is None else built
    report: dict = {"pair": name}
    if args.inject_fault is not None:
        t = args.inject_fault
        try:
            faulty = compare.inject_fault(b, t, bit=args.fault_bit)
        except ValueError as e:
            return {**report, "fault_located": False, "error": str(e)}
        div = compare.first_divergence(a, faulty)
        report["fault_tick"] = t
        report["located_tick"] = div.tick
        report["fault_located"] = div.tick == t
        report["compared"] = div.compared
        return report
    div = compare.first_divergence(a, b)
    report.update(div.as_dict())
    if div.diverged:
        lo = max(div.tick - args.window, 0)
        hi = div.tick + args.window
        report["digest_window"] = {
            "a": {str(t): a[t] for t in sorted(a) if lo <= t <= hi},
            "b": {str(t): b[t] for t in sorted(b) if lo <= t <= hi},
        }
        if name == "native-sync":
            report["frontier"] = _frontier_window(args, div.tick)
    return report


def outcome(reports, inject_fault) -> dict:
    """The run's verdict and JSON line: ok iff every pair located the
    injected fault, or, without injection, iff no pair diverged."""
    if inject_fault is not None:
        ok = (all(r.get("fault_located", True) for r in reports)
              and any("fault_located" in r for r in reports))
    else:
        ok = not any(r.get("diverged") for r in reports)
    return {"ok": ok, "mode": "inject-fault" if inject_fault is not None else "compare",
            "pairs": reports}


def format_report(r: dict) -> str:
    if "skipped" in r:
        return f"{r['pair']}: SKIPPED ({r['skipped']})"
    if "error" in r:
        return f"{r['pair']}: FAULT INJECTION FAILED — {r['error']}"
    if "fault_located" in r:
        return (f"{r['pair']}: injected fault at tick {r.get('fault_tick')} -> located "
                f"{r.get('located_tick')} ({'OK' if r['fault_located'] else 'MISSED'}, "
                f"{r.get('compared', 0)} ticks compared)")
    if r.get("diverged"):
        return (f"{r['pair']}: DIVERGED at tick {r['tick']} "
                f"(a={r['a_value']:#010x} b={r['b_value']:#010x}, "
                f"{r['matched_head']} ticks agreed first)")
    return f"{r['pair']}: clean — {r['compared']} common ticks, zero divergence"


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pair", choices=PAIRS, action="append",
                    help="pair(s) to compare (default: all)")
    ap.add_argument("--n", type=int, default=96, help="nodes")
    ap.add_argument("--p", type=float, default=0.08, help="ER edge prob")
    ap.add_argument("--shares", type=int, default=4)
    ap.add_argument("--horizon", type=int, default=24)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--chunk", type=int, default=32,
                    help="solo/sharded share-chunk size")
    ap.add_argument("--inject-fault", type=int, default=None, metavar="T",
                    help="self-test: flip one digest bit at tick T in each "
                    "pair's second stream; exit 0 iff the bisector names T")
    ap.add_argument("--fault-bit", type=int, default=0)
    ap.add_argument("--window", type=int, default=2,
                    help="frontier-capture radius around a divergent tick")
    ap.add_argument("--json", action="store_true", help="one JSON line on stdout")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain torch versions)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    pairs = args.pair or list(PAIRS)
    sharded = [name for name in pairs if name in SHARDED_PAIRS]
    first, skipped = True, []
    if "WORLD_SIZE" in os.environ:  # a torchrun rank
        from p2p_gossip_tpu_torch.parallel.mesh import initialize_multihost, local_device

        device = local_device(None if args.device == "cuda" else args.device)
        args.device = str(device)
        rank, world = initialize_multihost(device=device)
        first = rank == 0
        if world < WORLD:
            skipped, sharded = sharded, []
    else:
        from p2p_gossip_tpu_torch.utils.device import resolve_device

        args.device = str(resolve_device(args.device))
    built = sharded_streams(sharded, args)
    if not first:
        return 0
    reports = [{"pair": name, "skipped": f"needs >= {WORLD} ranks"} if name in skipped
               else run_pair(name, args, built.get(name)) for name in pairs]
    out = outcome(reports, args.inject_fault)
    if args.json:
        print(json.dumps(out))
    else:
        for r in reports:
            print(format_report(r))
        print(f"divergence: {'OK' if out['ok'] else 'FAIL'}")
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
