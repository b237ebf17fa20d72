"""One run of one cell: set-up, the measured window, the traced records,
the check against the plain reference, and the result line's parts.

Every rank of a multi-card cell runs this same code on its own card and
takes every branch between collectives alike: the window's end is rank
0's decision, broadcast after each simulation; the simulations' inputs
are drawn from (seed, index) on every rank alike.
"""

from __future__ import annotations

import dataclasses
import gc
import hashlib
import json
import os
import time

import numpy as np
import torch

from gossipbench import check, roofline, spec
from gossipbench.gen import schedule as gen_schedule
from gossipbench.gen import topology as gen_topology
from gossipbench.reference import flood as ref
from gossipbench.trace import Tracer

#: Edge lists already drawn, by (configuration, graph, seed): a later run
#: of a seed in this checkout loads its graph instead of drawing it again.
GRAPH_CACHE = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".cache")

# Streams of the run's generator: seed -> (stream, ...) -> numpy Generator.
_GRAPH, _SIM, _WARM, _SAMPLE, _CONTROL = 1, 2, 3, 4, 5


def process_start() -> float:
    """This process's start on the ``time.perf_counter`` clock (Linux
    /proc; the import of this module where that is missing)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.perf_counter() - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return _IMPORTED


_IMPORTED = time.perf_counter()


def rng(seed: int, *stream) -> np.random.Generator:
    return np.random.default_rng([int(seed) % 2**64, *stream])


class World:
    """The ranks of a run: one (rank 0 of 1) or a torch.distributed world."""

    def __init__(self, device: torch.device, rank: int = 0, size: int = 1):
        self.device, self.rank, self.size = device, rank, size

    def agree(self, flag: bool) -> bool:
        """Rank 0's ``flag`` on every rank."""
        if self.size == 1:
            return flag
        import torch.distributed as dist

        t = torch.tensor([int(flag)], dtype=torch.int64, device=self.device)
        dist.broadcast(t, 0)
        return bool(t.item())

    def gather(self, obj) -> list:
        if self.size == 1:
            return [obj]
        import torch.distributed as dist

        out = [None] * self.size
        dist.all_gather_object(out, obj)
        return out

    def all_reduce(self, a, op: str = "sum"):
        """The elementwise ``op`` ("sum" or "max") of every rank's array
        ``a``, on every rank (NumPy in, NumPy out)."""
        if self.size == 1:
            return a
        import torch.distributed as dist

        t = torch.as_tensor(np.ascontiguousarray(a), device=self.device)
        dist.all_reduce(t, op={"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op])
        return t.cpu().numpy()


@dataclasses.dataclass
class Run:
    """What a rank measured and checked."""

    setup_s: float
    stage_s: float
    window_s: float
    walls: list
    updates: int
    ticks: int
    peak_bytes: int
    per_sim: list
    trace: dict | None
    occupancy: dict | None
    resident_bytes: int | None = None
    phases: dict | None = None  # seconds of set-up, window, trace reading, reference
    notes: list | None = None   # (simulation, first differences)
    max_degree: int = 0


def graph_edges(config: dict, seed: int, write: bool = True) -> np.ndarray:
    """The configuration's edge list for ``seed`` (int32 (m, 2)), from the
    checkout's graph cache or drawn (and then cached, written whole or
    not at all)."""
    key = hashlib.sha256(json.dumps(config["graph"], sort_keys=True).encode()).hexdigest()
    path = os.path.join(GRAPH_CACHE, f"{config['name']}-{key[:12]}-{int(seed) % 2**64}.npy")
    try:
        return np.load(path)
    except (OSError, ValueError):
        pass
    edges = gen_topology.edges_of(config["graph"], [int(seed) % 2**64, _GRAPH]).astype(np.int32)
    if write:
        os.makedirs(GRAPH_CACHE, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "wb") as f:
            np.save(f, edges)
        os.replace(tmp, path)
    return edges


def draw(cell: spec.Cell, seed: int, *stream):
    return gen_schedule.draw(cell.traffic["gen"], cell.config, rng(seed, *stream))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, world: World,
             control: bool = False, started: float | None = None) -> Run:
    """Set up, measure ``seconds``, check. ``control`` puts the plain
    reference with one lost delivery in the program's place for the
    check (the window runs the program as usual). The entry's own
    ``reference`` works each checked simulation out again."""
    started = process_start() if started is None else started
    device = world.device
    traffic, config = cell.traffic, cell.config
    n = int(config["graph"]["n"])
    entry = spec.entry(cell.entry)
    tracer = Tracer(trace, device)

    ctx = entry.prepare(device, config)
    t = time.perf_counter()
    edges = graph_edges(config, seed, write=world.rank == 0)
    graph_s = time.perf_counter() - t
    t = time.perf_counter()
    staged = entry.stage(ctx, n, edges)
    _sync(device)
    stage_s = time.perf_counter() - t
    origins, gen_ticks = draw(cell, seed, _WARM)
    entry.run(staged, origins, gen_ticks, traffic)  # warms every shape the window uses
    _sync(device)
    world.agree(True)  # every rank set up
    setup_s = time.perf_counter() - started

    keep = int(traffic.get("check_sims", 1))
    pick = rng(seed, _SAMPLE)
    sample, walls = [], []
    updates = ticks = 0
    resident = None
    with tracer.window():
        t0 = time.perf_counter()
        i = 0
        while True:
            with tracer.span("schedule"):
                origins, gen_ticks = draw(cell, seed, _SIM, i)
            with tracer.span("sim"):
                ts = time.perf_counter()
                result = entry.run(staged, origins, gen_ticks, traffic)
                te = time.perf_counter()
            walls.append(te - ts)
            updates += int(result["counters"]["processed"].sum())
            resident = result.get("resident_bytes", resident)
            if trace:
                ticks += int(entry.ticks(result, staged, traffic))
            item = (i, origins, gen_ticks, result)  # a reservoir sample of the window
            if i < keep:
                sample.append(item)
            else:
                slot = int(pick.integers(0, i + 1))
                if slot < keep:
                    sample[slot] = item
            i += 1
            if world.agree(te - t0 >= seconds):
                break
        window_s = te - t0
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    t = time.perf_counter()
    summary = tracer.summary() if trace else None
    phases = {"graph": graph_s, "setup": setup_s, "window": window_s,
              "trace": time.perf_counter() - t}

    entry.release(staged)
    del staged, result
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t = time.perf_counter()
    graph = (n, *ref.csr_from_edges(n, edges))
    del edges
    per_sim, notes, occ_bytes = [], [], {"tick": 0, "gather": 0, "updates": 0}
    for i, origins, gen_ticks, result in sorted(sample, key=lambda s: s[0]):
        args = (world, graph, origins, gen_ticks, traffic, config)
        expected, occ = entry.reference(*args, occupancy=trace)
        judged = result
        if control:
            lossy, _ = entry.reference(*args, lose_seed=int(rng(seed, _CONTROL, i).integers(2**31)))
            judged = {"counters": lossy, "coverage": lossy.get("coverage"),
                      "ticks": None if result.get("ticks") is None else lossy["ticks"]}
        per_sim.append(check.compare(judged, expected))
        notes.append((i, check.differences(judged, expected)))
        if trace:
            occ_bytes["tick"] += roofline.tick_bytes(occ)
            occ_bytes["gather"] += roofline.gather_bytes(occ)
            occ_bytes["updates"] += int(expected["processed"].sum())
    phases["reference"] = time.perf_counter() - t
    return Run(setup_s, stage_s, window_s, walls, updates, ticks, int(peak), per_sim, summary,
               occ_bytes if trace else None, resident, phases, notes,
               int(np.diff(graph[1]).max()))
