"""The benchmark's command:

    python3 -m gossipbench --workload NAME --seed N --seconds S --trace 0|1

loads the cell named in ``BENCHMARK.json``, sets up, measures for S
seconds, checks what the window produced against the plain reference,
and prints one JSON line last on standard output (``--trace 0``: the
cell's end-to-end metrics; ``--trace 1``: its per-layer metrics, with a
``breakdown``), the checked numbers beside their limits last on
standard error.

A cell on several cards starts one process a card: this process is rank
0 (the one that prints), and it starts the others with ``--rank``; they
meet over TCP on ``localhost``. ``--device cpu`` runs on the CPU (gloo
between ranks), for the tests only. ``--control 1`` judges the plain
reference with one lost delivery in the program's place.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import socket
import subprocess
import sys
import threading
import time

FORBIDDEN = ("jax", "jaxlib", "flax", "p2p_gossip_tpu")


def parse(argv=None):
    ap = argparse.ArgumentParser(prog="gossipbench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--root", default=None, help="folder of BENCHMARK.json (tests)")
    return ap.parse_args(argv)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (compared whole: ``p2p_gossip_tpu_torch`` is not ``p2p_gossip_tpu``)."""
    return sorted({m for m in list(sys.modules) if m.split(".", 1)[0] in FORBIDDEN})


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class Ranks:
    """The other ranks of a multi-card run, as child processes of rank 0.
    A rank that fails ends the run."""

    def __init__(self, args, chips: int):
        self.procs, self.errs = [], []
        base = [sys.executable, "-m", "gossipbench", "--workload", args.workload,
                "--seed", str(args.seed), "--seconds", str(args.seconds),
                "--trace", str(args.trace), "--device", args.device,
                "--control", str(args.control), "--port", str(args.port)]
        if args.root:
            base += ["--root", args.root]
        for r in range(1, chips):
            p = subprocess.Popen(base + ["--rank", str(r)], stdout=subprocess.DEVNULL,
                                 stderr=subprocess.PIPE, text=True)
            buf = []
            threading.Thread(target=lambda p=p, b=buf: b.extend(p.stderr), daemon=True).start()
            self.procs.append(p)
            self.errs.append(buf)
        self.done = threading.Event()
        threading.Thread(target=self._watch, daemon=True).start()

    def _watch(self):
        while not self.done.wait(1.0):
            for r, p in enumerate(self.procs, start=1):
                if p.poll() not in (None, 0):
                    time.sleep(2.0)  # let its error reach the buffer
                    self._relay()
                    print(f"gossipbench: rank {r} failed ({p.returncode})", file=sys.stderr)
                    self.kill()
                    os._exit(1)

    def _relay(self):
        for r, buf in enumerate(self.errs, start=1):
            for line in buf:
                sys.stderr.write(f"[rank {r}] {line}")
            buf.clear()
        sys.stderr.flush()

    def kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait()

    def join(self, timeout: float = 120.0) -> bool:
        self.done.set()
        deadline = time.monotonic() + timeout
        ok = True
        for p in self.procs:
            try:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                ok = False
        if not ok:
            self.kill()
        self._relay()
        return ok and all(p.returncode == 0 for p in self.procs)


def main(argv=None) -> int:
    args = parse(argv)
    os.environ.pop("P2P_TELEMETRY", None)  # the program's host spans stay off unless traced

    import torch

    from gossipbench import harness, spec

    started = harness.process_start()
    cell = spec.cell(args.workload, root=args.root or spec.ROOT)
    chips = cell.chips
    if args.device == "cuda" and (not torch.cuda.is_available()
                                  or torch.cuda.device_count() < chips):
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"gossipbench: {args.workload} needs {chips} CUDA device(s), found {have}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    ranks = None
    if chips > 1 and args.rank == 0 and not args.port:  # a given port: the ranks are up
        args.port = _free_port()
        ranks = Ranks(args, chips)
    if args.device == "cuda":
        device = torch.device("cuda", args.rank)
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
    if chips > 1:
        import torch.distributed as dist

        dist.init_process_group("nccl" if args.device == "cuda" else "gloo",
                                init_method=f"tcp://localhost:{args.port}",
                                world_size=chips, rank=args.rank,
                                timeout=datetime.timedelta(seconds=180))
    world = harness.World(device, args.rank, chips)
    try:
        run = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), world,
                               control=bool(args.control), started=started)
        gathered = world.gather({"trace": run.trace, "peak": run.peak_bytes})
    finally:
        if chips > 1:
            import torch.distributed as dist

            dist.destroy_process_group()
    if args.rank != 0:
        return 0
    if ranks is not None and not ranks.join():
        print("gossipbench: a rank did not end cleanly", file=sys.stderr)
        return 1
    line = result_line(cell, run, gathered, bool(args.trace), device)
    found = forbidden_modules()
    if found:
        print(f"gossipbench: JAX modules loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    walls = sorted(run.walls)
    print(f"gossipbench: {cell.name} seed {args.seed}: {len(walls)} simulations in "
          f"{run.window_s:.3f} s (walls: min {walls[0] * 1e3:.2f} ms, median "
          f"{walls[len(walls) // 2] * 1e3:.2f} ms); graph's largest degree {run.max_degree}; "
          "phases (s): " + ", ".join(f"{k} {v:.2f}" for k, v in run.phases.items()),
          file=sys.stderr)
    for i, diffs in run.notes:
        if diffs:
            print(f"simulation {i}: differences: {'; '.join(diffs)}", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


def device_info(device, chips: int, peak: int, trace) -> dict:
    import torch

    if device.type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
                "memory_peak_bytes": int(peak)}
        limit = _power_limit(device.index or 0)
        if limit is not None:
            info["power_limit_w"] = limit
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": chips, "memory_peak_bytes": 0}
    if trace:
        info["busy_s"] = sum(t["busy_s"] for t in trace) / len(trace)
        info["window_s"] = sum(t["window_s"] for t in trace) / len(trace)
    return info


def _power_limit(index: int):
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True, text=True, timeout=20)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def result_line(cell, run, gathered, trace: bool, device) -> dict:
    from gossipbench import check, spec

    correct, checks, failed = check.verdict(run.per_sim)
    traces = [g["trace"] for g in gathered] if trace else None
    dev = device_info(device, cell.chips, max(g["peak"] for g in gathered), traces)
    rec = records(cell, run, traces, dev)
    metrics = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        v = spec.metric_reader(m["name"])(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    line = {"correct": correct, "attempted": len(run.walls), "failed": failed,
            "metrics": metrics, "device": dev}
    if trace:
        t0 = traces[0]
        line["breakdown"] = {"device_ops": [[k, v] for k, v in t0["device_ops"][:10]],
                             "idle_gaps": [[k, v] for k, v in t0["idle_gaps"][:10]]}
    if run.resident_bytes is not None:
        line["resident_bytes"] = run.resident_bytes
    line["checks"] = checks
    return line


def records(cell, run, traces, dev) -> dict:
    """What the metrics' readers read (`gossipbench/metrics`)."""
    from gossipbench import roofline

    occ = run.occupancy or {}
    peak = roofline.peak_hbm_bytes_s(dev["kind"])
    return {
        "cell": cell.name,
        "chips": cell.chips,
        "window_s": run.window_s,
        "setup_s": run.setup_s,
        "updates": run.updates,
        "ticks": run.ticks,
        "sims": len(run.walls),
        "walls": run.walls,
        "stage_s": run.stage_s,
        "traces": traces,
        "on_device": dev["platform"] == "gpu",
        "peak_hbm_bytes_s": peak,
        "bytes_tick": roofline.window_bytes(occ.get("tick", 0), occ.get("updates", 0),
                                            run.updates),
        "bytes_gather": roofline.window_bytes(occ.get("gather", 0), occ.get("updates", 0),
                                              run.updates),
    }
