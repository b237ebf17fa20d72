"""Spawn W local ranks of one ``torch.distributed`` world and collect what
each returns — the launcher of the sharded engines' tests and of
``chip_smoke.py``'s multi-rank phase (``torchrun`` is the launcher for
users).

Every world rendezvouses through a ``file://`` store in a fresh temporary
directory (no TCP port, so concurrent worlds never collide), passes
``timeout=`` to ``init_process_group`` (a collective waiting on a dead
peer raises), and is joined under a deadline: `spawn` returns each rank's
result, or raises with the failing rank's traceback, and never waits past
the deadline. Workers are spawned (not forked) and import only this
package and torch.
"""

from __future__ import annotations

import contextlib
import datetime
import importlib
import io
import os
import queue as queue_mod
import shutil
import tempfile
import time
import traceback

from p2p_gossip_tpu_torch.parallel.mesh import DEFAULT_TIMEOUT_S


def _child(rank, world_size, store, backend, timeout_s, fn, args, results):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            backend, init_method=f"file://{store}", rank=rank,
            world_size=world_size, timeout=datetime.timedelta(seconds=timeout_s),
        )
        results.put((rank, True, fn(*args)))
    except BaseException:  # the parent re-raises it with this traceback
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, world_size: int, *args, backend: str = "gloo",
          timeout_s: float = DEFAULT_TIMEOUT_S) -> list:
    """Run ``fn(*args)`` on ranks 0..world_size-1 of a fresh world (each
    in its own spawned process, its default process group started) and
    return the list of their results in rank order. ``fn`` and ``args``
    must pickle (``fn`` a module-level function). A rank that raises, or
    dies, makes `spawn` stop every rank and raise RuntimeError with that
    rank's traceback; past a deadline of ``timeout_s`` + 60 s it stops
    them all and raises TimeoutError."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="p2p_spawn_")
    store = os.path.join(tmp, "rendezvous")
    procs = [
        ctx.Process(target=_child, daemon=True,
                    args=(r, world_size, store, backend, timeout_s, fn, args, results))
        for r in range(world_size)
    ]
    deadline = time.monotonic() + timeout_s + 60.0
    out: dict = {}
    try:
        for p in procs:
            p.start()
        while len(out) < world_size:
            try:
                rank, ok, value = results.get(timeout=0.2)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(
                        f"rank {dead[0]} died with exit code {procs[dead[0]].exitcode}"
                    ) from None
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"ranks {sorted(set(range(world_size)) - set(out))} of "
                        f"{world_size} did not finish in time"
                    ) from None
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world_size} failed:\n{value}")
            out[rank] = value
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(5.0)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [out[r] for r in range(world_size)]


def resolve(target: str):
    """``"package.module:function"`` -> the function."""
    module, _, name = target.partition(":")
    return getattr(importlib.import_module(module), name)


def call_on_meshes(calls, device="cpu") -> list:
    """A worker for `spawn`: for each ``(n_node_shards, n_share_shards,
    target, args, kwargs[, events])`` in ``calls``, on that mesh over the
    first ranks of the world, call ``target(*args, mesh=mesh, **kwargs)``.
    Each distinct shape's mesh is built once, in order of first use, on
    every rank. Returns one entry a call: the result, or None on a rank
    outside that mesh. A call with ``events`` true runs with telemetry and
    its device rings on (in memory), and its entry is ``(result, the
    events it emitted)``."""
    from p2p_gossip_tpu_torch import telemetry
    from p2p_gossip_tpu_torch.parallel.mesh import make_mesh

    meshes: dict = {}
    out = []
    for nodes, shares, target, args, kwargs, *events in calls:
        if (nodes, shares) not in meshes:
            meshes[nodes, shares] = make_mesh(nodes, shares, device=device)
        mesh = meshes[nodes, shares]
        if mesh.coordinate is None:
            out.append(None)
            continue
        if events and events[0]:
            telemetry.configure(None, rings=True)
            try:
                out.append((resolve(target)(*args, mesh=mesh, **kwargs),
                            telemetry.events()))
            finally:
                telemetry.reset()
        else:
            out.append(resolve(target)(*args, mesh=mesh, **kwargs))
    return out


def capture_cli(argvs) -> list:
    """A worker for `spawn`: the port's CLI on each argv of ``argvs`` in
    turn, with its standard output and error captured: a list of (exit
    code, stdout, stderr)."""
    from p2p_gossip_tpu_torch.utils import cli

    results = []
    for argv in argvs:
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli.run(list(argv))
        results.append((rc, out.getvalue(), err.getvalue()))
    return results
