"""Spawn W local ranks of one ``torch.distributed`` world and collect what
each returns — the launcher of the sharded engines' tests and of
``chip_smoke.py``'s multi-rank phase (``torchrun`` is the launcher for
users).

Every world rendezvouses through a ``file://`` store in a fresh temporary
directory (no TCP port, so concurrent worlds never collide), passes
``timeout=`` to ``init_process_group`` (a collective waiting on a dead
peer raises), and is joined under a deadline that counts from the world's
last progress: a rank reports progress with `progress` (the workers here
do after every call), so a world that keeps working is never stopped for
being slow under load, and one in which no rank has reported for
``timeout_s`` + ``grace`` seconds is. A rank's start (a fresh interpreter
importing torch, slow on a loaded host) has an allowance of its own, and
no rank enters the rendezvous before every rank has started: each
reports its start, then waits on a start event that the parent sets once
all have, so one rank's slow start never runs out another's ``timeout=``.
`spawn` returns each rank's result, or raises with the failing rank's
traceback. Workers are spawned (not forked) and import only this package
and torch.
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

# A rank's start (a fresh interpreter importing torch and this package)
# may take this long on a loaded host before the deadline applies to it.
STARTUP_S = 300.0
# In a rank that `spawn` started: (its rank, the queue to the parent).
_reporter = None


def progress() -> None:
    """Report to `spawn`'s parent that this rank is making progress: the
    world's deadline then counts afresh from now. Call it between units
    of work (a run, a call). Outside a rank that `spawn` started (the
    parent's own process, a ``torchrun`` rank) it does nothing."""
    if _reporter is not None:
        rank, results = _reporter
        results.put((rank, None, None))


def _child(rank, world_size, store, backend, timeout_s, fn, args, results, start):
    global _reporter
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    _reporter = (rank, results)
    progress()  # started: its imports are done
    start.wait()  # every rank has started
    try:
        dist.init_process_group(
            backend, init_method=f"file://{store}", rank=rank,
            world_size=world_size, timeout=datetime.timedelta(seconds=timeout_s),
        )
        if backend == "gloo":
            # Every rank's mesh is connected before any rank goes on: one
            # that finished at once would close its sockets on a peer still
            # connecting to it ("Connection closed by peer").
            dist.barrier()
        progress()
        results.put((rank, True, fn(*args)))
    except BaseException:  # the parent re-raises it with this traceback
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, world_size: int, *args, backend: str = "gloo",
          timeout_s: float = DEFAULT_TIMEOUT_S, grace: float = 60.0) -> list:
    """Run ``fn(*args)`` on ranks 0..world_size-1 of a fresh world (each
    in its own spawned process, its default process group started, with
    ``timeout_s`` as its collectives' timeout) and return the list of
    their results in rank order. ``fn`` and ``args`` must pickle (``fn`` a
    module-level function). A rank that raises, or dies, makes `spawn`
    stop every rank and raise RuntimeError with that rank's traceback.
    The deadline is ``timeout_s`` + ``grace`` seconds from the world's
    last progress (its spawn, a rank's `progress` report, a rank's
    result): past it, `spawn` stops every rank and raises TimeoutError.
    Until every rank has reported once (its imports done), the deadline
    is at least STARTUP_S from the spawn and no rank starts its process
    group; past it, the TimeoutError names the ranks that never started."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    start = ctx.Event()
    tmp = tempfile.mkdtemp(prefix="p2p_spawn_")
    store = os.path.join(tmp, "rendezvous")
    procs = [
        ctx.Process(target=_child, daemon=True,
                    args=(r, world_size, store, backend, timeout_s, fn, args, results,
                          start))
        for r in range(world_size)
    ]
    patience = timeout_s + grace
    t_spawn = time.monotonic()
    deadline = t_spawn + patience
    started: set = set()
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
                now = time.monotonic()
                starting = len(started) < world_size and now < t_spawn + STARTUP_S
                if now > deadline and not starting:
                    if len(started) < world_size:
                        raise TimeoutError(
                            f"ranks {sorted(set(range(world_size)) - started)} of "
                            f"{world_size} did not start in time"
                        ) from None
                    raise TimeoutError(
                        f"ranks {sorted(set(range(world_size)) - set(out))} of "
                        f"{world_size} did not finish in time"
                    ) from None
                continue
            started.add(rank)
            if len(started) == world_size:
                start.set()
            deadline = time.monotonic() + patience
            if ok is None:  # a progress report
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
    from p2p_gossip_tpu_torch.parallel.mesh import make_mesh

    return _call_all([(lambda n=nodes, s=shares: make_mesh(n, s, device=device), (nodes, shares),
                       *rest) for nodes, shares, *rest in calls])


def call_on_replica_meshes(calls, device="cpu") -> list:
    """`call_on_meshes` for the factorized meshes of the sharded campaigns:
    each call is ``(mesh_kwargs, target, args, kwargs[, events])``, its mesh
    ``make_mesh(**mesh_kwargs, device=device)`` (``replicas=`` and the rest,
    built once per distinct kwargs, in order of first use). A shape the
    world cannot hold raises ValueError before any collective, on every
    rank alike: its entry is then ``("ValueError", message)``."""
    from p2p_gossip_tpu_torch.parallel.mesh import make_mesh

    return _call_all([(lambda kw=mesh_kw: make_mesh(**kw, device=device),
                       tuple(sorted(mesh_kw.items())), *rest) for mesh_kw, *rest in calls])


def _call_all(calls) -> list:
    from p2p_gossip_tpu_torch import telemetry

    meshes: dict = {}
    out = []
    for build, key, target, args, kwargs, *events in calls:
        if key not in meshes:
            try:
                meshes[key] = build()
            except ValueError as e:
                meshes[key] = ("ValueError", str(e))
        mesh = meshes[key]
        if isinstance(mesh, tuple):
            out.append(mesh)
            continue
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
        progress()
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
        progress()
    return results
