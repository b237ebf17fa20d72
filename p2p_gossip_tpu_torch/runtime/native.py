"""The port's ctypes binding of the C++ runtime (``native/gossip_native.cc``):
the discrete-event engine (the flood and the random-partner protocols) and
the Erdős–Rényi and Barabási–Albert graph builders that make million-node
graphs in minutes where the numpy builders take hours.

The library is built from the repository's source at first use, with
``make -C native OUT=<path>``, into ``p2p_gossip_tpu_torch/build/`` under a
name keyed by a hash of the source (as `ops.build` keys the CUDA library),
so an edited source is rebuilt and a stale library is never loaded. Nothing
is written into ``native/``, and the JAX package's build product there is
never loaded.

Unlike the JAX package's binding, this one never substitutes another
engine: a library that does not build or load raises RuntimeError with the
build's output. `available` is the one question a caller may ask first
(the CLI's ``--graphBuilder auto``).

Counters, snapshots and built graphs equal the JAX binding's for the same
arguments: the same library source, the same argument marshalling and the
same capacity retry.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import time

import numpy as np

from p2p_gossip_tpu_torch.models.generation import Schedule
from p2p_gossip_tpu_torch.models.topology import Graph
from p2p_gossip_tpu_torch.utils.stats import NodeStats

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_DIR = os.path.join(os.path.dirname(_PKG_DIR), "native")
SOURCE = os.path.join(NATIVE_DIR, "gossip_native.cc")
BUILD_DIR = os.path.join(_PKG_DIR, "build")

#: Must equal ``gossip_abi_version()`` in the source: a library with another
#: argument layout would write through the wrong buffers.
ABI_VERSION = 7


def library_path(build_dir: str | None = None) -> str:
    """The hashed library name of the current source (and Makefile)."""
    digest = hashlib.sha256()
    for name in (SOURCE, os.path.join(NATIVE_DIR, "Makefile")):
        with open(name, "rb") as f:
            digest.update(f.read())
    return os.path.join(
        build_dir or BUILD_DIR, f"libgossip_native_{digest.hexdigest()[:16]}.so"
    )


def build(build_dir: str | None = None) -> tuple[str, float]:
    """Compile the library if its hashed name is missing. Returns the path
    and the seconds spent compiling (0.0 when it was built already).
    Raises RuntimeError with make's output when the build fails."""
    path = library_path(build_dir)
    if os.path.exists(path):
        return path, 0.0
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            ["make", "-C", NATIVE_DIR, f"OUT={tmp}"],
            capture_output=True, text=True, timeout=600,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"building the native library failed: {e}") from e
    try:
        if proc.returncode != 0 or not os.path.exists(tmp):
            raise RuntimeError(
                f"building the native library failed ({proc.returncode}):\n"
                f"{proc.stdout}\n{proc.stderr}"
            )
        os.replace(tmp, path)  # atomic: a concurrent loader never sees half a file
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path, time.perf_counter() - t0


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed, load once per process, check the ABI version and
    declare every entry point's argument types."""
    path, _ = build()
    lib = ctypes.CDLL(path)
    version = int(lib.gossip_abi_version())
    if version != ABI_VERSION:
        raise RuntimeError(
            f"{path} has ABI version {version}, expected {ABI_VERSION}"
        )
    _configure(lib)
    return lib


def available() -> bool:
    """Whether the library builds and loads here (a compiler and make are
    present). The CLI's ``--graphBuilder auto`` asks this; every other
    caller calls an entry point, which raises."""
    try:
        load_library()
    except (RuntimeError, OSError):
        return False
    return True


def _configure(lib) -> None:
    i32p = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")
    lib.gossip_abi_version.restype = ctypes.c_longlong
    lib.gossip_run_event_sim.restype = ctypes.c_longlong
    lib.gossip_run_event_sim.argtypes = [
        ctypes.c_int64,              # n
        i64p,                        # indptr (n+1)
        i32p,                        # indices (nnz)
        i32p,                        # csr_delays (nnz)
        ctypes.c_int64,              # num_shares
        i32p,                        # origins
        i32p,                        # gen_ticks
        ctypes.c_int64,              # horizon
        ctypes.c_int64,              # connect_tick (0 = connected at t0)
        ctypes.c_int64,              # churn_k
        i32p, i32p,                  # churn_start, churn_end (n x churn_k)
        ctypes.c_int64,              # loss_threshold (0 = off)
        ctypes.c_int64,              # loss_seed
        ctypes.c_int64,              # fifo_ser_micro (0 = off)
        ctypes.c_int64,              # num_snapshots
        i64p, i64p, i64p,            # snapshot_ticks, snap_generated, snap_processed
        i64p, i64p, i64p,            # out: generated, received, sent
    ]
    lib.gossip_run_partnered_sim.restype = ctypes.c_longlong
    lib.gossip_run_partnered_sim.argtypes = [
        ctypes.c_int64,              # n
        i64p,                        # indptr (n+1)
        i32p,                        # indices (nnz)
        i32p,                        # csr_delays (nnz)
        ctypes.c_int64,              # num_shares
        i32p,                        # origins
        i32p,                        # gen_ticks
        ctypes.c_int64,              # horizon
        ctypes.c_int64,              # protocol (0=pushpull, 1=pushk, 2=pull)
        ctypes.c_int64,              # fanout
        ctypes.c_int64,              # pick_seed
        ctypes.c_int64,              # churn_k
        i32p, i32p,                  # churn_start, churn_end (n x churn_k)
        ctypes.c_int64,              # loss_threshold (0 = off)
        ctypes.c_int64,              # loss_seed
        i64p, i64p,                  # out: received, sent
    ]
    lib.gossip_build_er.restype = ctypes.c_longlong
    lib.gossip_build_er.argtypes = [
        ctypes.c_int64, ctypes.c_double, ctypes.c_uint64,
        i64p,                        # out indptr (n+1)
        i32p,                        # out indices (cap)
        ctypes.c_int64,              # cap
    ]
    lib.gossip_build_ba.restype = ctypes.c_longlong
    lib.gossip_build_ba.argtypes = [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_uint64,
        i64p, i32p, ctypes.c_int64,
    ]


def _csr_delays(graph: Graph, ell_delays, constant_delay: int) -> np.ndarray:
    """Per-edge delays in CSR order (the C++ engines' layout) from the
    ELL-aligned array the tick engine takes, or a constant fill."""
    if ell_delays is not None:
        rows, pos = graph.csr_rows_pos()
        return np.ascontiguousarray(ell_delays[rows, pos], dtype=np.int32)
    return np.full(graph.indices.shape[0], constant_delay, dtype=np.int32)


def _marshal_churn(churn, n: int):
    """(churn_k, start, end) as C-contiguous int32 (k = 0 with 1-element
    placeholders when churn is off)."""
    if churn is None:
        z = np.zeros(1, dtype=np.int32)
        return 0, z, z
    if churn.n != n:
        raise ValueError(f"churn model is for {churn.n} nodes, graph has {n}")
    return (
        churn.k,
        np.ascontiguousarray(churn.down_start, dtype=np.int32),
        np.ascontiguousarray(churn.down_end, dtype=np.int32),
    )


def run_native_sim(
    graph: Graph,
    schedule: Schedule,
    horizon_ticks: int,
    ell_delays: np.ndarray | None = None,
    constant_delay: int = 1,
    snapshot_ticks: list[int] | None = None,
    churn=None,
    loss=None,
    connect_tick: int = 0,
    fifo_links=None,
) -> NodeStats:
    """The flood on the C++ event engine: counters identical to
    `engine.event.run_event_sim`, also under churn, link loss, the connect
    window and FIFO link queueing (``fifo_links``, a
    `models.latency.FifoLinkModel`)."""
    from p2p_gossip_tpu_torch.engine.sync import filter_snapshot_boundaries

    lib = load_library()
    n = graph.n
    csr_delays = _csr_delays(graph, ell_delays, constant_delay)
    generated = np.zeros(n, dtype=np.int64)
    received = np.zeros(n, dtype=np.int64)
    sent = np.zeros(n, dtype=np.int64)
    # Boundaries past the horizon never fire on the event engine; the C++
    # loop would leave their slots zero: drop them, as the JAX binding does.
    boundaries = np.asarray(
        filter_snapshot_boundaries(snapshot_ticks, horizon_ticks), dtype=np.int64
    )
    snap_gen = np.zeros(max(len(boundaries), 1), dtype=np.int64)
    snap_proc = np.zeros(max(len(boundaries), 1), dtype=np.int64)
    churn_k, churn_start, churn_end = _marshal_churn(churn, n)
    events = lib.gossip_run_event_sim(
        n,
        np.ascontiguousarray(graph.indptr, dtype=np.int64),
        np.ascontiguousarray(graph.indices, dtype=np.int32),
        csr_delays,
        schedule.num_shares,
        np.ascontiguousarray(schedule.origins, dtype=np.int32),
        np.ascontiguousarray(schedule.gen_ticks, dtype=np.int32),
        horizon_ticks,
        connect_tick,
        churn_k,
        churn_start,
        churn_end,
        loss.threshold if loss is not None else 0,
        loss.seed if loss is not None else 0,
        fifo_links.ser_micro if fifo_links is not None else 0,
        len(boundaries),
        np.ascontiguousarray(boundaries) if len(boundaries) else snap_gen,
        snap_gen,
        snap_proc,
        generated,
        received,
        sent,
    )
    stats = NodeStats(
        generated=generated,
        received=received,
        forwarded=received.copy(),
        sent=sent,
        processed=generated + received,
        degree=graph.degree.astype(np.int64),
    )
    stats.extra["events_processed"] = int(events)
    if snapshot_ticks is not None:
        connections = int(graph.degree.sum())
        stats.extra["snapshots"] = [
            {
                "tick": int(boundaries[i]),
                "generated": int(snap_gen[i]),
                "processed": int(snap_proc[i]),
                "connections": connections,
            }
            for i in range(len(boundaries))
        ]
    return stats


def run_native_partnered_sim(
    graph: Graph,
    schedule: Schedule,
    horizon_ticks: int,
    protocol: str = "pushpull",
    fanout: int = 2,
    ell_delays: np.ndarray | None = None,
    constant_delay: int = 1,
    seed: int = 0,
    churn=None,
    loss=None,
) -> NodeStats:
    """Push-pull, pull or fanout push on the C++ engine: counters identical
    to `models.protocols.run_pushpull_sim` / `run_pushk_sim` for the same
    seed (the partner picks and loss coins are the shared counter-hash
    specs), also under churn and link loss."""
    if protocol not in ("pushpull", "pull", "pushk"):
        raise ValueError(f"unknown protocol {protocol!r}")
    from p2p_gossip_tpu_torch.models.churn import effective_generated

    lib = load_library()
    n = graph.n
    csr_delays = _csr_delays(graph, ell_delays, constant_delay)
    received = np.zeros(n, dtype=np.int64)
    sent = np.zeros(n, dtype=np.int64)
    churn_k, churn_start, churn_end = _marshal_churn(churn, n)
    rc = lib.gossip_run_partnered_sim(
        n,
        np.ascontiguousarray(graph.indptr, dtype=np.int64),
        np.ascontiguousarray(graph.indices, dtype=np.int32),
        csr_delays,
        schedule.num_shares,
        np.ascontiguousarray(schedule.origins, dtype=np.int32),
        np.ascontiguousarray(schedule.gen_ticks, dtype=np.int32),
        horizon_ticks,
        {"pushpull": 0, "pushk": 1, "pull": 2}[protocol],
        fanout,
        int(seed) & 0xFFFFFFFF,
        churn_k,
        churn_start,
        churn_end,
        loss.threshold if loss is not None else 0,
        loss.seed if loss is not None else 0,
        received,
        sent,
    )
    if rc < 0:
        raise ValueError(f"native partnered sim rejected args (rc={rc})")
    generated = effective_generated(schedule, horizon_ticks, churn)
    return NodeStats(
        generated=generated,
        received=received,
        forwarded=received.copy(),
        sent=sent,
        processed=generated + received,
        degree=graph.degree.astype(np.int64),
    )


def _build_native_graph(
    fn_name: str, n: int, arg, seed: int, cap: int | None = None
) -> Graph:
    """Call a C++ builder with a capacity guess for the CSR indices; the
    builder returns the entry count, or minus the count it needs when
    ``cap`` is short, and is then called again with that capacity (the JAX
    binding's retry). At a million-node ER graph with p = 0.001 the guess
    is ~1.25e9 int32 entries (5 GB); the unused tail is released in place
    (``ndarray.resize``, a shrinking realloc) rather than copied, and
    ``indptr`` stays int64."""
    lib = load_library()
    if cap is None:
        if fn_name == "gossip_build_er":
            cap = max(1024, int(2.5 * n * max(n - 1, 1) * arg / 2) + 4 * n)
        else:
            cap = max(1024, 4 * n * int(arg) + 64)
    fn = getattr(lib, fn_name)
    for _ in range(3):
        indptr = np.zeros(n + 1, dtype=np.int64)
        indices = np.zeros(cap, dtype=np.int32)
        if fn_name == "gossip_build_er":
            nnz = fn(n, float(arg), seed, indptr, indices, cap)
        else:
            nnz = fn(n, int(arg), seed, indptr, indices, cap)
        if nnz >= 0:
            indices.resize((int(nnz),), refcheck=False)
            return Graph(n=n, indptr=indptr, indices=indices)
        del indices
        cap = -int(nnz) + 64
    raise RuntimeError("native graph builder failed to allocate")


def native_erdos_renyi(n: int, p: float, seed: int = 0) -> Graph:
    """C++ ER builder (the reference's forced-edge connectivity rule)."""
    return _build_native_graph("gossip_build_er", n, p, seed)


def native_barabasi_albert(n: int, m: int = 3, seed: int = 0) -> Graph:
    """C++ exact BA preferential-attachment builder."""
    return _build_native_graph("gossip_build_ba", n, m, seed)
