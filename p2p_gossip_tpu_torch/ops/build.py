"""Build and load the port's CUDA kernels (csrc/gossip_kernels.cu).

The source is compiled with ``nvcc`` into a shared library with a plain C
interface and loaded with ctypes — no PyTorch headers, so a build takes
seconds. The library lands in ``p2p_gossip_tpu_torch/build/`` under a name
keyed by a hash of the source and the flags, so an edited source is rebuilt
on first use and a stale library is never loaded. Nothing here runs at
import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "gossip_kernels.cu")
BUILD_DIR = os.path.join(_PKG_DIR, "build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_U32 = ctypes.c_uint32  # values up to 0xFFFFFFFF (c_int raises from 2^31)
_SIGNATURES = {
    # hist, occ, n_src, w, ring, tick, uniform_slot, idx, mask, delay,
    # n_rows, cap, rows, n_out, up, loss_on, loss_seed, loss_limit,
    # loss_seeds, replicas, id_offset, seen, out, stream
    "gossip_gather_or": (
        _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _I, _I, _P, _I,
        _P, _I, _U32, _U32, _P, _I, _I, _P, _P, _P,
    ),
    # words, n, w, ld, out, stream
    "gossip_sector_occupancy": (_P, _I, _I, _LL, _P, _P),
    # words, n, w, ld, out, stream
    "gossip_popcount_rows": (_P, _I, _I, _LL, _P, _P),
    # seen, arrivals, out, n, w, gen_cnt, degree, received, sent, newly_cnt,
    # rows, slots, active, m, frontier, stream
    "gossip_tick_update": (_P, _P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P),
    # words, n, w, ld, replicas, rep_ld, n_slots, out, stream
    "gossip_coverage_per_slot": (_P, _I, _I, _LL, _I, _LL, _I, _P, _P),
    # src, n_src, w, offsets, entries, pull_row, base, and_not, n_out, out,
    # lanes, stream
    "gossip_scatter_or": (_P, _I, _I, _P, _P, _P, _P, _I, _I, _P, _I, _P),
    # seen, n, w, ld, received, sent_lo, sent_hi, replicas, id_offset, out,
    # out_stride, stream
    "gossip_tick_digest": (_P, _I, _I, _LL, _P, _P, _P, _I, _I, _P, _LL, _P),
    # n_words -> tiles
    "gossip_compress_tiles": (_LL,),
    # changed, n_loc, w, need, k, capacity, scratch, idx, val, counts,
    # replicas, stream
    "gossip_compress_deltas": (_P, _I, _I, _P, _I, _I, _P, _P, _P, _P, _I, _P),
    # idx, val, n_srcs, capacity, src_words, canvas_words, replicas, out, stream
    "gossip_scatter_deltas": (_P, _P, _I, _I, _LL, _LL, _I, _P, _P),
    # stack, n_words, k, out, stream
    "gossip_or_fold": (_P, _LL, _I, _P, _P),
}


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libgossip_kernels_{digest.hexdigest()[:16]}.so")


def build() -> tuple[str, float]:
    """Compile the source if its hashed library is missing. Returns the
    library path and the seconds spent compiling (0.0 when it was built
    already)."""
    path = library_path()
    if os.path.exists(path):
        return path, 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, path)  # atomic: concurrent builders never see a partial .so
    return path, time.perf_counter() - t0


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed, load once per process, and declare every entry
    point's argument types (pointers and the stream as c_void_p)."""
    path, _ = build()
    lib = ctypes.CDLL(path)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib
