"""The process mesh of the sharded engines, over ``torch.distributed``.

One process (rank) per GPU, SPMD: every rank runs the same entry point on
its own slice. Two logical axes, as in the JAX package's mesh:

- ``nodes`` partitions graph rows (adjacency, seen bitmask, counters); the
  per-tick frontier exchange runs over its process group (NCCL on the
  card, gloo on the CPU);
- ``shares`` partitions share chunks (independent work); counters SUM
  over it once per pass.

`make_mesh` lays ranks out as the JAX package lays devices out: rank r of
the mesh's rank list sits at coordinate ``(r // nodes, r % nodes)``.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from p2p_gossip_tpu_torch.utils.device import resolve_device

NODES_AXIS = "nodes"
SHARES_AXIS = "shares"

#: Seconds a collective may wait for a peer before the process group
#: raises (every spawn and every init passes it).
DEFAULT_TIMEOUT_S = 300.0


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A (shares, nodes) mesh of ranks and the tensors' device on this
    rank. ``coordinate`` is None on a rank outside the mesh (a mesh may
    cover the first ``shares * nodes`` ranks of a larger world)."""

    device_mesh: object  # torch.distributed.device_mesh.DeviceMesh
    device: torch.device
    ranks: tuple
    n_share_shards: int
    n_node_shards: int
    group: object  # the whole mesh's process group

    @property
    def shape(self) -> dict:
        return {SHARES_AXIS: self.n_share_shards, NODES_AXIS: self.n_node_shards}

    @property
    def coordinate(self) -> tuple[int, int] | None:
        rank = dist.get_rank()
        if rank not in self.ranks:
            return None
        i = self.ranks.index(rank)
        return i // self.n_node_shards, i % self.n_node_shards

    @property
    def nodes_group(self):
        return self.device_mesh.get_group(NODES_AXIS)

    @property
    def shares_group(self):
        return self.device_mesh.get_group(SHARES_AXIS)

    @property
    def is_first(self) -> bool:
        """This rank is the mesh's first (coordinate (0, 0)): the one that
        writes files and telemetry events."""
        return self.coordinate == (0, 0)


def all_gather_rows(out: torch.Tensor, local: torch.Tensor, group, async_op: bool = False):
    """all_gather of ``local`` over ``group`` into ``out``, the ranks'
    tensors one after another along dim 0 (``all_gather_single`` where
    torch has it, else ``all_gather_into_tensor``)."""
    fn = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    return fn(out, local, group=group, async_op=async_op)


def default_backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def initialize_multihost(backend: str | None = None, device=None,
                         timeout_s: float = DEFAULT_TIMEOUT_S) -> tuple[int, int]:
    """Start the default process group once per process; a second call
    is a no-op. Under ``torchrun`` (``WORLD_SIZE`` in the environment) the
    group comes from ``env://``; otherwise the process is a world of one
    (a ``file://`` store in a fresh temporary directory). ``backend``
    defaults to NCCL for a CUDA ``device`` and gloo for the CPU. Returns
    ``(rank, world_size)``."""
    if not dist.is_initialized():
        device = resolve_device(device)
        backend = backend or default_backend(device)
        timeout = datetime.timedelta(seconds=timeout_s)
        if "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend, init_method="env://", timeout=timeout)
        else:
            store = os.path.join(tempfile.mkdtemp(prefix="p2p_mesh_"), "rendezvous")
            dist.init_process_group(backend, init_method=f"file://{store}", rank=0,
                                    world_size=1, timeout=timeout)
    return dist.get_rank(), dist.get_world_size()


def local_device(device=None) -> torch.device:
    """This rank's device: ``device`` when given, else the CUDA card of
    ``LOCAL_RANK`` (0 without one), as ``torchrun`` places ranks."""
    if device is not None:
        return resolve_device(device)
    return resolve_device(f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}")


def make_mesh(
    n_node_shards: int | None = None,
    n_share_shards: int = 1,
    ranks=None,
    device=None,
) -> Mesh:
    """Build a (shares, nodes) mesh over ``ranks`` (default: every rank of
    the world; the first ``shares * nodes`` of them are used). Defaults
    to all ranks on the nodes axis. Collective: every rank of the world
    calls it, in the same order as every other mesh it builds. Raises
    ValueError, as the JAX package does, when the shape needs more ranks
    than there are. ``device`` is this rank's tensor device (default:
    `local_device`)."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("no process group: call initialize_multihost() first")
    ranks = list(range(dist.get_world_size()) if ranks is None else ranks)
    if n_node_shards is None:
        n_node_shards = len(ranks) // n_share_shards
    want = n_node_shards * n_share_shards
    if n_node_shards < 1 or n_share_shards < 1 or want > len(ranks):
        raise ValueError(
            f"mesh {n_share_shards}x{n_node_shards} needs {want} ranks, "
            f"have {len(ranks)}"
        )
    device = local_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    mesh_ranks = tuple(int(r) for r in ranks[:want])
    device_mesh = DeviceMesh(
        device.type, torch.tensor(mesh_ranks).reshape(n_share_shards, n_node_shards),
        mesh_dim_names=(SHARES_AXIS, NODES_AXIS),
    )
    if want == dist.get_world_size():
        group = dist.group.WORLD
    else:
        group = dist.new_group(list(mesh_ranks))
    return Mesh(device_mesh, device, mesh_ranks, int(n_share_shards),
                int(n_node_shards), group)


def auto_axis_split(
    n_devices: int,
    node_bytes: int | None = None,
    hbm_bytes: int | None = None,
) -> tuple[int, int]:
    """The (replica_shards, node_shards) factorization of ``n_devices``:
    the smallest divisor node-shard count whose slice of ``node_bytes``
    fits ``hbm_bytes``, every other device on the replica axis (the JAX
    package's rule). ``node_bytes`` None: all devices to replicas.
    ``hbm_bytes`` None: ``P2P_HBM_BUDGET_GB`` when set, else the current
    card's total memory, else no limit (one node shard) — the JAX
    package's 16 GB default is a TPU's HBM."""
    if n_devices < 1:
        raise ValueError(f"need at least one device, got {n_devices}")
    if hbm_bytes is None:
        env = os.environ.get("P2P_HBM_BUDGET_GB")
        if env:
            hbm_bytes = int(float(env) * 1e9)
        elif torch.cuda.is_available():
            hbm_bytes = torch.cuda.get_device_properties(
                torch.cuda.current_device()).total_memory
    node_shards = 1
    if node_bytes is not None and hbm_bytes:
        for d in (d for d in range(1, n_devices + 1) if n_devices % d == 0):
            node_shards = d
            if node_bytes / d <= hbm_bytes:
                break
    return n_devices // node_shards, node_shards


def pad_to_multiple(x: np.ndarray, multiple: int, axis: int = 0, fill=0):
    """Pad an array so its ``axis`` length divides evenly across shards."""
    size = x.shape[axis]
    pad = (-size) % multiple
    if pad == 0:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return np.pad(x, widths, constant_values=fill)
