"""The process mesh of the sharded engines, over ``torch.distributed``.

One process (rank) per GPU, SPMD: every rank runs the same entry point on
its own slice. Two logical axes, as in the JAX package's mesh:

- ``nodes`` partitions graph rows (adjacency, seen bitmask, counters); the
  per-tick frontier exchange runs over its process group (NCCL on the
  card, gloo on the CPU);
- ``shares`` partitions share chunks (independent work); counters SUM
  over it once per pass.

`make_mesh(replicas=...)` builds the factorized ``(replicas, nodes)`` mesh
of the sharded campaigns (`batch.campaign_sharded`) instead: seed replicas
on the first axis (no traffic between replica shards but the mesh-wide
stop flag), graph rows on the second.

`make_mesh` lays ranks out as the JAX package lays devices out: rank r of
the mesh's rank list sits at coordinate ``(r // nodes, r % nodes)``.
`make_slot_mesh` shapes the gossip server's (replicas, nodes) mesh so its
replica axis divides the server's slots; `make_multihost_mesh` lays a
(shares, nodes) mesh over several hosts, the nodes axis within a host.
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
REPLICAS_AXIS = "replicas"

#: Seconds a collective may wait for a peer before the process group
#: raises (every spawn and every init passes it).
DEFAULT_TIMEOUT_S = 300.0


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A (shares, nodes) mesh of ranks — or with ``first_axis`` REPLICAS_AXIS
    a (replicas, nodes) one, whose first axis size ``n_share_shards`` then
    holds — and the tensors' device on this rank. ``coordinate`` is None
    on a rank outside the mesh (a mesh may cover the first ``shares *
    nodes`` ranks of a larger world)."""

    device_mesh: object  # torch.distributed.device_mesh.DeviceMesh
    device: torch.device
    ranks: tuple
    n_share_shards: int  # the first axis' size
    n_node_shards: int
    group: object  # the whole mesh's process group
    first_axis: str = SHARES_AXIS

    @property
    def shape(self) -> dict:
        return {self.first_axis: self.n_share_shards, NODES_AXIS: self.n_node_shards}

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
    def replicas_group(self):
        return self.device_mesh.get_group(REPLICAS_AXIS)

    @property
    def first_group(self):
        """The process group along the first axis, shares or replicas."""
        return self.device_mesh.get_group(self.first_axis)

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
    replicas: int | str | None = None,
    node_bytes: int | None = None,
    hbm_bytes: int | None = None,
) -> Mesh:
    """Build a (shares, nodes) mesh over ``ranks`` (default: every rank of
    the world; the first ``shares * nodes`` of them are used). Defaults
    to all ranks on the nodes axis. Collective: every rank of the world
    calls it, in the same order as every other mesh it builds. Raises
    ValueError, as the JAX package does, when the shape needs more ranks
    than there are. ``device`` is this rank's tensor device (default:
    `local_device`).

    ``replicas`` builds the factorized (replicas, nodes) mesh of the
    sharded campaigns instead (the JAX package's ``make_mesh(replicas=)``):
    an int is the replica-shard count (node shards default to the other
    ranks), ``"auto"`` takes the split `auto_axis_split` chooses for
    ``node_bytes`` (one replica's whole-graph bytes, `campaign_node_bytes`)
    against ``hbm_bytes`` a rank; an explicit ``n_node_shards`` wins."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("no process group: call initialize_multihost() first")
    ranks = list(range(dist.get_world_size()) if ranks is None else ranks)
    first_axis = SHARES_AXIS
    if replicas is not None:
        first_axis = REPLICAS_AXIS
        if replicas == "auto":
            n_share_shards, auto_nodes = auto_axis_split(len(ranks), node_bytes=node_bytes,
                                                         hbm_bytes=hbm_bytes)
            if n_node_shards is not None:  # an explicit node count wins
                n_share_shards = len(ranks) // n_node_shards
            else:
                n_node_shards = auto_nodes
        else:
            n_share_shards = int(replicas)
            if n_share_shards < 1:
                raise ValueError(f"replicas must be >= 1 or 'auto', got {replicas!r}")
            if n_node_shards is None:
                n_node_shards = len(ranks) // n_share_shards
    if n_node_shards is None:
        n_node_shards = len(ranks) // n_share_shards
    want = n_node_shards * n_share_shards
    if n_node_shards < 1 or n_share_shards < 1 or want > len(ranks):
        kind = " (replicas x nodes)" if replicas is not None else ""
        raise ValueError(
            f"mesh {n_share_shards}x{n_node_shards}{kind} needs {want} ranks, "
            f"have {len(ranks)}"
        )
    device = local_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    mesh_ranks = tuple(int(r) for r in ranks[:want])
    device_mesh = DeviceMesh(
        device.type, torch.tensor(mesh_ranks).reshape(n_share_shards, n_node_shards),
        mesh_dim_names=(first_axis, NODES_AXIS),
    )
    if want == dist.get_world_size():
        group = dist.group.WORLD
    else:
        group = dist.new_group(list(mesh_ranks))
    return Mesh(device_mesh, device, mesh_ranks, int(n_share_shards),
                int(n_node_shards), group, first_axis)


def slot_mesh_shape(n_ranks: int, slots: int, node_bytes: int | None = None,
                    hbm_bytes: int | None = None) -> tuple[int, int]:
    """The (replica_shards, node_shards) of the serving mesh over
    ``n_ranks`` ranks (the JAX package's ``make_slot_mesh`` rule): start
    from `auto_axis_split`, then shrink the replica axis to the largest
    divisor of the rank count that also divides ``slots``, the surplus
    going to the nodes axis, so every dispatch of ``slots`` replicas
    splits evenly over the replica shards and every rank is used (6 ranks
    serving 8 slots: 2 x 3)."""
    if slots < 1:
        raise ValueError(f"slots must be >= 1, got {slots}")
    replica_shards, node_shards = auto_axis_split(n_ranks, node_bytes=node_bytes,
                                                  hbm_bytes=hbm_bytes)
    while replica_shards > 1 and slots % replica_shards:
        replica_shards -= 1
        while n_ranks % replica_shards:
            replica_shards -= 1
        node_shards = n_ranks // replica_shards
    return replica_shards, node_shards


def make_slot_mesh(slots: int, device=None, ranks=None, node_bytes: int | None = None,
                   hbm_bytes: int | None = None) -> Mesh:
    """The serving scheduler's (replicas, nodes) mesh over ``ranks``
    (default: every rank of the world), shaped by `slot_mesh_shape`: its
    replica axis divides ``slots``, as `serve.server.GossipServer` requires.
    Collective (it calls `make_mesh`): every rank of the world calls it."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call initialize_multihost() first")
    ranks = list(range(dist.get_world_size()) if ranks is None else ranks)
    replica_shards, node_shards = slot_mesh_shape(len(ranks), slots, node_bytes, hbm_bytes)
    return make_mesh(n_node_shards=node_shards, ranks=ranks, device=device,
                     replicas=replica_shards)


def make_multihost_mesh(n_node_shards: int | None = None, n_share_shards: int | None = None,
                        ranks=None, device=None) -> Mesh:
    """A (shares, nodes) mesh laid out for several hosts (the JAX package's
    ``make_multihost_mesh``): the shares axis spans hosts (share shards
    exchange nothing but one counter sum a pass, so the slow network
    carries almost nothing), the nodes axis stays within a host's local
    ranks (it carries the per-tick frontier exchange over NVLink).

    Under ``torchrun`` ranks are host-major (rank = node_rank x
    ``LOCAL_WORLD_SIZE`` + local_rank), so the canonical layout, one share
    shard a host, is ``make_mesh(n_node_shards=LOCAL_WORLD_SIZE,
    n_share_shards=hosts)``: row h of the mesh is host h's ranks. A world
    of one host (no ``LOCAL_WORLD_SIZE``, or the world's size) is plain
    `make_mesh`. On several hosts a shape whose nodes axis would cross a
    host (``n_node_shards`` not dividing ``LOCAL_WORLD_SIZE``), or that
    does not cover whole hosts, raises ValueError, as does one needing
    more ranks than there are. Collective: every rank calls it."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call initialize_multihost() first")
    ranks = list(range(dist.get_world_size()) if ranks is None else ranks)
    local = int(os.environ.get("LOCAL_WORLD_SIZE", len(ranks)))
    if local < 1 or len(ranks) % local:
        raise ValueError(f"LOCAL_WORLD_SIZE {local} does not divide the {len(ranks)} ranks")
    hosts = len(ranks) // local
    if hosts == 1:
        return make_mesh(n_node_shards, n_share_shards or 1, ranks=ranks, device=device)
    if n_share_shards is None:
        n_share_shards = hosts
    if n_node_shards is None:
        n_node_shards = len(ranks) // n_share_shards
    if n_node_shards < 1 or local % n_node_shards or (n_share_shards * n_node_shards) % local:
        raise ValueError(
            f"mesh {n_share_shards}x{n_node_shards} (shares x nodes) does not lay its nodes "
            f"axis within hosts of {local} ranks over whole hosts"
        )
    return make_mesh(n_node_shards, n_share_shards, ranks=ranks, device=device)


def campaign_node_bytes(n_nodes: int, ell_slots: int, shares: int, ring_size: int = 2) -> int:
    """One sharded-campaign replica's whole-graph device bytes, the terms
    of the sharded flood runner's ``resident_bytes`` on one node shard
    with the replicated ring: the staged ELL (an int32 index and a bool
    mask a slot, ``ell_slots`` slots over the degree buckets) and degrees;
    ``seen``, the (ring, N, W) ring and its occupancy ring, the counters;
    the tick's (N, W) arrivals. ``W`` = ``shares`` / 32 words.
    Feed it to ``make_mesh(replicas="auto", node_bytes=...)`` (JAX's TPU
    pricing, ``estimate_node_bytes``, is not this card's)."""
    w = -(-max(1, shares) // 32)
    row = 4 * w
    staged = 5 * ell_slots + 4 * n_nodes
    state = (ring_size + 1) * n_nodes * row + ring_size * n_nodes * 4 + 2 * n_nodes * 4
    return staged + state + n_nodes * row


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
