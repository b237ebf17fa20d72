"""The audit registry: the one list of engine entries the gate checks.

The port's counterpart of ``p2p_gossip_tpu/staticcheck/registry.py``.
Every engine entry (the tick loops, the protocols' round loop, the
campaign batches, the sharded runners, the ops) registers here, with the
``audited`` decorator on the function or an explicit ``register_entry``
call for an entry whose callable a spec builds (a sharded ``_Runner``'s
``run_pass``). The op audit iterates the registry, so a new engine that
registers is audited by default, and one that does not shows up as a gap
in the gate's entry list.

Import-light on purpose: no torch at module scope, and specs are built
lazily (``spec`` is a zero-argument callable evaluated only when an
analyzer runs, on the device that `audit_device` names), so registering
an entry costs one dict insert at import and the decorator returns the
function unchanged: no per-call cost.

Each entry names its JAX counterpart (``counterpart``), its declared
host reads a tick (``host_reads_per_tick``) and the functions whose body
runs once a tick or round (``tick_bodies``, for the AST lint's L3'); a
sharded entry (``sharded``) builds its spec on a mesh over every rank of
the world and is audited per rank.
"""

from __future__ import annotations

import contextlib
import dataclasses
import typing

if typing.TYPE_CHECKING:  # pragma: no cover - typing only
    from collections.abc import Callable


@dataclasses.dataclass
class AuditSpec:
    """How to run one entry on a tiny case under the op audit.

    ``args``/``kwargs`` are the operands (tiny shapes: the audit runs the
    entry for real). ``fn`` overrides the registered callable (a sharded
    runner's ``run_pass`` exists only once the spec has staged a mesh).

    Every field below defaults to "nothing allowed":

    - ``integer_only``: no floating dtype in any op output (J2);
    - ``bitmask_words``: the minor width every declared bitmask operand
      (``bitmask_args``: positions or keyword names) and output
      (``bitmask_outputs``: indices of the result's array leaves) of rank
      >= 2 must have — `ops.bitmask.num_words` of the chunk (J6). Port
      bitmasks are int32, the dtype of ELL indices and counters too, so
      they are declared, not found by dtype;
    - ``out_dtypes``: the dtype of each array leaf of the result, in
      pytree order (W1); ``counterpart_outputs`` the index of the JAX
      counterpart's output leaf each one matches (None: no counterpart
      leaf), for the widths test;
    - ``ticks``: the ticks or rounds the spec runs (or a function of the
      result that reads them: a sharded pass's ticks depend on the mesh);
      ``setup_reads`` the
      host reads a call makes once (its staging), ``h2d`` the host
      constants it stages once: H allows ``host_reads_per_tick`` (the
      entry's) x ``ticks`` + ``setup_reads`` reads, and H2D ``h2d``
      stagings, each named by file:line where the spec is built;
    - ``allowed_ops``: ops with data-dependent shapes (S) the entry may
      make, each with the reason;
    - ``off_kwargs``: the keyword arguments that turn telemetry off
      explicitly (T3 compares that call's ops with the default call's).
    """

    args: tuple
    kwargs: dict = dataclasses.field(default_factory=dict)
    fn: "Callable | None" = None
    integer_only: bool = False
    bitmask_words: int | None = None
    bitmask_args: tuple = ()
    bitmask_outputs: tuple = ()
    out_dtypes: tuple = ()
    counterpart_outputs: tuple = ()
    ticks: "int | Callable" = 1
    setup_reads: int = 0
    h2d: int = 0
    allowed_ops: dict = dataclasses.field(default_factory=dict)
    off_kwargs: dict | None = None


@dataclasses.dataclass
class AuditEntry:
    name: str
    fn: "Callable | None"
    spec: "Callable[[], AuditSpec]"
    counterpart: str | None = None
    host_reads_per_tick: int = 0
    tick_bodies: tuple = ()
    sharded: bool = False


_REGISTRY: dict[str, AuditEntry] = {}
_DEVICE: list = ["cpu"]
_MESHES: dict = {}


def register_entry(
    name: str,
    fn=None,
    *,
    spec,
    counterpart: str | None = None,
    host_reads_per_tick: int = 0,
    tick_bodies: tuple = (),
    sharded: bool = False,
) -> None:
    """Register ``fn`` (or a spec-built callable when ``fn`` is None)
    under ``name``. ``spec`` is a zero-argument callable returning an
    AuditSpec, evaluated at audit time. ``tick_bodies`` names, as
    ``"module path:qualified name"`` (``"Class.method"``; a ``"[loop]"``
    suffix means the function's outermost loop only), the code that runs
    once a tick or round. Registering a name again replaces it."""
    _REGISTRY[name] = AuditEntry(
        name=name, fn=fn, spec=spec, counterpart=counterpart,
        host_reads_per_tick=host_reads_per_tick, tick_bodies=tuple(tick_bodies),
        sharded=sharded,
    )


def audited(name: str, *, spec, **fields):
    """Decorator form of ``register_entry``; returns the function
    unchanged."""

    def deco(fn):
        register_entry(name, fn, spec=spec, **fields)
        return fn

    return deco


def all_entries() -> tuple[AuditEntry, ...]:
    """Registered entries in name order (deterministic reports)."""
    return tuple(_REGISTRY[k] for k in sorted(_REGISTRY))


def get_entry(name: str) -> AuditEntry:
    return _REGISTRY[name]


def audit_device():
    """The device the specs being built put their tensors on (``"cpu"``
    outside `auditing`)."""
    return _DEVICE[-1]


def audit_meshes() -> dict:
    """The meshes of the audit in progress, by kind; the sharded specs
    build them once (collectively) and keep them here."""
    return _MESHES


@contextlib.contextmanager
def auditing(device):
    """Build specs on ``device`` inside the block."""
    _DEVICE.append(device)
    try:
        yield
    finally:
        _DEVICE.pop()
        if len(_DEVICE) == 1:
            _MESHES.clear()
