"""The op audit: run every registered entry on a tiny case and check the
aten ops it makes.

The port's counterpart of ``p2p_gossip_tpu/staticcheck/jaxpr_audit.py``
(J1-J6). The port has no jaxpr: an entry is a Python loop over torch ops,
so the audit runs each entry's spec for real under one
``TorchDispatchMode`` (`_Recorder`) that records every aten op, its
output dtypes and shapes, its scalar arguments and, for copies, the
devices. Rules, catalogued in the README's "Static analysis on the port":

  W1 widths          every counter and bitmask output has exactly its
                     declared dtype (``out_dtypes``), and no op makes a
                     float64 or complex tensor. int64 is allowed inside
                     (``mix32``, the partner pick and ``torch.gather``'s
                     indices work in it), never in an output the JAX
                     counterpart keeps at 32 bits
  J2 integer-only    no floating dtype in any op output of an
                     ``integer_only`` entry (a stray Python float promotes
                     a counter chain)
  H  host reads      ``aten._local_scalar_dense`` (``.item()``, ``bool``/
                     ``int`` of a tensor) and ``.tolist()`` / ``.cpu()``
                     calls at most ``host_reads_per_tick`` x ``ticks`` +
                     ``setup_reads``: each is a device sync on the card
  H2D host constants ``aten.lift_fresh`` of host arrays (``torch.tensor``/
                     ``as_tensor`` of host data) and copies from the CPU to
                     the device at most the spec's ``h2d`` (a 0-d lift is a
                     Python scalar, ``t[i] = 5``: a device fill on the card)
  S  static shapes   no ``nonzero``, ``masked_select``, ``unique*``, bool-
                     mask ``index``/``index_put``, or ``repeat_interleave``
                     with tensor repeats, unless ``allowed_ops`` names the
                     op and why (each sizes its output from the data: a
                     sync on the card)
  J6 bitmask words   the declared bitmask operands and outputs of rank >= 2
                     have minor axis `ops.bitmask.num_words` of the chunk

A kernel wrapper takes its plain torch version on a CPU tensor, so the
CPU audit sees the plain twin's ops; on the card the kernel runs instead,
launched through ctypes (`ops.kernels._launch`), where dispatch cannot
see it. So W1, J2 and J6 hold over every op, and H, H2D and S only over
the ops outside a plain twin (the ones that also run on the card). The
audit names the kernels an entry runs: on the CPU the plain twins it
called, on the card the ``kernels.launches`` deltas. Collectives (``c10d``
ops) pass through.

With ``sync_debug`` (the card) each entry also runs under
``torch.cuda.set_sync_debug_mode("warn")`` and the syncs CUDA flags are
counted; the mode is restored after.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import time
import traceback
import warnings

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from p2p_gossip_tpu_torch.ops import kernels
from p2p_gossip_tpu_torch.staticcheck import registry

WIDE = {"torch.float64", "torch.complex64", "torch.complex128"}
FLOAT_PREFIX = ("torch.float", "torch.bfloat", "torch.complex", "torch.half")
DYNAMIC_OPS = ("aten.nonzero", "aten.masked_select", "aten.unique", "aten._unique")
H2D_OPS = ("aten.lift_fresh", "aten.lift_fresh_copy")
#: Every kernel's plain twin in `ops.kernels`.
PLAIN_TWINS = {f"{name}_plain": name for name in kernels.launches}
_TORCH_DIR = os.path.dirname(os.path.abspath(torch.__file__))


@dataclasses.dataclass
class Violation:
    entry: str
    rule: str
    message: str

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    def __str__(self) -> str:
        return f"{self.entry}: [{self.rule}] {self.message}"


@dataclasses.dataclass
class Op:
    name: str
    outs: tuple        # (dtype, shape) of each tensor output
    scalars: tuple     # the int arguments
    plain: bool        # made inside a kernel's plain twin
    read: bool         # a host read (not one made inside ``.tolist()``/``.cpu()``)
    dynamic: str | None  # the S key, when the op sizes its output from data
    h2d: bool          # a host constant or a copy from the CPU to a device


@dataclasses.dataclass
class Trace:
    """What one entry did: its ops, its result's array leaves, the host
    reads (outside the plain twins), the kernels it ran (plain twins
    called on the CPU, launches on the card) and, under ``sync_debug``,
    the syncs CUDA flagged."""

    ops: list
    leaves: list
    reads: int
    plain_calls: dict
    launches: dict
    syncs: list | None  # where each sync CUDA flagged was made
    wall_s: float
    result: object = None

    def sequence(self) -> list:
        return [op.name for op in self.ops]


def _dynamic_key(name, args) -> str | None:
    if name.startswith(DYNAMIC_OPS):
        return name
    if name.startswith(("aten.index.Tensor", "aten.index_put")) and len(args) > 1:
        if any(isinstance(a, torch.Tensor) and a.dtype == torch.bool
               for a in _flat(args[1], [])):  # the indices
            return name + "[bool]"
    if name.startswith("aten.repeat_interleave") and "int" not in name.rsplit(".", 1)[-1]:
        return name
    return None


def _flat(x, out: list) -> list:
    """The leaves of an op's nested arguments or results (lists, tuples,
    dicts): `torch.utils._pytree` is general, and most of the audit's time
    when it runs on every op."""
    if isinstance(x, (list, tuple)):
        for y in x:
            _flat(y, out)
    elif isinstance(x, dict):
        for y in x.values():
            _flat(y, out)
    else:
        out.append(x)
    return out


class _Recorder(TorchDispatchMode):
    """Records every aten op an entry makes (the audit's one dispatch
    mode). ``plain`` > 0 while a plain twin runs."""

    def __init__(self):
        super().__init__()
        self.ops: list[Op] = []
        self.plain = 0
        self.reading = 0
        self.lifted: set = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = str(func)
        flat = _flat(kwargs, _flat(args, []))
        outs = tuple((str(t.dtype), tuple(t.shape)) for t in _flat(out, [])
                     if isinstance(t, torch.Tensor))
        scalars = tuple(a for a in flat if isinstance(a, int) and not isinstance(a, bool))
        h2d = False
        if name.startswith(H2D_OPS) and isinstance(out, torch.Tensor) and out.dim():
            # A host array made a tensor. A 0-d lift is a Python scalar
            # (``t[i] = 5``), which the card makes by a device fill.
            h2d = True
            self.lifted.add(id(out))
        elif name.startswith(("aten._to_copy", "aten.copy_")):
            src = flat[1] if name.startswith("aten.copy_") and len(flat) > 1 else flat[0]
            dst = flat[0] if name.startswith("aten.copy_") else out
            if (isinstance(src, torch.Tensor) and isinstance(dst, torch.Tensor)
                    and src.device.type == "cpu" and dst.device.type != "cpu"):
                h2d = id(src) not in self.lifted  # as_tensor's copy is its lift
        read = (name.startswith("aten._local_scalar_dense") and not self.plain
                and not self.reading)
        self.ops.append(Op(name, outs, scalars, self.plain > 0, read,
                           None if self.plain else _dynamic_key(name, args),
                           h2d and not self.plain))
        return out


class _Watch:
    """Patches, for one entry's run: the host reads that dispatch cannot
    see on the CPU (``Tensor.tolist`` and ``Tensor.cpu``) and every plain
    twin (to mark its ops and name its kernel)."""

    def __init__(self, recorder: _Recorder):
        self.rec = recorder
        self.reads = 0
        self.plain_calls: collections.Counter = collections.Counter()
        self.saved: list = []

    def __enter__(self):
        watch = self

        def reader(orig):
            def read(t, *a, **k):
                if not watch.rec.plain and not watch.rec.reading:
                    watch.reads += 1
                watch.rec.reading += 1
                try:
                    return orig(t, *a, **k)
                finally:
                    watch.rec.reading -= 1
            return read

        def twin(name, kernel, orig):
            def plain(*a, **k):
                if not watch.rec.plain:
                    watch.plain_calls[kernel] += 1
                watch.rec.plain += 1
                try:
                    return orig(*a, **k)
                finally:
                    watch.rec.plain -= 1
            return plain

        for attr in ("tolist", "cpu"):
            self.saved.append((torch.Tensor, attr, torch.Tensor.__dict__.get(attr)))
            setattr(torch.Tensor, attr, reader(getattr(torch.Tensor, attr)))
        for name, kernel in PLAIN_TWINS.items():
            orig = getattr(kernels, name)
            self.saved.append((kernels, name, orig))
            setattr(kernels, name, twin(name, kernel, orig))
        return self

    def __exit__(self, *exc):
        for obj, attr, orig in reversed(self.saved):
            if orig is None:  # an inherited method: drop the patch
                delattr(obj, attr)
            else:
                setattr(obj, attr, orig)
        return False


def _leaves(result) -> list:
    return [x for x in tree_flatten(result)[0] if isinstance(x, (torch.Tensor, np.ndarray))]


def _call(entry, spec, kwargs=None):
    fn = spec.fn if spec.fn is not None else entry.fn
    if fn is None:
        raise ValueError("no callable registered or built")
    return fn(*spec.args, **(spec.kwargs if kwargs is None else kwargs))


def _sync_site(stack) -> str | None:
    """Where a sync CUDA flagged was made: the innermost frame outside
    torch and outside `trace` (None: the audit's own mode switch)."""
    for frame in reversed(stack):
        path = os.path.abspath(frame.filename)
        if path.startswith(_TORCH_DIR) or path == os.path.abspath(warnings.__file__):
            continue
        if path == os.path.abspath(__file__):
            if frame.name in ("read", "plain"):  # `_Watch`'s wrappers: their caller's
                continue
            if frame.name in ("trace", "_sync_site", "show"):
                return None
        return f"{os.path.relpath(frame.filename)}:{frame.lineno}"
    return None


def trace(entry, spec, kwargs=None, sync_debug: bool = False) -> Trace:
    """Run ``entry`` on ``spec`` (``kwargs`` in place of the spec's) under
    the recorder; the result's array leaves, reads and kernels with it.
    With ``sync_debug`` the syncs CUDA flags are attributed to the line
    that made them (`_sync_site`)."""
    rec = _Recorder()
    before = dict(kernels.launches)
    sites: list = []

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" in str(message):
            site = _sync_site(traceback.extract_stack()[:-1])
            if site is not None:
                sites.append(site)

    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        mode = None
        if sync_debug:
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("warn")
        try:
            with _Watch(rec) as watch, rec:
                result = _call(entry, spec, kwargs)
        finally:
            if sync_debug:
                torch.cuda.set_sync_debug_mode(mode)
    wall = time.perf_counter() - t0
    launched = {k: v - before[k] for k, v in kernels.launches.items() if v > before[k]}
    return Trace(rec.ops, _leaves(result), watch.reads, dict(watch.plain_calls), launched,
                 sites if sync_debug else None, wall, result)


def _dtype_name(x) -> str:
    return str(x.dtype).replace("torch.", "")


def ticks_of(spec, tr: Trace) -> int:
    """The ticks the spec ran: declared, or read from the result."""
    return spec.ticks(tr.result) if callable(spec.ticks) else spec.ticks


def check(entry, spec, tr: Trace) -> list[Violation]:
    """Apply W1, J2, H, H2D, S and J6 to one entry's trace."""
    out: list[Violation] = []
    ticks = ticks_of(spec, tr)

    def flag(rule, message):
        out.append(Violation(entry.name, rule, message))

    # W1 — no wide op output; every array output at its declared dtype.
    wide = {(dt, op.name) for op in tr.ops for dt, _ in op.outs if dt in WIDE}
    for dt, name in sorted(wide):
        flag("W1-widths", f"{name} makes a {dt} tensor: every op of the port is "
             "integer or bitwise, 32-bit where the JAX package is")
    got = tuple(_dtype_name(x) for x in tr.leaves)
    if got != tuple(spec.out_dtypes):
        flag("W1-widths", f"outputs have dtypes {list(got)}, declared {list(spec.out_dtypes)} "
             "(counter and bitmask widths match the JAX counterpart's and never widen)")
    # J2 — no floating dtype at all.
    if spec.integer_only:
        floats = sorted({(dt, op.name) for op in tr.ops for dt, _ in op.outs
                         if dt.startswith(FLOAT_PREFIX)})
        for dt, name in floats[:3]:
            flag("J2-integer-only", f"{name} makes a {dt} tensor in an integer/bitwise "
                 "entry: a stray Python float promoting a counter chain?")
    # H — host reads a tick.
    reads = host_reads(tr)
    budget = entry.host_reads_per_tick * ticks + spec.setup_reads
    if reads > budget:
        flag("H-host-reads", f"{reads} host reads over {ticks} ticks; declared "
             f"{entry.host_reads_per_tick} a tick + {spec.setup_reads} a call ({budget}): "
             "each is a device sync on the card")
    # H2D — host constants made tensors inside the entry.
    h2d = [op.name for op in tr.ops if op.h2d]
    if len(h2d) > spec.h2d:
        flag("H2D-host-constants", f"{len(h2d)} host-to-device stagings ({sorted(set(h2d))}), "
             f"declared {spec.h2d}: stage operands before the entry, or write constants "
             "by device fills")
    # S — data-dependent shapes.
    dyn = collections.Counter(op.dynamic for op in tr.ops if op.dynamic)
    for key, n in sorted(dyn.items()):
        if key not in spec.allowed_ops:
            flag("S-static-shapes", f"{key} x{n}: its output is sized by the data (a sync "
                 "on the card); declare it in the spec's allowed_ops with the reason")
    # J6 — bitmask word widths.
    if spec.bitmask_words is not None:
        named = []
        for a in spec.bitmask_args:
            named.append((f"operand {a}",
                          spec.args[a] if isinstance(a, int) else spec.kwargs[a]))
        for i in spec.bitmask_outputs:
            named.append((f"output {i}", tr.leaves[i] if i < len(tr.leaves) else None))
        for label, x in named:
            shape = tuple(getattr(x, "shape", ()))
            if len(shape) >= 2 and shape[-1] != spec.bitmask_words:
                flag("J6-bitmask-words", f"{label} of shape {shape} packs {shape[-1]} words; "
                     f"the entry's chunk needs {spec.bitmask_words} (ops/bitmask.py: slot s "
                     "lives at word s // 32)")
    return out


def host_reads(tr: Trace) -> int:
    """The entry's host reads: ``_local_scalar_dense`` ops and ``.tolist()``
    / ``.cpu()`` calls, outside the plain twins."""
    return tr.reads + sum(1 for op in tr.ops if op.read)


def audit_entry(entry, device="cpu", sync_debug: bool = False) -> dict:
    """Build ``entry``'s spec on ``device``, run it under the recorder and
    apply the rules. Returns the entry's report: its violations, host
    reads a tick, syncs CUDA flagged, kernels and wall."""
    report = {"entry": entry.name, "counterpart": entry.counterpart, "violations": []}
    with registry.auditing(device):
        try:
            spec = entry.spec()
        except Exception:
            report["violations"].append(Violation(
                entry.name, "spec-error",
                f"audit spec failed to build:\n{traceback.format_exc(limit=6)}").as_dict())
            return report
        try:
            tr = trace(entry, spec, sync_debug=sync_debug)
        except Exception:
            report["violations"].append(Violation(
                entry.name, "run-error",
                f"the entry failed on its spec:\n{traceback.format_exc(limit=6)}").as_dict())
            return report
    reads, ticks = host_reads(tr), ticks_of(spec, tr)
    report.update(
        violations=[v.as_dict() for v in check(entry, spec, tr)],
        ticks=ticks,
        host_reads=reads,
        host_reads_per_tick=round((reads - spec.setup_reads) / ticks, 6),
        h2d=sum(1 for op in tr.ops if op.h2d),
        outputs=[_dtype_name(x) for x in tr.leaves],
        syncs=None if tr.syncs is None else len(tr.syncs),
        **({} if not tr.syncs else {"sync_sites": sorted(set(tr.syncs))}),
        kernels=tr.launches if torch.device(device).type == "cuda" else tr.plain_calls,
        ops=sum(1 for op in tr.ops if not op.plain),
        wall_s=round(tr.wall_s, 4),
    )
    return report


def run_audit(device="cpu", sharded: bool = False, sync_debug: bool = False,
              part: tuple = (0, 1)) -> dict:
    """Audit the registered entries (``sharded`` False: the single-device
    ones; True: the sharded ones, which need an initialized process group
    and run on every rank); ``part`` (k, n) audits the k-th of n
    interleaved slices. JSON-ready: {"ok", "entries_audited", "entries":
    [per-entry reports], "violations": [...]}."""
    from p2p_gossip_tpu_torch.staticcheck import entrypoints

    entrypoints.load_all()
    entries = [e for e in registry.all_entries() if e.sharded == sharded]
    entries = entries[part[0]::part[1]]
    reports = [audit_entry(e, device, sync_debug) for e in entries]
    violations = [v for r in reports for v in r["violations"]]
    return {
        "ok": not violations,
        "entries_audited": len(reports),
        "entries": reports,
        "violations": violations,
    }


def kernel_coverage(reports) -> list[dict]:
    """Every kernel of `ops.kernels` run by some audited entry (its launches
    on the card, its plain twin on the CPU)."""
    ran = {k for r in reports for k in (r.get("kernels") or {})}
    return [Violation("(registry)", "kernel-coverage",
                      f"kernel {name} is run by no registered entry: register the entry "
                      "that launches it").as_dict()
            for name in kernels.launches if name not in ran]


def audit_mesh(kind: str):
    """The mesh a sharded spec runs on: every rank of the world on the
    nodes axis, as a (shares, nodes) mesh (``kind`` "shares") or a
    (replicas, nodes) one ("replicas"); built once per audit, on every
    rank in the same order (collective)."""
    from p2p_gossip_tpu_torch.parallel.mesh import make_mesh

    meshes = registry.audit_meshes()
    if kind not in meshes:
        dev = torch.device(registry.audit_device())
        if kind == "shares":
            meshes[kind] = make_mesh(device=dev)
        else:
            meshes[kind] = make_mesh(replicas=1, device=dev)
    return meshes[kind]


def sharded_audit(device="cpu", sync_debug: bool = False, part: tuple = (0, 1)) -> dict:
    """A rank's audit of the sharded entries and their telemetry pairs
    (every rank of the world calls it; a worker for
    `parallel.launch.spawn`), or of the ``part`` (k, n) slice of each.
    Returns the op audit's report with the telemetry check's under
    ``"telemetry"``, the world's size and the rank."""
    import torch.distributed as dist

    from p2p_gossip_tpu_torch.parallel import launch
    from p2p_gossip_tpu_torch.staticcheck import telemetry_off

    report = run_audit(device=device, sharded=True, sync_debug=sync_debug, part=part)
    launch.progress()
    report["telemetry"] = telemetry_off.run_telemetry_check(device=device, sharded=True,
                                                            part=part)
    report["world"], report["rank"] = dist.get_world_size(), dist.get_rank()
    return report


def comparable(report: dict) -> dict:
    """A report without its rank, walls and op counts (a rank that holds a
    generation makes its scatter's ops), so two ranks' reports compare."""
    return dict({k: v for k, v in report.items() if k != "rank"},
                entries=[{k: v for k, v in r.items() if k not in ("wall_s", "ops")}
                         for r in report["entries"]])


def spawned_sharded_audit(world: int = 2, device="cpu") -> dict:
    """The sharded entries audited on a fresh world of ``world`` gloo
    ranks (`parallel.launch.spawn`): rank 0's report, with a violation if
    the ranks' reports differ."""
    from p2p_gossip_tpu_torch.parallel import launch

    reports = launch.spawn(sharded_audit, world, device)
    first = reports[0]
    for rank, other in enumerate(reports[1:], start=1):
        if comparable(other) != comparable(first):
            v = Violation("(sharded world)", "rank-agreement",
                          f"rank {rank}'s audit differs from rank 0's").as_dict()
            first = dict(first, ok=False, violations=first["violations"] + [v])
    return first
