"""Telemetry off must mean off: checked on the ops each entry makes.

The port's counterpart of ``p2p_gossip_tpu/staticcheck/telemetry_off.py``
(T1-T4). The telemetry layer's claim is that a run with its rings off pays
nothing: the engines take the caller's rings (``rings=``, or a sharded
runner's ``telemetry_on``), and with none the tick makes exactly the
telemetry-free ops. Over every ``<name>`` / ``<name>[telemetry]`` pair of
the registry (a new instrumented entry that registers its pair is checked
by default):

  T1 no-ring-when-off   the OFF run makes no tensor of rank >= 2 whose
                        minor axis is ``telemetry.schema.NUM_METRICS`` in
                        the metric ring's dtype (int64): no ring is
                        allocated or written
  T2 flag-gates         the ON run's op sequence differs from the OFF
                        run's (an instrumenting flag that became a no-op
                        would kill the subsystem while every test passed)
  T3 default-is-off     for an entry called directly (no spec-built
                        runner), the call with the spec's ``off_kwargs``
                        (telemetry off, explicitly) makes the same op
                        sequence as the default call
  T4 no-digest-when-off the OFF run carries none of the digest's mix
                        constants (``telemetry.digest`` MIX_M1 / MIX_M2,
                        whole or as the 16-bit halves ``_mul32`` multiplies
                        by) among its ops' integer arguments, and on the
                        card launches no ``tick_digest``
"""

from __future__ import annotations

import traceback

from p2p_gossip_tpu_torch.staticcheck import op_audit, registry
from p2p_gossip_tpu_torch.staticcheck.op_audit import Violation
from p2p_gossip_tpu_torch.telemetry.digest import MIX_M1, MIX_M2
from p2p_gossip_tpu_torch.telemetry.schema import NUM_METRICS

TELEMETRY_SUFFIX = "[telemetry]"
RING_DTYPE = "torch.int64"
#: The digest's multipliers and the halves `ops.kernels._mul32` splits
#: them into.
DIGEST_CONSTANTS = {c: f"0x{c:08X}" for c in (MIX_M1, MIX_M2)}
DIGEST_CONSTANTS.update({h: f"0x{h:04X} (a 16-bit half of 0x{c:08X})"
                         for c in (MIX_M1, MIX_M2) for h in (c & 0xFFFF, c >> 16)})


def ring_shapes(tr) -> list:
    """Shapes of metric-ring-like op outputs: the ring's dtype, rank >= 2,
    minor axis NUM_METRICS."""
    found = []
    for op in tr.ops:
        for dt, shape in op.outs:
            if dt == RING_DTYPE and len(shape) >= 2 and shape[-1] == NUM_METRICS:
                if shape not in found:
                    found.append(shape)
    return found


def digest_leaks(tr) -> list:
    """The digest constants among the ops' integer arguments, and
    ``tick_digest`` launches."""
    found = sorted({DIGEST_CONSTANTS[c] for op in tr.ops for c in op.scalars
                    if c in DIGEST_CONSTANTS})
    if tr.launches.get("tick_digest"):
        found.append(f"{tr.launches['tick_digest']} tick_digest launches")
    return found


def telemetry_pairs():
    """(off entry, on entry) pairs by the ``[telemetry]`` suffix."""
    from p2p_gossip_tpu_torch.staticcheck import entrypoints

    entrypoints.load_all()
    by_name = {e.name: e for e in registry.all_entries()}
    return [(by_name[n[: -len(TELEMETRY_SUFFIX)]], e) for n, e in sorted(by_name.items())
            if n.endswith(TELEMETRY_SUFFIX) and n[: -len(TELEMETRY_SUFFIX)] in by_name]


def check_pair(base, on_entry, device="cpu") -> list[Violation]:
    """T1-T4 on one pair."""
    out: list[Violation] = []
    with registry.auditing(device):
        try:
            off_spec = base.spec()
            off = op_audit.trace(base, off_spec)
            on_spec = on_entry.spec()
            on = op_audit.trace(on_entry, on_spec)
            explicit = None
            if off_spec.fn is None and off_spec.off_kwargs is not None:
                explicit = op_audit.trace(base, base.spec(), kwargs=off_spec.off_kwargs)
        except Exception:
            return [Violation(on_entry.name, "trace-error",
                              f"telemetry run failed:\n{traceback.format_exc(limit=6)}")]
    rings = ring_shapes(off)
    if rings:
        out.append(Violation(base.name, "T1-telemetry-off-clean",
                             f"the OFF run makes metric-ring tensors {rings[:3]}: the rings "
                             "must not exist when telemetry is off"))
    leaks = digest_leaks(off)
    if leaks:
        out.append(Violation(base.name, "T4-digest-off-clean",
                             f"the OFF run carries digest math ({'; '.join(leaks)}): the "
                             "state digest must not run when telemetry is off"))
    if on.sequence() == off.sequence():
        out.append(Violation(on_entry.name, "T2-telemetry-flag-gates",
                             "the ON run makes exactly the OFF run's ops: the rings no "
                             "longer instrument anything"))
    if explicit is not None and explicit.sequence() != off.sequence():
        out.append(Violation(base.name, "T3-telemetry-default-off",
                             "telemetry off, passed explicitly, makes other ops than the "
                             "default call: existing call sites are not on the off path"))
    return out


def run_telemetry_check(only=None, device="cpu", sharded: bool = False,
                        part: tuple = (0, 1)):
    """Check the registry's telemetry pairs (``sharded`` and ``part`` as in
    `op_audit.run_audit`; ``only`` restricts to these base names)."""
    pairs = [(b, o) for b, o in telemetry_pairs() if b.sharded == sharded]
    pairs = pairs[part[0]::part[1]]
    if only is not None:
        pairs = [(b, o) for b, o in pairs if b.name in set(only)]
    violations = [v.as_dict() for b, o in pairs for v in check_pair(b, o, device)]
    return {"ok": not violations, "pairs_checked": len(pairs),
            "entries": [b.name for b, _ in pairs], "violations": violations}
