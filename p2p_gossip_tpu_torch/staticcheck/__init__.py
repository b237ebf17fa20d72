"""The static-analysis gate of the PyTorch port.

The port's counterpart of ``p2p_gossip_tpu/staticcheck/``, with the same
purpose and rule families, on torch's own mechanisms instead of jaxprs:

- ``registry``     — the light registry every engine entry registers
                     with (so a new engine is audited by default);
- ``entrypoints``  — imports every registering module, and maps the JAX
                     audit names the port serves with no callable of its
                     own;
- ``op_audit``     — runs each entry on a tiny case under a
                     ``TorchDispatchMode`` and checks widths (W1), integer
                     ops (J2), host reads a tick (H), host constants (H2D),
                     static shapes (S) and bitmask word widths (J6);
- ``astlint``      — seed discipline (L1', L2), host reads in tick bodies
                     (L3') and the copy rule (L0), on the source;
- ``telemetry_off``— "telemetry off costs nothing" (T1-T4) over every
                     ``<name>`` / ``<name>[telemetry]`` pair;
- ``restage``      — "a one-time cost is paid once": host stagings of a
                     sweep and a server trace, and the kernel build;
- ``fixtures``     — seeded regressions each analyzer must flag.

CLI: ``python -m p2p_gossip_tpu_torch.staticcheck [--json] [--fixture NAME]
[--device cpu|cuda]``. This module stays import-light (no torch), so the
engine modules import the registry at import time.
"""

from p2p_gossip_tpu_torch.staticcheck.registry import (  # noqa: F401
    AuditSpec,
    audited,
    register_entry,
)
