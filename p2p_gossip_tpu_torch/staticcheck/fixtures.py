"""Seeded regression fixtures: bad inputs each analyzer must flag.

The port's counterpart of ``p2p_gossip_tpu/staticcheck/fixtures.py``, one
fixture per JAX fixture. The analyzers gate the port; a change that
blinded one would leave the gate green with the guard gone. Each fixture
reproduces one failure mode on tiny shapes; ``--fixture NAME`` runs one
and exits nonzero exactly when its analyzer flags it. A fault that needs
program code changed is forced with ``unittest.mock.patch`` inside the
fixture (no hook in program code). The AST lint does not scan this file:
it is bad on purpose.

  f64        an integer tick update that leaks a float and returns an
             int64 counter (W1 and J2)
  recompile  the server's staging cache bypassed: a second staging of one
             topology (the staging sentinel)
  prng       random draws from the global streams (L1')
  telemetry  the metric ring forced on with telemetry off (T1)
  digest     the state digest forced on with telemetry off (T4)
  exchange   a delta compaction ranking its words through float32 (J2)
  hub        hub-overlay row ids through float32 (J2)
  async      the async staleness tally through float32 (J2)
  meshfact   `parallel.mesh.auto_axis_split` wobbled +/-2% on a 2-shard
             boundary: two splits where one is expected
"""

from __future__ import annotations

import unittest.mock

import numpy as np
import torch

FIXTURES = ("f64", "recompile", "prng", "telemetry", "digest", "exchange", "meshfact",
            "async", "hub")


def _audit(name, fn, spec) -> list[dict]:
    from p2p_gossip_tpu_torch.staticcheck import op_audit
    from p2p_gossip_tpu_torch.staticcheck.registry import AuditEntry

    entry = AuditEntry(name=name, fn=fn, spec=lambda: spec)
    return [v.as_dict() for v in op_audit.check(entry, spec, op_audit.trace(entry, spec))]


def _report(name: str, violations: list[dict], **extra) -> dict:
    return {"fixture": name, "ok": not violations, "violations": violations, **extra}


def f64_fixture(device="cpu") -> dict:
    """A tick update whose counter math goes through a Python float and
    lands in an int64 counter: W1 (the output's width) and J2 (the float)
    must flag it."""
    from p2p_gossip_tpu_torch.staticcheck.registry import AuditSpec

    def bad_tick_update(seen):
        scaled = seen.to(torch.int64) * 2.0
        return scaled.sum(dim=1).to(torch.int64)

    seen = torch.zeros((4, 2), dtype=torch.int32, device=device)
    spec = AuditSpec(args=(seen,), integer_only=True, out_dtypes=("int32",))
    return _report("f64", _audit("fixtures.f64_bad_tick_update", bad_tick_update, spec))


def recompile_fixture(device="cpu") -> dict:
    """The server's per-topology staging cache bypassed: every dispatch
    stages its graph again; the serve sentinel must count more stagings
    than its trace has topologies."""
    from p2p_gossip_tpu_torch.engine.sync import DeviceGraph
    from p2p_gossip_tpu_torch.models.protocols import PartnerGraph
    from p2p_gossip_tpu_torch.serve.server import GossipServer
    from p2p_gossip_tpu_torch.staticcheck.restage import run_serve_sentinel

    def uncached(self, request):
        build = DeviceGraph.build if request.protocol == "flood" else PartnerGraph.build
        return build(self._graph(request), device=self.device)

    with unittest.mock.patch.object(GossipServer, "_device_graph", uncached):
        report = run_serve_sentinel(device=device)
    return _report("recompile", report.violations(), expected=report.expected,
                   measured=report.measured)


_PRNG_BAD_SOURCE = '''\
import numpy as np
import torch


def sample_two_replicas(n):
    np.random.seed(0)
    a = torch.rand(n)  # the global stream: replicas correlate
    b = np.random.randint(0, 8, n)
    return a, b
'''


def prng_fixture(device="cpu") -> dict:
    """Lint a snippet drawing from the global streams: L1' must flag it."""
    from p2p_gossip_tpu_torch.staticcheck.astlint import lint_source

    flagged = [v.as_dict() for v in lint_source(_PRNG_BAD_SOURCE, "fixtures/prng_bad.py")
               if v.rule.startswith("L1")]
    return _report("prng", flagged)


def _forced_tick(metric: bool):
    """`engine.sync._tick` with telemetry forced on when the caller passes
    none: the metric ring and the digest (``metric``), or the digest
    alone."""
    from p2p_gossip_tpu_torch.engine import sync
    from p2p_gossip_tpu_torch.telemetry import digest, rings as tel_rings

    orig = sync._tick

    def tick(dg, t, seen, hist, occ, received, sent, origins, slots, gen_ticks, plain,
             opts=sync.NO_OPTIONS, rings=None):
        if rings is not None:
            return orig(dg, t, seen, hist, occ, received, sent, origins, slots, gen_ticks,
                        plain, opts, rings)
        if metric:
            return orig(dg, t, seen, hist, occ, received, sent, origins, slots, gen_ticks,
                        plain, opts, tel_rings.chunk_rings(t + 1, seen.device))
        out = orig(dg, t, seen, hist, occ, received, sent, origins, slots, gen_ticks, plain,
                   opts, None)
        digest.write(digest.init(t + 1, seen.device), t, seen, received, sent, plain=plain)
        return out

    return unittest.mock.patch.object(sync, "_tick", tick)


def telemetry_fixture(device="cpu") -> dict:
    """The metric ring forced on while telemetry is off: T1 must find the
    ring in the OFF run of `engine.sync._run_chunk_while`."""
    from p2p_gossip_tpu_torch.staticcheck.telemetry_off import run_telemetry_check

    with _forced_tick(metric=True):
        report = run_telemetry_check(only=("engine.sync._run_chunk_while",), device=device)
    return _report("telemetry", [v for v in report["violations"]
                                 if v["rule"].startswith("T1")])


def digest_fixture(device="cpu") -> dict:
    """The state digest alone forced on while telemetry is off (a rank-1
    ring: no shape to find): T4 must find the digest math in the OFF
    run."""
    from p2p_gossip_tpu_torch.staticcheck.telemetry_off import run_telemetry_check

    with _forced_tick(metric=False):
        report = run_telemetry_check(only=("engine.sync._run_chunk_while",), device=device)
    return _report("digest", [v for v in report["violations"] if v["rule"].startswith("T4")])


def exchange_fixture(device="cpu") -> dict:
    """A delta compaction whose per-destination ranks go through a float32
    cumsum (exact only below 2^24 words: past it the capacity cut keeps the
    wrong words): J2 must flag it."""
    from p2p_gossip_tpu_torch.staticcheck.registry import AuditSpec

    def bad_compress_deltas(changed, need):
        cand = (changed.reshape(-1) != 0)[None, :] & need.t().repeat_interleave(
            changed.shape[1], dim=1)
        rank = torch.cumsum(cand.to(torch.float32), dim=1)
        keep = cand & (rank <= 8.0)
        return torch.where(keep, changed.reshape(1, -1), 0)

    rng = np.random.default_rng(0)
    changed = torch.as_tensor(rng.integers(0, 1 << 31, (16, 2)), dtype=torch.int32,
                              device=device)
    need = torch.as_tensor(rng.random((16, 2)) < 0.5, device=device)
    spec = AuditSpec(args=(changed, need), integer_only=True, out_dtypes=("int32",))
    return _report("exchange", _audit("fixtures.exchange_bad_compress_deltas",
                                      bad_compress_deltas, spec))


def hub_fixture(device="cpu") -> dict:
    """A hub overlay whose flat row ids (shard offset + local hub row) go
    through float32 (past 2^24 rows two hub rows round to one id): J2 must
    flag it."""
    from p2p_gossip_tpu_torch.staticcheck.registry import AuditSpec

    def bad_overlay_hub(recon, hub_local, hub_block):
        k, _ = hub_local.shape
        n_loc = recon.shape[0] // k
        offs = torch.arange(k, dtype=torch.float32, device=recon.device) * float(n_loc)
        flat = (hub_local.to(torch.float32) + offs[:, None]).to(torch.int64).reshape(-1)
        return recon.index_copy(0, flat, hub_block)

    recon = torch.zeros((16, 2), dtype=torch.int32, device=device)
    hub_local = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32, device=device)
    block = torch.ones((4, 2), dtype=torch.int32, device=device)
    spec = AuditSpec(args=(recon, hub_local, block), integer_only=True, out_dtypes=("int32",))
    return _report("hub", _audit("fixtures.hub_bad_overlay", bad_overlay_hub, spec))


def async_fixture(device="cpu") -> dict:
    """The async exchange's staleness tally (late word-folds a tick) counted
    in float32 (past 2^24 folds the column saturates low and a broken
    staleness bound reads as met): J2 must flag it."""
    from p2p_gossip_tpu_torch.staticcheck.registry import AuditSpec

    def bad_staleness_row(landed_view, amounts):
        remote = (landed_view != 0).any(dim=-1)
        folds = remote.to(torch.float32).sum(dim=-1)
        return (folds * amounts.to(torch.float32)).sum().to(torch.int64)

    view = torch.zeros((2, 16, 2), dtype=torch.int32, device=device)
    amounts = torch.zeros((2,), dtype=torch.int32, device=device)
    spec = AuditSpec(args=(view, amounts), integer_only=True, out_dtypes=("int64",))
    return _report("async", _audit("fixtures.async_bad_staleness_row", bad_staleness_row,
                                   spec))


def meshfact_fixture(device="cpu") -> dict:
    """`auto_axis_split` with the node bytes landed on the 2-shard boundary
    and wobbled +/-2% (the "rough" estimate's allowance): a stable split
    is one (replicas, nodes) shape; the sentinel must measure two."""
    from p2p_gossip_tpu_torch.parallel.mesh import auto_axis_split
    from p2p_gossip_tpu_torch.staticcheck.restage import SentinelReport

    n_devices, hbm = 8, 1_000_000
    base = 2 * hbm  # node_bytes / 2 == hbm: +2% tips (4, 2) to (2, 4)
    splits = {auto_axis_split(n_devices, int(base * drift), hbm_bytes=hbm)
              for drift in (0.98, 1.0, 1.02)}
    report = SentinelReport(len(splits) == 1, {"distinct_splits": 1},
                            {"distinct_splits": len(splits)}, 3)
    return _report("meshfact", report.violations("meshfact-sentinel"),
                   expected=report.expected, measured=report.measured)


def run_fixture(name: str, device="cpu") -> dict:
    if name not in FIXTURES:
        raise ValueError(f"unknown fixture {name!r}; valid: {FIXTURES}")
    return globals()[f"{name}_fixture"](device)
