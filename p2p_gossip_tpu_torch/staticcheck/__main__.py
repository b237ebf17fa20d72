"""The static-analysis gate of the port — one command, every analyzer.

    python -m p2p_gossip_tpu_torch.staticcheck                 # the card
    python -m p2p_gossip_tpu_torch.staticcheck --device cpu    # the CPU
    python -m p2p_gossip_tpu_torch.staticcheck --json          # one JSON line
    python -m p2p_gossip_tpu_torch.staticcheck --fixture NAME  # one seeded bug

The port's counterpart of ``scripts/staticcheck.py``. Runs, in order: the
AST lint (`astlint`), the op audit of every single-device entry
(`op_audit`), the telemetry-off check (`telemetry_off`), the staging
sentinel's sweep and serve replays (`restage`), and the sharded entries'
audit and telemetry check on a world: the ranks of a ``torchrun`` world
when there is one, else on the CPU a spawned world of 2 gloo ranks (run
beside the rest) whose reports must agree, and on the card one NCCL rank
in this process. ``--device cuda`` (the default, as for every port entry
point) also runs each entry under ``torch.cuda.set_sync_debug_mode("warn")``
and the build half of the staging sentinel: the counterpart of JAX's
``--compile`` stage. Every kernel of `ops.kernels` must be run by some
entry.

Exit 1 iff any analyzer reports a violation (also ``--fixture``'s
contract: each seeded bug must keep exiting 1). Violations go to stdout,
diagnostics to stderr. No suppression syntax: a false positive is fixed in
the spec or the rule, with the reason in a comment.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import sys
import time


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _sharded(device, sync_debug: bool) -> dict:
    """The sharded entries' report on this process's world (a torchrun
    world, or one NCCL rank on the card)."""
    import torch.distributed as dist

    from p2p_gossip_tpu_torch.parallel.mesh import initialize_multihost
    from p2p_gossip_tpu_torch.staticcheck import op_audit

    if dist.is_initialized():
        return op_audit.sharded_audit(str(device), sync_debug)
    initialize_multihost(device=device)
    try:
        return op_audit.sharded_audit(str(device), sync_debug)
    finally:
        dist.destroy_process_group()


def run_gate(device, sharded_report=None) -> dict:
    """Every analyzer on ``device``; ``sharded_report`` (a callable
    returning the sharded entries' report) runs beside the rest when given,
    else in this process's world. Returns the JSON report."""
    import torch

    from p2p_gossip_tpu_torch.staticcheck import astlint, op_audit, restage, telemetry_off

    on_card = device.type == "cuda"
    report: dict = {"device": str(device)}
    pool = concurrent.futures.ThreadPoolExecutor(1)
    future = pool.submit(sharded_report) if sharded_report is not None else None
    t0 = time.perf_counter()
    lint = astlint.run_lint()
    report["lint"] = lint
    log(f"lint: {lint['files_scanned']} files, {len(lint['violations'])} violation(s)")
    audit = op_audit.run_audit(device=str(device), sync_debug=on_card)
    report["audit"] = audit
    log(f"op audit: {audit['entries_audited']} entries, {len(audit['violations'])} "
        "violation(s)")
    tel = telemetry_off.run_telemetry_check(device=str(device))
    report["telemetry"] = tel
    log(f"telemetry off: {tel['pairs_checked']} pairs, {len(tel['violations'])} violation(s)")
    for key, fn, rule in (("staging", restage.run_sentinel, "staging-sentinel"),
                          ("serve_staging", restage.run_serve_sentinel,
                           "serve-staging-sentinel")):
        rep = fn(device=str(device))
        report[key] = dict(rep.as_dict(), violations=rep.violations(rule))
        log(f"{key}: expected {rep.expected}, measured {rep.measured}")
    if on_card:
        report["build"] = restage.build_sentinel()
        log(f"build: second build {report['build']['second_build_s']} s")
    sharded = future.result() if future is not None else _sharded(device, on_card)
    pool.shutdown()
    report["sharded"] = sharded
    log(f"sharded: {sharded['entries_audited']} entries on {sharded['world']} rank(s), "
        f"{len(sharded['violations'])} + {len(sharded['telemetry']['violations'])} "
        "violation(s)")
    report["coverage"] = {"violations": op_audit.kernel_coverage(
        audit["entries"] + sharded["entries"])}
    violations = [v for sec in ("lint", "audit", "telemetry", "staging", "serve_staging",
                                "build", "coverage")
                  for v in report.get(sec, {}).get("violations", [])]
    violations += sharded["violations"] + sharded["telemetry"]["violations"]
    report["violations_total"] = len(violations)
    report["ok"] = not violations
    report["wall_s"] = round(time.perf_counter() - t0, 2)
    if on_card:
        torch.cuda.synchronize()
    return report


def _human(report: dict) -> str:
    lines = [f"staticcheck on {report['device']}: {'OK' if report['ok'] else 'FAIL'} "
             f"({report['violations_total']} violation(s), {report['wall_s']} s)"]
    sections = [report.get(k, {}) for k in ("lint", "audit", "telemetry", "staging",
                                            "serve_staging", "build", "coverage")]
    sections += [report["sharded"], report["sharded"]["telemetry"]]
    for sec in sections:
        for v in sec.get("violations", []):
            where = (f"{v['file']}:{v['line']}: " if "file" in v
                     else f"{v['entry']}: " if "entry" in v else "")
            lines.append(f"  {where}[{v['rule']}] {v['message']}")
    return "\n".join(lines)


def main(argv=None) -> int:
    from p2p_gossip_tpu_torch.staticcheck.fixtures import FIXTURES

    ap = argparse.ArgumentParser(prog="python -m p2p_gossip_tpu_torch.staticcheck",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--json", action="store_true", help="one JSON line on stdout")
    ap.add_argument("--fixture", choices=FIXTURES,
                    help="run one seeded regression; exits 1 iff its analyzer flags it")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu: where the specs' tensors live")
    args = ap.parse_args(argv)

    import torch.distributed as dist

    from p2p_gossip_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    if args.fixture:
        from p2p_gossip_tpu_torch.staticcheck.fixtures import run_fixture

        report = run_fixture(args.fixture, str(device))
        if args.json:
            print(json.dumps(report))
        else:
            print(f"fixture {args.fixture}: " + ("FLAGGED (expected)" if not report["ok"]
                                                 else "NOT flagged: the analyzer is blind"))
            for v in report["violations"]:
                print(f"  [{v['rule']}] {v['message']}")
        return 0 if report["ok"] else 1

    spawned = None
    if not dist.is_initialized() and "WORLD_SIZE" not in os.environ and device.type == "cpu":
        from p2p_gossip_tpu_torch.staticcheck import op_audit

        def spawned():
            return op_audit.spawned_sharded_audit(2, "cpu")

    report = run_gate(device, spawned)
    if report["sharded"]["rank"] == 0:  # a torchrun world's first rank prints
        print(json.dumps(report) if args.json else _human(report), flush=True)
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
