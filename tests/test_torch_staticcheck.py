"""The port's static-analysis gate (``p2p_gossip_tpu_torch.staticcheck``):
the shipped tree is clean under each analyzer on the CPU, every seeded
fixture is flagged (by the same rule family as the JAX package's), every
JAX audit name has a port entry or a written reason, each single-device
entry's output widths equal its JAX counterpart's, the sharded entries
audit alike on two gloo ranks, and the CLI's exit codes."""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from p2p_gossip_tpu.staticcheck import entrypoints as jax_entrypoints
from p2p_gossip_tpu.staticcheck import fixtures as jax_fixtures
from p2p_gossip_tpu.staticcheck import registry as jax_registry
from p2p_gossip_tpu_torch import bench
from p2p_gossip_tpu_torch.parallel import launch
from p2p_gossip_tpu_torch.staticcheck import (
    astlint,
    entrypoints,
    fixtures,
    op_audit,
    registry,
    restage,
    telemetry_off,
)
from p2p_gossip_tpu_torch.staticcheck.registry import AuditEntry, AuditSpec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, OMP_NUM_THREADS="1")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread in this process: several test workers on a shared
    host oversubscribe the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def audit():
    return op_audit.run_audit(device="cpu")


# --- the shipped tree, one test per analyzer ---------------------------------

def test_op_audit_shipped_tree_clean(audit):
    assert audit["entries_audited"] >= 25
    assert audit["ok"], json.dumps(audit["violations"], indent=2)
    # or_fold is launched by the sharded protocols alone.
    missing = op_audit.kernel_coverage(audit["entries"])
    assert [v["message"].split()[1] for v in missing] == ["or_fold"]
    by_name = {r["entry"]: r for r in audit["entries"]}
    # The flood loops read their in-flight flag once a tick, the protocols' round none.
    assert by_name["engine.sync._run_chunk_while"]["host_reads_per_tick"] == 1.0
    assert by_name["models.protocols._run_chunk[pushpull]"]["host_reads_per_tick"] == 0.0


def test_ast_lint_shipped_tree_clean():
    report = astlint.run_lint()
    assert report["files_scanned"] > 60
    assert report["ok"], json.dumps(report["violations"], indent=2)
    assert report["tick_sites"]["engine.sync._run_chunk_while"] == 1


def test_telemetry_off_shipped_tree_clean():
    report = telemetry_off.run_telemetry_check()
    assert report["pairs_checked"] == 8
    assert report["ok"], json.dumps(report["violations"], indent=2)


@pytest.mark.parametrize("replay", ["sweep", "serve"])
def test_staging_sentinel_shipped_tree_clean(replay):
    report = restage.run_sentinel() if replay == "sweep" else restage.run_serve_sentinel()
    assert report.ok, report.violations()
    assert sum(report.measured.values()) > 0


# --- fixtures ------------------------------------------------------------------

@pytest.mark.parametrize("name", fixtures.FIXTURES)
def test_every_fixture_is_flagged(name):
    report = fixtures.run_fixture(name)
    assert report["fixture"] == name
    assert not report["ok"] and report["violations"], f"{name} is not flagged"


#: The JAX fixtures' rule names, as the port's rule families.
JAX_FAMILY = {"prng-key-reuse": "L1", "telemetry-off-clean": "T1", "digest-off-clean": "T4",
              "integer-only": "J2", "meshfact-sentinel": "meshfact"}


def _family(rule: str) -> str:
    return rule.split("-")[0]


# f64 and recompile are left out: jax 0.9.0 has no enable_x64 (the JAX f64
# fixture fails on this install), and the JAX recompile fixture compiles a
# campaign for minutes.
@pytest.mark.parametrize("name", ["prng", "telemetry", "digest", "exchange", "hub", "async",
                                  "meshfact"])
def test_fixture_flagged_by_the_same_family_as_jax(name):
    jax_report = jax_fixtures.run_fixture(name)
    port = fixtures.run_fixture(name)
    want = {JAX_FAMILY[v["rule"]] for v in jax_report["violations"] if v["rule"] in JAX_FAMILY}
    assert not jax_report["ok"] and want
    assert want <= {_family(v["rule"]) for v in port["violations"]}


# --- the registry against the JAX package's ----------------------------------

def _jax_entries():
    jax_entrypoints.load_all()
    return {e.name: e for e in jax_registry.all_entries()}


def test_every_jax_entry_has_a_port_entry_or_a_reason():
    names = set(_jax_entries())
    assert len(names) == 46
    served = entrypoints.counterpart_map()
    assert set(served) <= names, set(served) - names
    assert not set(entrypoints.UNPORTED) & set(served)
    assert names == set(served) | set(entrypoints.UNPORTED)
    # Each telemetry pair kept: a JAX pair maps to a port pair.
    for name in names:
        if name.endswith("[telemetry]") and name in served:
            for port_name in served[name]:
                assert port_name[: -len("[telemetry]")] in {
                    e.name for e in registry.all_entries()}


def _bits(dtype) -> int:
    return np.dtype(str(dtype).replace("torch.", "")).itemsize * 8


def test_single_device_output_widths_equal_the_jax_counterparts(audit):
    """Each port entry's array outputs, mapped by ``counterpart_outputs``,
    have the widths of its JAX counterpart's output avals (a uint32 bitmask
    is an int32 one here; the protocols' int64 ``sent`` is JAX's two uint32
    halves): counter widths match and never widen."""
    jax_by_name = _jax_entries()
    reports = {r["entry"]: r for r in audit["entries"]}
    checked = 0
    for entry in registry.all_entries():
        if entry.sharded:
            continue
        with registry.auditing("cpu"):
            spec = entry.spec()
        jax_entry = jax_by_name[entry.counterpart]
        jspec = jax_entry.spec()
        fn = jspec.fn if jspec.fn is not None else jax_entry.fn
        leaves = jax.tree_util.tree_leaves(
            jax.eval_shape(lambda *a, f=fn, kw=jspec.kwargs: f(*a, **kw), *jspec.args))
        got = reports[entry.name]["outputs"]
        assert len(got) == len(spec.counterpart_outputs), entry.name
        for dtype, want in zip(got, spec.counterpart_outputs):
            if want is None:
                continue
            idx = want if isinstance(want, tuple) else (want,)
            assert _bits(dtype) == sum(_bits(leaves[i].dtype) for i in idx), (
                entry.name, dtype, [leaves[i].dtype for i in idx])
            assert all(np.issubdtype(np.dtype(str(leaves[i].dtype)), np.integer) for i in idx)
            checked += 1
    assert checked >= 50


# --- the sharded entries on a world ---------------------------------------------

def test_sharded_entries_audit_alike_on_two_gloo_ranks():
    ranks = launch.spawn(op_audit.sharded_audit, 2, "cpu")
    assert [r["world"] for r in ranks] == [2, 2]
    first, second = ranks
    assert first["entries_audited"] == 18
    assert first["ok"] and first["telemetry"]["ok"], first["violations"]
    assert first["telemetry"]["pairs_checked"] == 3
    assert op_audit.comparable(first) == op_audit.comparable(second)
    kernels = {k for r in first["entries"] for k in r["kernels"]}
    assert "or_fold" in kernels and "compress_deltas" in kernels


# --- the rules themselves --------------------------------------------------------

def _flags(fn, spec, name="test.entry", reads=0):
    entry = AuditEntry(name=name, fn=fn, spec=lambda: spec, host_reads_per_tick=reads)
    return {v.rule for v in op_audit.check(entry, spec, op_audit.trace(entry, spec))}


def test_audit_rules_flag_their_faults():
    x = torch.arange(8, dtype=torch.int32).reshape(4, 2)
    ok = AuditSpec(args=(x,), integer_only=True, out_dtypes=("int32",), bitmask_words=2,
                   bitmask_outputs=(0,))
    assert _flags(lambda t: t | 1, ok) == set()
    assert "S-static-shapes" in _flags(lambda t: t[t > 2].reshape(-1, 1), ok)
    assert "H-host-reads" in _flags(lambda t: t + int(t.sum()), ok)
    assert "H2D-host-constants" in _flags(lambda t: t + torch.tensor([[1, 2]]), ok)
    assert "J6-bitmask-words" in _flags(lambda t: torch.cat([t, t], dim=1), ok)
    assert "W1-widths" in _flags(lambda t: t.to(torch.int64), ok)
    assert "J2-integer-only" in _flags(lambda t: (t * 0.5).to(torch.int32), ok)
    declared = AuditSpec(args=(x,), out_dtypes=("int64",),
                         allowed_ops={"aten.nonzero.default": "a test"})
    assert _flags(lambda t: torch.nonzero(t), declared) == set()


def test_lint_rules_flag_their_faults():
    src = ("import jax\nfrom p2p_gossip_tpu.ops import bitmask\nimport torch\n"
           "x = torch.randint(0, 4, (3,))\ny = torch.randint(0, 4, (3,), generator=g)\n"
           "seed = 7919\n")
    rules = [v.rule for v in astlint.lint_source(src, "snippet.py")]
    assert rules.count("L0-copy-rule") == 2
    assert rules.count("L1-random-generator") == 1
    assert rules.count("L2-seed-offset-literal") == 1


def test_tick_host_read_rule(tmp_path):
    pkg = tmp_path / "m.py"
    pkg.write_text(
        "def run(t, host):\n"
        "    x = step(t)\n"
        "    while t < 3:\n"
        "        _, nz = step(t)\n"
        "        flag = host[0] > 0\n"
        "        if flag or nz is None or 'k' in host:\n"
        "            int(flag)\n"
        "        ok = bool(nz)\n"
        "        if x.any():\n"
        "            v = x.tolist()\n"
        "        t += 1\n")
    sites = astlint.tick_body_sites(str(tmp_path), "m.py:run[loop]", {})
    assert [what for _, what in sites] == ["bool(<tensor>)", "a branch on a tensor",
                                           ".tolist()"]
    entry = AuditEntry("test.loop", None, None, host_reads_per_tick=1,
                       tick_bodies=("m.py:run[loop]",))
    violations, per_entry = astlint.lint_tick_bodies(str(tmp_path), [entry])
    assert per_entry["test.loop"] == 3 and violations[0].rule == "L3-tick-host-read"


# --- the bench's staticcheck_ok ---------------------------------------------------

class _Proc:
    def __init__(self, rc, out):
        self.returncode, self.stdout, self.stderr = rc, out, "err"


@pytest.mark.parametrize("rc,out,want", [
    (0, '{"ok": true, "violations_total": 0}\n', True),
    (1, '{"ok": false, "violations_total": 2}\n', False),
    (1, "", RuntimeError),  # a crash: no report
    (139, "", RuntimeError),
    (0, '{"ok": false, "violations_total": 1}\n', RuntimeError),  # exit code disagrees
])
def test_bench_staticcheck_ok(monkeypatch, rc, out, want):
    monkeypatch.setattr(bench.subprocess, "run", lambda *a, **k: _Proc(rc, out))
    if want is RuntimeError:
        with pytest.raises(RuntimeError, match="crashed"):
            bench.staticcheck_ok()
    else:
        assert bench.staticcheck_ok() is want


def test_bench_staticcheck_timeout_raises(monkeypatch):
    def timeout(*a, **k):
        raise subprocess.TimeoutExpired("gate", 1)

    monkeypatch.setattr(bench.subprocess, "run", timeout)
    with pytest.raises(subprocess.TimeoutExpired):
        bench.staticcheck_ok()


# --- the CLI ---------------------------------------------------------------------

def _cli(*argv):
    return subprocess.run([sys.executable, "-m", "p2p_gossip_tpu_torch.staticcheck", *argv],
                          cwd=REPO, env=ENV, capture_output=True, text=True, timeout=300)


def test_cli_json_exits_zero_with_one_line():
    proc = _cli("--json", "--device", "cpu")
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    report = json.loads(lines[0])
    assert report["ok"] and report["violations_total"] == 0
    assert report["sharded"]["world"] == 2
    assert "op audit" in proc.stderr


def test_cli_fixture_exits_one():
    proc = _cli("--fixture", "prng", "--device", "cpu")
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert "FLAGGED" in proc.stdout
