"""Package-level checks of the PyTorch port: its CLI against the JAX
package's report, its import boundary, and its kernel build keying."""

import ast
import os
import subprocess
import sys

import p2p_gossip_tpu as pg
from p2p_gossip_tpu.engine.sync import run_sync_sim as jax_sync_sim
from p2p_gossip_tpu.utils.stats import format_final_statistics
from p2p_gossip_tpu_torch.ops import build
from p2p_gossip_tpu_torch.utils import cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _node_lines(text):
    return [line for line in text.splitlines() if line.startswith("Node ")]


def test_cli_reference_config_matches_jax_report(capsys):
    """The reference's default run (--numNodes 10 --connectionProb 0.3
    --simTime 60 --Latency 5, seed 0): the port's per-node lines equal the
    JAX engine's report for the same graph and schedule."""
    assert cli.run(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    g = pg.erdos_renyi(10, 0.3, seed=0)
    sched = pg.uniform_renewal_schedule(10, 60.0, 0.005, 2.0, 5.0, seed=0)
    want = format_final_statistics(jax_sync_sim(g, sched, 12000))
    assert len(_node_lines(want)) == 10
    assert _node_lines(out) == _node_lines(want)
    for line in want.splitlines()[-5:]:  # the totals block
        assert line in out


def test_cli_rejects_bad_flags(capsys):
    assert cli.run(["--device", "cpu", "--Latency", "0"]) == 2
    assert "error" in capsys.readouterr().err


def _port_files():
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for dirpath, _dirs, files in os.walk(os.path.join(REPO, "p2p_gossip_tpu_torch")):
        paths += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return paths


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "p2p_gossip_tpu")


def test_port_imports_neither_jax_nor_the_jax_package():
    files = _port_files()
    assert len(files) > 10
    names = {os.path.relpath(f, REPO) for f in files}
    for module in ("models/protocols.py", "models/partnersel.py", "ops/segment.py",
                   "utils/anim.py", "utils/cli.py", "batch/__init__.py",
                   "batch/campaign.py", "batch/campaign_sharded.py", "batch/stats.py",
                   "batch/sweep.py",
                   "engine/event.py", "runtime/native.py", "utils/logging.py",
                   "scale.py", "serve/__init__.py", "serve/request.py",
                   "serve/scheduler.py", "serve/server.py", "serve/bench.py",
                   "parallel/__init__.py", "parallel/mesh.py", "parallel/launch.py",
                   "parallel/exchange.py", "parallel/async_ticks.py",
                   "parallel/engine_sharded.py", "parallel/protocols_sharded.py",
                   "divergence.py", "protocol_compare.py", "bench.py",
                   "staticcheck/__init__.py", "staticcheck/__main__.py",
                   "staticcheck/registry.py", "staticcheck/entrypoints.py",
                   "staticcheck/specs.py", "staticcheck/op_audit.py",
                   "staticcheck/astlint.py", "staticcheck/telemetry_off.py",
                   "staticcheck/restage.py", "staticcheck/fixtures.py"):
        assert os.path.join("p2p_gossip_tpu_torch", module) in names
    bad = []
    for path in files:
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                bad += [(path, a.name) for a in node.names if _forbidden(a.name)]
            elif isinstance(node, ast.ImportFrom) and node.module:
                if node.level == 0 and _forbidden(node.module):
                    bad.append((path, node.module))
            elif isinstance(node, ast.Call) and getattr(node.func, "id", "") == "__import__":
                arg = node.args[0] if node.args else None
                if isinstance(arg, ast.Constant) and _forbidden(str(arg.value)):
                    bad.append((path, arg.value))
    assert not bad, bad


def test_library_path_is_keyed_by_source_hash():
    path = build.library_path()
    assert os.path.dirname(path) == build.BUILD_DIR
    assert path == build.library_path()
    assert os.path.basename(path).startswith("libgossip_kernels_")
    with open(build.SOURCE, encoding="utf-8") as f:
        src = f.read()
    for entry in ("gossip_gather_or", "gossip_popcount_rows", "gossip_coverage_per_slot",
                  "gossip_scatter_or", "gossip_tick_update"):
        assert f"int {entry}(" in src
        assert entry in build._SIGNATURES


def test_chip_smoke_exits_nonzero_without_cuda(tmp_path):
    """chip_smoke.py refuses to run without a card, and alone in a
    directory (without the package beside it)."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    for cwd, script in ((REPO, "chip_smoke.py"), (tmp_path, None)):
        if script is None:
            with open(os.path.join(REPO, "chip_smoke.py"), encoding="utf-8") as f:
                (tmp_path / "chip_smoke.py").write_text(f.read())
        proc = subprocess.run(
            [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
            capture_output=True, text=True, timeout=120,
        )
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout


def test_gather_binding_declares_unsigned_loss_words():
    """The loss seed and threshold - 1 reach 0xFFFFFFFF: they are declared
    c_uint32 (c_int would raise from 2^31 on), right after the up pointer
    and the loss-on flag, and the C entry takes them as unsigned."""
    import ctypes

    sig = build._SIGNATURES["gossip_gather_or"]
    assert sig[14:18] == (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_uint32)
    assert ctypes.c_uint32(0xFFFFFFFF).value == 0xFFFFFFFF
    with open(build.SOURCE, encoding="utf-8") as f:
        src = f.read()
    assert "unsigned int loss_seed, unsigned int loss_limit" in src
