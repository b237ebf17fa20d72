"""The yardstick stands apart: the reference and the generators import
nothing of the program, and nothing under gossipbench/ imports JAX or
the JAX package (top-level names compared whole)."""

import ast
import os

import pytest

from gossipbench import run, spec

JAX = {"jax", "jaxlib", "flax", "p2p_gossip_tpu"}
PROGRAM = {"p2p_gossip_tpu_torch"}


def imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".", 1)[0]


def sources(*parts):
    for d, _, files in os.walk(os.path.join(spec.HERE, *parts)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


@pytest.mark.parametrize("folder", ["reference", "gen"])
def test_reference_and_generators_import_no_program(folder):
    bad = {p: sorted(set(imports(p)) & (JAX | PROGRAM)) for p in sources(folder)}
    assert not {p: b for p, b in bad.items() if b}
    assert list(sources(folder))


def test_no_jax_anywhere_in_the_benchmark():
    bad = {p: sorted(set(imports(p)) & JAX) for p in sources()}
    assert not {p: b for p, b in bad.items() if b}


def test_names_compared_whole(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "p2p_gossip_tpu_torch_x", types.ModuleType("x"))
    assert "p2p_gossip_tpu_torch_x" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "p2p_gossip_tpu.engine", types.ModuleType("y"))
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("z"))
    assert run.forbidden_modules() == ["jax.numpy", "p2p_gossip_tpu.engine"]


def test_ast_scan_catches_a_planted_import(tmp_path):
    bad = tmp_path / "x.py"
    bad.write_text("import p2p_gossip_tpu_torch.ops\nfrom jax import numpy\nimport jaxfoo\n")
    found = set(imports(str(bad)))
    assert found & (JAX | PROGRAM) == {"p2p_gossip_tpu_torch", "jax"}
