"""The port's divergence bisector (``p2p_gossip_tpu_torch.divergence``)
against the JAX package's ``scripts/divergence.py`` on the CPU, pair by
pair at the script's defaults: both streams of every pair equal the JAX
script's, digest for digest (tolerance 0: digests are uint32 folds); the
clean and ``--inject-fault 7`` reports equal the JAX script's
``run_pair`` reports; a forced divergence yields the JAX script's digest
window (and, for native-sync, its frontier window); and the CLI exits 0
clean and with a fault injected, at the sizes of ``scripts/ci_tier1.sh``.

One world of 4 spawned gloo ranks runs the port's five sharded pairs
while this process runs the JAX script's pairs (on the 8 virtual CPU
devices of tests/conftest.py) and the port's host-side pairs."""

import argparse
import importlib.util
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

from p2p_gossip_tpu_torch import divergence

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAIRS = divergence.PAIRS
CI_SIZES = ["--n", "64", "--shares", "3", "--horizon", "16"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread in this process (its spawned ranks already run
    one): several test workers on a shared host oversubscribe the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_divergence_script", os.path.join(REPO, "scripts", "divergence.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _args(**over):
    args = divergence.parse_args(["--device", "cpu"])
    for key, value in over.items():
        setattr(args, key, value)
    return args


@pytest.fixture(scope="module")
def streams():
    """Every pair's two streams from each package at the defaults: the
    port's sharded pairs from one spawned world, the rest in this
    process, one run after another (each package's sink is global)."""
    jax_div = _jax_script()
    args = _args()
    with ThreadPoolExecutor(1) as pool:
        world = pool.submit(divergence.sharded_streams, divergence.SHARDED_PAIRS, args)
        want = {name: jax_div._PAIR_FNS[name](args) for name in PAIRS}
        got = {name: divergence._PAIR_FNS[name](args)
               for name in PAIRS if name not in divergence.SHARDED_PAIRS}
        got.update(world.result())
    return got, want, jax_div


@pytest.mark.parametrize("name", PAIRS)
def test_streams_match_jax(name, streams):
    got, want, _ = streams
    a, b = got[name]
    ja, jb = want[name]
    assert len(a) > 0 and len(b) > 0
    assert a == ja
    assert b == jb


def _reports(name, streams, monkeypatch, args, pair=None):
    """The port's and the JAX script's report of ``name`` from the streams
    each package collected (or both from ``pair``'s)."""
    got, want, jax_div = streams
    monkeypatch.setitem(jax_div._PAIR_FNS, name, lambda _args: pair or want[name])
    monkeypatch.setitem(divergence._PAIR_FNS, name, lambda _args: pair or got[name])
    return divergence.run_pair(name, args), jax_div.run_pair(name, args)


@pytest.mark.parametrize("fault", [None, 7], ids=["clean", "fault7"])
@pytest.mark.parametrize("name", PAIRS)
def test_reports_match_jax(name, fault, streams, monkeypatch):
    mine, theirs = _reports(name, streams, monkeypatch, _args(inject_fault=fault))
    assert mine == theirs
    if fault is None:
        assert mine["diverged"] is False and mine["compared"] > 0


@pytest.mark.parametrize("name", PAIRS)
def test_forced_divergence_window_matches_jax(name, streams, monkeypatch):
    """A pair whose second stream differs from its first at one tick: the
    same named tick, digest window and (native-sync) frontier window."""
    a, _ = streams[0][name]
    ticks = sorted(a)
    t = ticks[len(ticks) // 2]
    b = dict(a)
    b[t] = a[t] ^ 0x10
    mine, theirs = _reports(name, streams, monkeypatch, _args(), pair=(a, b))
    assert mine == theirs
    assert mine["tick"] == t and mine["matched_head"] == ticks.index(t)
    assert str(t) in mine["digest_window"]["a"]
    assert ("frontier" in mine) == (name == "native-sync")


def test_default_device_is_cuda():
    """Without --device the bisector means the card, and raises here."""
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        divergence.main(["--pair", "native-sync"])


@pytest.mark.parametrize("fault", [[], ["--inject-fault", "4"]], ids=["clean", "fault4"])
def test_cli_exits_zero(fault):
    """``python -m p2p_gossip_tpu_torch.divergence --device cpu --json`` at
    ci_tier1.sh's sizes: every pair clean, or every pair naming the
    injected tick (4, the tick ci_tier1.sh injects: every pair's stream
    holds it, where the flood campaigns' streams end at tick 6)."""
    out = subprocess.run(
        [sys.executable, "-m", "p2p_gossip_tpu_torch.divergence", "--device", "cpu",
         "--json", *CI_SIZES, *fault],
        cwd=REPO, env=dict(os.environ, OMP_NUM_THREADS="1"), capture_output=True, text=True,
        timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["ok"] and [r["pair"] for r in rec["pairs"]] == list(PAIRS)
    if fault:
        assert rec["mode"] == "inject-fault"
        assert all(r["located_tick"] == 4 for r in rec["pairs"])
    else:
        assert all(not r["diverged"] and r["compared"] > 0 for r in rec["pairs"])


def test_fault_outside_a_stream_fails_as_in_the_jax_script(streams, monkeypatch):
    """At the defaults, --inject-fault 7 lies past the flood campaigns'
    streams (ticks 0-6): both packages report those pairs as missed, and
    the run is not ok."""
    reports = [_reports(name, streams, monkeypatch, _args(inject_fault=7))[0]
               for name in PAIRS]
    verdict = divergence.outcome(reports, 7)
    assert verdict["mode"] == "inject-fault" and not verdict["ok"]
    missed = [r["pair"] for r in reports if not r["fault_located"]]
    assert missed == ["sync-campaign", "sharded-campaign"]


def test_parse_args_has_the_jax_flags():
    args = divergence.parse_args([])
    want = argparse.Namespace(pair=None, n=96, p=0.08, shares=4, horizon=24, seed=0,
                              chunk=32, inject_fault=None, fault_bit=0, window=2,
                              json=False, device="cuda")
    assert args == want
