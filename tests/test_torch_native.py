"""The port's own binding of the C++ runtime (``p2p_gossip_tpu_torch.
runtime.native``) against the JAX package's binding: the graph builders
give equal CSRs for the same seed (also through the capacity retry and at
p = 0), and the event and partnered engines equal counters. The port
builds the library from ``native/gossip_native.cc`` into its own build
directory and never writes into ``native/``.

Skipped, as tests/test_native.py is, on a machine without a C++ compiler
(the JAX binding then has no library either)."""

import os
import shutil

import numpy as np
import pytest

import p2p_gossip_tpu as pg
import p2p_gossip_tpu_torch as pt
from p2p_gossip_tpu.models import churn as jax_churn
from p2p_gossip_tpu.models import latency as jax_latency
from p2p_gossip_tpu.models.linkloss import LinkLossModel as JaxLoss
from p2p_gossip_tpu.runtime import native as jax_native
from p2p_gossip_tpu_torch.engine import event
from p2p_gossip_tpu_torch.models import churn, latency
from p2p_gossip_tpu_torch.runtime import native

pytestmark = pytest.mark.skipif(
    shutil.which("g++") is None or shutil.which("make") is None,
    reason="no C++ compiler or make to build the native library",
)


@pytest.fixture(scope="module", autouse=True)
def jax_library():
    if not jax_native.available():
        pytest.skip("the JAX package's native library did not build")


def _same_csr(got, want):
    assert got.n == want.n
    assert got.indptr.dtype == np.int64 and got.indices.dtype == np.int32
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.indices, want.indices)


@pytest.mark.parametrize("n,p,seed", [(2, 0.5, 0), (50, 0.0, 1), (300, 0.03, 2),
                                      (2000, 0.004, 3), (5000, 0.001, 4)])
def test_er_builder_equals_the_jax_bindings(n, p, seed):
    _same_csr(native.native_erdos_renyi(n, p, seed=seed),
              jax_native.native_erdos_renyi(n, p, seed=seed))


@pytest.mark.parametrize("n,m,seed", [(4, 3, 0), (300, 2, 1), (3000, 3, 7)])
def test_ba_builder_equals_the_jax_bindings(n, m, seed):
    g = native.native_barabasi_albert(n, m=m, seed=seed)
    _same_csr(g, jax_native.native_barabasi_albert(n, m=m, seed=seed))
    g.validate()


@pytest.mark.parametrize("fn,arg", [("gossip_build_er", 0.05), ("gossip_build_ba", 3)])
def test_capacity_retry_returns_the_same_graph(fn, arg):
    """A capacity guess far too small: the builder reports what it needs and
    the second call fills it; the CSR equals the JAX binding's default one,
    and the indices hold exactly nnz entries (the tail released in place)."""
    got = native._build_native_graph(fn, 400, arg, 5, cap=16)
    want = jax_native._build_native_graph(fn, 400, arg, 5)
    _same_csr(got, want)
    assert got.indices.shape == (int(got.indptr[-1]),)


def test_bad_ba_arguments_raise():
    with pytest.raises(RuntimeError):
        native.native_barabasi_albert(3, m=3)


def _models(n, horizon, seed):
    return (
        dict(churn=churn.random_churn(n, horizon, outage_prob=0.3, mean_down_ticks=10,
                                      max_outages=2, seed=seed),
             loss=pt.LinkLossModel(0.15, seed=seed)),
        dict(churn=jax_churn.random_churn(n, horizon, outage_prob=0.3, mean_down_ticks=10,
                                          max_outages=2, seed=seed),
             loss=JaxLoss(0.15, seed=seed)),
    )


@pytest.mark.parametrize("options", ["none", "churn_loss", "connect_fifo", "delays"])
def test_native_flood_equals_the_jax_binding_and_the_event_engine(options):
    n, horizon, seed = 80, 400, 3
    g, jg = pt.erdos_renyi(n, 0.06, seed=seed), pg.erdos_renyi(n, 0.06, seed=seed)
    sched = pt.poisson_schedule(n, sim_time=3.0, tick_dt=0.01, rate=0.5, seed=seed)
    jsched = pg.poisson_schedule(n, sim_time=3.0, tick_dt=0.01, rate=0.5, seed=seed)
    kw, jkw = {}, {}
    if options == "churn_loss":
        kw, jkw = _models(n, horizon, seed)
    elif options == "connect_fifo":
        kw = dict(connect_tick=60, fifo_links=latency.fifo_link_model(20000, 5.0, 0.01))
        jkw = dict(connect_tick=60,
                   fifo_links=jax_latency.fifo_link_model(20000, 5.0, 0.01))
    elif options == "delays":
        kw = dict(ell_delays=latency.lognormal_delays(g, 2.0, 0.6, 6, seed=seed))
        jkw = dict(ell_delays=jax_latency.lognormal_delays(jg, 2.0, 0.6, 6, seed=seed))
    snaps = [100, 250, 399, 500]
    got = native.run_native_sim(g, sched, horizon, snapshot_ticks=snaps, **kw)
    want = jax_native.run_native_sim(jg, jsched, horizon, snapshot_ticks=snaps, **jkw)
    assert got.equal_counts(want)
    assert got.extra == want.extra
    ev = event.run_event_sim(g, sched, horizon, snapshot_ticks=snaps, **kw)
    assert got.equal_counts(ev)
    assert got.extra["events_processed"] == ev.extra["events_processed"]
    assert got.extra["snapshots"] == ev.extra["snapshots"]


@pytest.mark.parametrize("protocol", ["pushpull", "pull", "pushk"])
@pytest.mark.parametrize("options", [False, True])
def test_native_partnered_equals_the_jax_binding(protocol, options):
    n, horizon, seed = 60, 120, 4
    g, jg = pt.barabasi_albert(n, m=2, seed=seed), pg.barabasi_albert(n, m=2, seed=seed)
    sched = pt.uniform_renewal_schedule(n, sim_time=3.0, tick_dt=0.01, seed=seed)
    jsched = pg.uniform_renewal_schedule(n, sim_time=3.0, tick_dt=0.01, seed=seed)
    kw, jkw = _models(n, horizon, seed) if options else ({}, {})
    got = native.run_native_partnered_sim(g, sched, horizon, protocol=protocol, fanout=3,
                                          seed=9, **kw)
    want = jax_native.run_native_partnered_sim(jg, jsched, horizon, protocol=protocol,
                                               fanout=3, seed=9, **jkw)
    assert got.equal_counts(want)
    ev = event.run_event_partnered_sim(g, sched, horizon, protocol=protocol, fanout=3,
                                       seed=9, **kw)
    assert got.equal_counts(ev)
    with pytest.raises(ValueError, match="unknown protocol"):
        native.run_native_partnered_sim(g, sched, horizon, protocol="flood")


def test_build_writes_only_under_its_build_directory(tmp_path):
    """A build into a fresh directory: one library there, under the
    source-hash name; ``native/`` is left as it was (the JAX package's own
    build product there keeps its mtime)."""
    native_dir = native.NATIVE_DIR
    before = {name: os.stat(os.path.join(native_dir, name)).st_mtime_ns
              for name in os.listdir(native_dir)}
    path, seconds = native.build(str(tmp_path))
    assert seconds > 0.0
    assert os.listdir(tmp_path) == [os.path.basename(path)]
    assert path == native.library_path(str(tmp_path))
    assert native.build(str(tmp_path)) == (path, 0.0)  # keyed: no rebuild
    after = {name: os.stat(os.path.join(native_dir, name)).st_mtime_ns
             for name in os.listdir(native_dir)}
    assert after == before
    assert native.load_library()._name != os.path.join(native_dir, "libgossip_native.so")
    assert os.path.dirname(native.load_library()._name) == native.BUILD_DIR


def test_failed_build_raises_with_the_build_output(tmp_path, monkeypatch):
    """No silent fallback: a build that fails raises RuntimeError carrying
    make's output."""
    bad = tmp_path / "native"
    bad.mkdir()
    (bad / "Makefile").write_text("all:\n\t@echo broken-build-output; exit 3\n")
    (bad / "gossip_native.cc").write_text("")
    monkeypatch.setattr(native, "NATIVE_DIR", str(bad))
    monkeypatch.setattr(native, "SOURCE", str(bad / "gossip_native.cc"))
    with pytest.raises(RuntimeError, match="broken-build-output"):
        native.build(str(tmp_path / "out"))
    assert not list((tmp_path / "out").iterdir())
