"""The port's sharded random-partner protocols
(``p2p_gossip_tpu_torch.parallel.protocols_sharded``) on gloo ranks of the
CPU against the JAX package's sharded protocols on the 8-virtual-device
CPU mesh of the same shape, and against the port's single-device
protocols: bitwise (integer ops, tolerance 0) on counters, coverage rows
and ``stats.extra['exchange']`` / ``['ring']``, for every mesh shape,
protocol, ring mode and exchange, with churn and loss; checkpoints either
package resumes; telemetry's ring and digest events.

One world of 4 spawned ranks (`parallel.launch.spawn`) runs every case of
this module, each on a mesh over the world's first ranks, while threads of
this process run the JAX references; the parametrised tests read both.
The workers import only the port."""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import jax

import p2p_gossip_tpu as pg
from p2p_gossip_tpu import telemetry as jax_tel
from p2p_gossip_tpu.models.latency import lognormal_delays as jax_lognormal
from p2p_gossip_tpu.parallel.mesh import make_mesh as jax_mesh
from p2p_gossip_tpu.parallel.protocols_sharded import (
    run_sharded_partnered_sim as jax_partnered,
)

import p2p_gossip_tpu_torch as pt
from p2p_gossip_tpu_torch.models.latency import lognormal_delays
from p2p_gossip_tpu_torch.models.protocols import run_pushk_sim, run_pushpull_sim
from p2p_gossip_tpu_torch.parallel import async_ticks, launch

SIM = "p2p_gossip_tpu_torch.parallel.protocols_sharded:run_sharded_partnered_sim"
SHAPES = [(1, 1), (2, 1), (4, 1), (1, 2), (2, 2)]  # (nodes, shares)
ANTI_MODES = {
    "replicated": dict(ring_mode="replicated"),
    "sharded": dict(ring_mode="sharded"),
    "delta": dict(exchange="delta"),
    "hub": dict(exchange="hub", hub_rows=8),
    "async_delta_k1": dict(exchange="async-delta", async_k=1),
    "async_delta_k2": dict(exchange="async-delta", async_k=2),
    "async_dense_k2": dict(exchange="async-dense", async_k=2),
}
PUSHK_MODES = {"replicated": dict(ring_mode="replicated"), "sharded": dict(ring_mode="sharded")}
VARIANTS = (
    [(proto, 1, mode) for proto in ("pushpull", "pull") for mode in ANTI_MODES]
    + [("pushk", fanout, mode) for fanout in (2, 3) for mode in PUSHK_MODES]
)
HORIZON = 40
SEED = 7
# (name, nodes, shares, protocol, fanout, mode) of the telemetry-on runs.
TELEMETRY = [("tel-pushpull", 2, 2, "pushpull", 1, "async_delta_k2"),
             ("tel-pull", 4, 1, "pull", 1, "hub"),
             ("tel-pushk", 2, 1, "pushk", 2, "sharded")]


def _hazard(pkg, lognormal):
    """103 rows (padded to 104 over 4 node shards), lognormal delays,
    churn, loss 0.5 and a schedule of 63 shares (two 32-share passes on
    one share shard)."""
    g = pkg.erdos_renyi(103, 0.06, seed=2)
    return dict(
        g=g,
        d=lognormal(g, mean_ticks=2.0, sigma=0.5, max_ticks=4, seed=2),
        sched=pkg.poisson_schedule(103, sim_time=0.6, tick_dt=0.01, rate=1.0, seed=2),
        loss=pkg.LinkLossModel(0.5, seed=3),
        churn=pkg.random_churn(103, 120, outage_prob=0.3, mean_down_ticks=40, seed=5),
    )


def _mode_kwargs(protocol, mode):
    return (PUSHK_MODES if protocol == "pushk" else ANTI_MODES)[mode]


def _kwargs(h, protocol, fanout, mode, **extra):
    return dict(protocol=protocol, fanout=fanout, ell_delays=h["d"], chunk_size=32, seed=SEED,
                loss=h["loss"], churn=h["churn"], **_mode_kwargs(protocol, mode), **extra)


def _case_name(protocol, fanout, mode, nodes, shares):
    tag = f"{protocol}{fanout}" if protocol == "pushk" else protocol
    return f"{tag}-{mode}-{nodes}x{shares}"


MATRIX = [(_case_name(p, f, m, n, s), n, s, p, f, m)
          for (n, s) in SHAPES for (p, f, m) in VARIANTS]


def _cases(h, tmp):
    """(name, nodes, shares, target, args, kwargs[, events]) of every case."""
    args = (h["g"], h["sched"], HORIZON)
    cases = [(name, n, s, SIM, args, _kwargs(h, p, f, m, record_coverage=True))
             for name, n, s, p, f, m in MATRIX]
    cases += [(name, n, s, SIM, args, _kwargs(h, p, f, m), True)
              for name, n, s, p, f, m in TELEMETRY]
    cases += [
        ("resume", 4, 1, SIM, args,
         _kwargs(h, "pull", 1, "delta", checkpoint_path=str(tmp / "jax.npz"))),
        ("write", 2, 1, SIM, args,
         _kwargs(h, "pushk", 2, "sharded", checkpoint_path=str(tmp / "port.npz"),
                 stop_after_chunks=1)),
    ]
    return cases


def _jax_mesh(nodes, shares):
    return jax_mesh(nodes, shares, devices=jax.devices("cpu"))


def _jax_run(h, nodes, shares, protocol, fanout, mode, **extra):
    return jax_partnered(h["g"], h["sched"], HORIZON, _jax_mesh(nodes, shares),
                         **_kwargs(h, protocol, fanout, mode, **extra))


def _jax_events(h, nodes, shares, protocol, fanout, mode):
    jax_tel.reset()
    jax_tel.configure(None, rings=True)
    try:
        _jax_run(h, nodes, shares, protocol, fanout, mode)
        return jax_tel.events()
    finally:
        jax_tel.reset()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case's results, rank by rank, from one world of 4 ranks, and
    the JAX references, run in this process meanwhile. The JAX checkpoint
    the port resumes is written first."""
    tmp = tmp_path_factory.mktemp("sharded_protocols")
    hj = _hazard(pg, jax_lognormal)
    _jax_run(hj, 4, 1, "pull", 1, "delta", checkpoint_path=str(tmp / "jax.npz"),
             stop_after_chunks=1)
    # The event runs first: the JAX sink is global, the matrix's runs share it.
    want = {name: _jax_events(hj, n, s, p, f, m) for name, n, s, p, f, m in TELEMETRY}
    cases = _cases(_hazard(pt, lognormal_delays), tmp)
    # One thread waits on the world, three run the JAX references (XLA
    # compiles outside the GIL).
    with ThreadPoolExecutor(4) as pool:
        world = pool.submit(launch.spawn, launch.call_on_meshes, 4, [c[1:] for c in cases],
                            timeout_s=120.0)
        refs = {name: pool.submit(_jax_run, hj, n, s, p, f, m, record_coverage=True)
                for name, n, s, p, f, m in MATRIX}
        want.update({name: ref.result() for name, ref in refs.items()})
        results = world.result()
    got = {case[0]: [r[i] for r in results if r[i] is not None]
           for i, case in enumerate(cases)}
    return got, want, tmp


@pytest.fixture(scope="module")
def solo():
    """The port's single-device protocols on the hazard graph, by
    (protocol, fanout, async K): K > 0 runs the delays clamped to max(d, K)."""
    h = _hazard(pt, lognormal_delays)
    out = {}
    for protocol, fanout, mode in VARIANTS:
        k = _mode_kwargs(protocol, mode).get("async_k", 0)
        if (protocol, fanout, k) in out:
            continue
        d = async_ticks.clamp_partner_delays(h["d"], k) if k else h["d"]
        kw = dict(ell_delays=d, seed=SEED, loss=h["loss"], churn=h["churn"],
                  record_coverage=True, device="cpu")
        if protocol == "pushk":
            out[protocol, fanout, k] = run_pushk_sim(h["g"], h["sched"], HORIZON, fanout=fanout,
                                                     **kw)
        else:
            out[protocol, fanout, k] = run_pushpull_sim(h["g"], h["sched"], HORIZON,
                                                        mode=protocol, **kw)
    return out


def _same_stats(a, b):
    for f in ("generated", "received", "forwarded", "sent", "processed", "degree"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f


def _one(results):
    """Rank 0's result, after checking every rank of the mesh returned the
    same global stats (and coverage rows)."""
    for r in results[1:]:
        _same_stats(r[0], results[0][0])
        assert np.array_equal(r[1], results[0][1])
    return results[0]


@pytest.mark.parametrize("case", MATRIX, ids=[c[0] for c in MATRIX])
def test_matches_jax_and_single_device(case, runs, solo):
    """Every mesh shape x protocol x ring mode x exchange on the hazard
    graph: the JAX sharded protocols' counters, coverage rows, ring and
    exchange reports, and the port's single-device protocols' counters and
    coverage rows (async K against the delays clamped to max(d, K))."""
    name, _, _, protocol, fanout, mode = case
    got, want, _ = runs
    stats, cov = _one(got[name])
    want_stats, want_cov = want[name]
    _same_stats(stats, want_stats)
    assert np.array_equal(cov, want_cov)
    assert stats.extra["exchange"] == want_stats.extra["exchange"]
    assert stats.extra["ring"] == want_stats.extra["ring"]
    assert stats.extra["resident_bytes"] > 0
    k = _mode_kwargs(protocol, mode).get("async_k", 0)
    solo_stats, solo_cov = solo[protocol, fanout, k]
    _same_stats(stats, solo_stats)
    assert np.array_equal(cov, solo_cov)


def test_delta_and_hub_exchange_report_traffic(runs):
    """On 4 node shards the delta and hub runs ship entries every round of
    both passes (the report's achieved counters, equal to JAX's above)."""
    got = runs[0]
    for mode in ("delta", "hub"):
        ex = _one(got[f"pushpull-{mode}-4x1"])[0].extra["exchange"]
        assert ex["mode"] == mode and ex["achieved_used_entries"] > 0
        assert ex["exchange_ticks"] == 2 * HORIZON
    assert _one(got["pushpull-hub-4x1"])[0].extra["exchange"]["hub_count"] == 8


@pytest.mark.parametrize("case", TELEMETRY, ids=[c[0] for c in TELEMETRY])
def test_telemetry_events_match_jax(case, runs):
    """With the rings on, the first rank's ring and digest events equal the
    JAX sharded protocols': metric rows SUMmed over the node shards
    (exchange words and async staleness included), digests XORed."""
    got, want, _ = runs
    _, events = got[case[0]][0]

    def pick(evs):
        return [{k: v for k, v in e.items() if k != "wall"} for e in evs
                if e["type"] in ("ring", "digest")]

    mine, theirs = pick(events), pick(want[case[0]])
    assert mine and mine == theirs
    assert any(e["type"] == "digest" and any(e["values"]) for e in mine)


def test_port_resumes_a_jax_checkpoint(runs):
    """The JAX sharded protocols ran one pass of pull (delta, 4 node
    shards) and wrote a checkpoint; the port resumes it and ends with the
    full run's counters."""
    got = runs[0]
    port = got["resume"][0]
    for r in got["resume"][1:]:
        _same_stats(r, port)
    h = _hazard(pg, jax_lognormal)
    _same_stats(port, _jax_run(h, 4, 1, "pull", 1, "delta"))


def test_jax_resumes_a_port_checkpoint(runs):
    """The port's first rank wrote its checkpoint after one pass of fanout
    push; the JAX sharded protocols resume it and end with the full run's
    counters."""
    got, _, tmp = runs
    partial = got["write"][0]
    h = _hazard(pg, jax_lognormal)
    full = _jax_run(h, 2, 1, "pushk", 2, "sharded")
    assert not np.array_equal(partial.received, full.received)  # one pass of two
    resumed = _jax_run(h, 2, 1, "pushk", 2, "sharded", checkpoint_path=str(tmp / "port.npz"))
    _same_stats(resumed, full)


def test_refusals_in_a_world_of_one():
    """Refused as by JAX, before any collective: fanout push with an async
    exchange (ValueError), pull past the responder-credit bound
    (PullCreditBoundError, JAX's message: a star's hub of degree 2^12 and a
    2^20-share chunk), a checkpoint with coverage rows, an unknown
    protocol."""
    import torch.distributed as dist

    from p2p_gossip_tpu.models.protocols import PullCreditBoundError as JaxBound

    from p2p_gossip_tpu_torch.models.protocols import PullCreditBoundError
    from p2p_gossip_tpu_torch.parallel.mesh import initialize_multihost, make_mesh
    from p2p_gossip_tpu_torch.parallel.protocols_sharded import run_sharded_partnered_sim

    n, width = (1 << 12) + 1, 1 << 20
    star = np.stack([np.zeros(n - 1, np.int64), np.arange(1, n)], axis=1)
    never = (np.zeros(width, np.int32), np.full(width, 99, np.int32))
    with pytest.raises(JaxBound) as jax_err:
        jax_partnered(pg.Graph.from_edges(n, star), pg.Schedule(n, *never), 4,
                      _jax_mesh(1, 1), protocol="pull", chunk_size=width)
    assert not dist.is_initialized()
    initialize_multihost(device="cpu")
    try:
        mesh = make_mesh(device="cpu")
        with pytest.raises(PullCreditBoundError) as err:
            run_sharded_partnered_sim(pt.Graph.from_edges(n, star), pt.Schedule(n, *never), 4,
                                      mesh, protocol="pull", chunk_size=width)
        assert str(err.value) == str(jax_err.value)
        h = _hazard(pt, lognormal_delays)
        args = (h["g"], h["sched"], HORIZON, mesh)
        with pytest.raises(ValueError, match="anti-entropy"):
            run_sharded_partnered_sim(*args, protocol="pushk", exchange="async")
        with pytest.raises(ValueError, match="record_coverage"):
            run_sharded_partnered_sim(*args, record_coverage=True, checkpoint_path="x.npz")
        with pytest.raises(ValueError, match="unknown protocol"):
            run_sharded_partnered_sim(*args, protocol="flood")
    finally:
        dist.destroy_process_group()
