"""`scatter_or` at narrow rows: several destination rows a warp.

The kernel gives a destination row a group of lanes, the smallest power of
two at least the row's units (16-byte units when W % 4 == 0 and the tables
are 16-byte aligned, else 4-byte words), at most 32; a warp holds 32 /
lanes rows, and a run longer than the kernel's threshold is taken by the
whole warp. The wrapper computes the lanes (`kernels.scatter_or_row_lanes`)
and counts its launches by them in `kernels.scatter_or_lanes`; the
protocols' ``exchange`` span carries them as ``lanes``.

CPU: the lanes rule, the alignment test beside it, the counter (empty on
the plain path, cleared by `reset_launches`), the span attribute, and the
plain version against a loop over rows at every shape the card tests use.

Card (``card`` marker, skipped without one): the kernel against the plain
version, bitwise, at W in {1, 3, 4, 8, 12, 32, 128, 132, 256}, n_out off a
multiple of a warp's rows, runs of 0, 1, 31, 32, 33, 100, 500 and 2,000
entries with hubs among short rows, ``base`` as ``out``, and-not, pull
rows and entries out of range, and a block of rounds' plan sliced per round
(the campaign's offsets, which start past 0); a push-pull campaign against
its plain run, recording lanes 1. On the card, without the JAX package:
``python -m pytest --noconftest -p no:cacheprovider -m card
tests/test_torch_scatter_narrow.py``."""

import numpy as np
import pytest
import torch

import p2p_gossip_tpu_torch as pt
from p2p_gossip_tpu_torch import telemetry
from p2p_gossip_tpu_torch.ops import kernels

WIDTHS = [1, 3, 4, 8, 12, 32, 128, 132, 256]
OPTIONS = ["zeros", "base", "in place", "andnot", "pull"]
N_OUT, N_SRC = 517, 700  # 517: no multiple of a warp's rows at any lanes
# Runs pinned among Poisson(1) runs: a hub inside a warp of short rows, runs
# on both sides of the kernel's threshold, two long runs in one warp, and
# one in the last, partial warp.
RUNS = {37: 2000, 38: 31, 39: 33, 40: 0, 41: 1, 42: 32, 45: 100, N_OUT - 2: 500}


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _clean_telemetry(monkeypatch):
    monkeypatch.delenv("P2P_TELEMETRY", raising=False)
    telemetry.reset()
    kernels.reset_launches()
    yield
    telemetry.reset()
    kernels.reset_launches()


def _words(rng, shape):
    return torch.as_tensor(rng.integers(-2**31, 2**31, shape, dtype=np.int64).astype(np.int32))


def _case(w, seed=0):
    """Source rows with bit 31 set, a sparse base, pull rows with -1 and
    out-of-range values, and destination runs (RUNS among Poisson(1)) of
    entries of which some lie outside [0, N_SRC)."""
    rng = np.random.default_rng([w, seed])
    src = _words(rng, (N_SRC, w))
    src[:, -1] |= -(2**31)
    base = torch.where(torch.as_tensor(rng.random((N_OUT, w)) < 0.2), _words(rng, (N_OUT, w)), 0)
    counts = rng.poisson(1.0, N_OUT)
    for d, c in RUNS.items():
        counts[d] = c
    offsets = np.zeros(N_OUT + 1, np.int64)
    offsets[1:] = np.cumsum(counts)
    entries = rng.integers(0, N_SRC, int(offsets[-1]))
    bad = rng.random(entries.size) < 0.05
    entries[bad] = rng.choice([-1, -7, N_SRC, N_SRC + 3], int(bad.sum()))
    pull = rng.integers(-3, N_SRC + 3, N_OUT)
    as_i32 = lambda a: torch.as_tensor(np.asarray(a).astype(np.int32))  # noqa: E731
    return src, as_i32(offsets), as_i32(entries), as_i32(pull), base


def _loop(src, offsets, entries, pull, base, andnot):
    """The definition, a row at a time in numpy."""
    s, off, ent = src.numpy(), offsets.numpy(), entries.numpy()
    n_src, n_out = s.shape[0], off.shape[0] - 1
    acc = np.zeros((n_out, s.shape[1]), np.int32)
    if base is not None and not andnot:
        acc |= base.numpy()
    for d in range(n_out):
        if pull is not None and 0 <= int(pull[d]) < n_src:
            acc[d] |= s[int(pull[d])]
        for e in ent[off[d]:off[d + 1]]:
            if 0 <= e < n_src:
                acc[d] |= s[e]
    if andnot:
        acc &= ~base.numpy()
    return acc


def _call(opt, src, offsets, entries, pull, base, plain, dev=None):
    """One `scatter_or` call with option ``opt``; ``out`` starts as all ones
    (a row the kernel should write and does not shows)."""
    to = (lambda t: t) if dev is None else (lambda t: t.to(dev))
    src, offsets, entries, pull, base = (to(t) for t in (src, offsets, entries, pull, base))
    out = base.clone() if opt == "in place" else torch.full_like(base, -1)
    b = {"zeros": None, "in place": out}.get(opt, base)
    return kernels.scatter_or(src, offsets, entries, pull_row=pull if opt == "pull" else None,
                              base=b, andnot=opt == "andnot", out=out, plain=plain)


# --- the lanes rule -----------------------------------------------------------------

@pytest.mark.parametrize("w,vec,lanes", [
    (4, True, 1), (8, True, 2), (12, True, 4), (16, True, 4), (20, True, 8),
    (32, True, 8), (64, True, 16), (68, True, 32), (124, True, 32), (128, True, 32),
    (132, True, 32), (1024, True, 32),
    (1, False, 1), (2, False, 2), (3, False, 4), (4, False, 4), (5, False, 8),
    (12, False, 16), (17, False, 32), (33, False, 32), (128, False, 32),
])
def test_row_lanes_rule(w, vec, lanes):
    """The smallest power of two at least the row's units, capped at 32;
    a warp holds 32 // lanes rows, and its lanes cover every unit of a row
    of at most 32 units."""
    got = kernels.scatter_or_row_lanes(w, vec)
    units = w // 4 if vec else w
    assert got == lanes and 32 % got == 0 and 32 // got >= 1
    assert got >= min(units, 32) and (got == 1 or got // 2 < units)


def test_vec_test_follows_width_and_alignment():
    src, out = torch.zeros((6, 8), dtype=torch.int32), torch.zeros((5, 8), dtype=torch.int32)
    assert kernels.scatter_or_vec(src, out) and kernels.scatter_or_vec(src, out, out)
    odd = torch.zeros((6, 3), dtype=torch.int32)
    assert not kernels.scatter_or_vec(odd, odd[:5])
    shifted = torch.zeros(5 * 8 + 1, dtype=torch.int32)[1:].view(5, 8)  # 4 bytes off
    assert not kernels.scatter_or_vec(src, shifted)
    assert not kernels.scatter_or_vec(src, out, shifted)


def test_lanes_counter_is_empty_on_the_plain_path_and_cleared():
    src, offsets, entries, pull, base = _case(4)
    _call("pull", src, offsets, entries, pull, base, plain=False)  # a CPU tensor: plain
    _call("base", src, offsets, entries, pull, base, plain=True)
    assert kernels.scatter_or_lanes == {} and kernels.launches["scatter_or"] == 0
    kernels.scatter_or_lanes[1] = 3
    kernels.reset_launches()
    assert kernels.scatter_or_lanes == {}


@pytest.mark.parametrize("chunk,w", [(32, 1), (128, 4), (256, 8), (4096, 128)])
def test_exchange_span_carries_the_lanes(chunk, w):
    """Every round's ``exchange`` span carries the lanes of its call's W at
    the ring's alignment: a campaign's 128-share pass 1, a 4,096-share
    pass 32."""
    from p2p_gossip_tpu_torch.batch.campaign import flood_replicas, run_protocol_campaign

    g = pt.erdos_renyi(60, 0.1, seed=2)
    reps = flood_replicas(g, 32, [1, 2], 6)  # one pass at every chunk below
    telemetry.configure(None, rings=False)
    run_protocol_campaign(g, reps, 6, chunk_size=chunk, device="cpu")
    spans = [e for e in telemetry.events() if e.get("name") == "exchange"]
    want = kernels.scatter_or_row_lanes(w, w % 4 == 0)
    assert len(spans) == 6 and {e["attrs"]["lanes"] for e in spans} == {want}
    assert kernels.scatter_or_lanes == {}  # the CPU launches nothing


@pytest.mark.parametrize("opt", OPTIONS)
@pytest.mark.parametrize("w", WIDTHS)
def test_plain_equals_row_loop_at_narrow_shapes(w, opt):
    """The plain version, which the card tests hold the kernel to, equals
    the definition row by row on the card tests' cases."""
    src, offsets, entries, pull, base = _case(w)
    got = _call(opt, src, offsets, entries, pull, base, plain=True)
    np.testing.assert_array_equal(
        got.numpy(), _loop(src, offsets, entries, pull if opt == "pull" else None,
                           None if opt == "zeros" else base, opt == "andnot"))


# --- chip_smoke's narrow-row calls, rehearsed ---------------------------------------

def _rehearse(monkeypatch, count_lanes: bool):
    """chip_smoke's `check_scatter_narrow` at 3,000 nodes on the CPU: small
    graphs in place of the cells' (a BA one with hub runs above the
    shrunk NARROW_HUB_RUN), the timing (launches of the C entry point)
    left out, and with ``count_lanes`` the wrapper's lanes counted as a
    launch would count them."""
    import os
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if repo not in sys.path:
        sys.path.insert(0, repo)
    import chip_smoke
    from p2p_gossip_tpu_torch.models.latency import lognormal_edge_delays
    from p2p_gossip_tpu_torch.models.protocols import PartnerGraph

    def graph(config, dev):
        if config == "er100k":
            return PartnerGraph.build(pt.erdos_renyi(3000, 0.01, seed=1), device=dev)
        g = pt.barabasi_albert(3000, 3, seed=2)
        return PartnerGraph.build(g, lognormal_edge_delays(g, seed=2), device=dev)

    monkeypatch.setattr(chip_smoke, "narrow_case_graph", graph)
    monkeypatch.setattr(chip_smoke, "time_ms",
                        lambda fn, reps, warmup=2, calls=1: 0.0)
    monkeypatch.setattr(chip_smoke, "NARROW_HUB_RUN", 40)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    if count_lanes:
        scatter = kernels.scatter_or

        def counting(src, *args, out, base=None, plain=False, **kw):
            got = scatter(src, *args, out=out, base=base, plain=plain, **kw)
            if not plain:
                lanes = kernels.scatter_or_row_lanes(src.shape[1],
                                                     kernels.scatter_or_vec(src, out, base))
                kernels.scatter_or_lanes[lanes] = kernels.scatter_or_lanes.get(lanes, 0) + 1
            return got

        monkeypatch.setattr(kernels, "scatter_or", counting)
    return chip_smoke.check_scatter_narrow(torch.device("cpu"), reps=1)


def test_chip_smoke_narrow_calls_rehearsed(monkeypatch):
    out = _rehearse(monkeypatch, count_lanes=True)
    assert [r["lanes"] for r in out.values()] == [1, 1, 32]
    assert all(r["max_abs_err"] == 0 and r["bound_ms"] > 0 for r in out.values())
    assert out["pushpull 1M W=4"]["max_run"] > 40


def test_chip_smoke_narrow_calls_refuse_a_launch_not_counted(monkeypatch):
    with pytest.raises(AssertionError, match="launches by lanes"):
        _rehearse(monkeypatch, count_lanes=False)


# --- on the card -------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: run on the chip")
    return torch.device("cuda", 0)


@pytest.mark.card
@pytest.mark.parametrize("opt", OPTIONS)
@pytest.mark.parametrize("w", WIDTHS)
def test_kernel_equals_plain_on_card(card, w, opt):
    src, offsets, entries, pull, base = _case(w)
    got = _call(opt, src, offsets, entries, pull, base, plain=False, dev=card)
    want = _call(opt, src, offsets, entries, pull, base, plain=True, dev=card)
    assert torch.equal(got, want)
    assert kernels.scatter_or_lanes == {kernels.scatter_or_row_lanes(w, w % 4 == 0): 1}


@pytest.mark.card
@pytest.mark.parametrize("w", WIDTHS)
def test_kernel_equals_plain_on_round_slices_on_card(card, w):
    """A block of three rounds planned at once and read a round at a time,
    as the protocols and the campaigns read it: each round's offsets start
    where the last round's end, past 0."""
    rng = np.random.default_rng([w, 7])
    n, rounds = N_OUT, 3
    src = _words(rng, (N_SRC, w)).to(card)
    dst = rng.integers(0, n, (rounds, 2 * n))
    dst[:, :2000 // rounds] = 37  # a hub in every round
    dst = torch.as_tensor(dst.astype(np.int32)).to(card)
    rows = torch.as_tensor(rng.integers(-2, N_SRC + 2, (rounds, 2 * n)).astype(np.int32)).to(card)
    key = (torch.arange(rounds, device=card)[:, None] * n).expand(rounds, 2 * n)
    offsets, entries = kernels.scatter_or_plan(dst.reshape(-1), rows.reshape(-1), None, n,
                                               N_SRC, key_offset=key.reshape(-1),
                                               rounds=rounds)
    base = _words(rng, (n, w)).to(card)
    for i in range(rounds):
        off = offsets[i * n:(i + 1) * n + 1]
        assert i == 0 or int(off[0]) > 0
        got, want = (kernels.scatter_or(src, off, entries, base=base,
                                        out=torch.full_like(base, -1), plain=plain)
                     for plain in (False, True))
        assert torch.equal(got, want)


@pytest.mark.card
def test_campaign_equals_plain_with_lanes_one_on_card(card):
    """A push-pull campaign at the default 128-share pass (W = 4): every
    round's call takes one lane a row, on the counter and on the span, and
    the run equals its plain run."""
    from p2p_gossip_tpu_torch.batch.campaign import flood_replicas, run_protocol_campaign

    g = pt.erdos_renyi(3000, 0.005, seed=1)
    reps = flood_replicas(g, 128, np.arange(4) + 1, 24)
    want = run_protocol_campaign(g, reps, 24, device=card, plain=True)
    kernels.reset_launches()
    telemetry.configure(None, rings=False)
    got = run_protocol_campaign(g, reps, 24, device=card)
    np.testing.assert_array_equal(got.received, want.received)
    np.testing.assert_array_equal(got.sent, want.sent)
    np.testing.assert_array_equal(got.coverage, want.coverage)
    assert kernels.scatter_or_lanes == {1: 24}
    spans = [e for e in telemetry.events() if e.get("name") == "exchange"]
    assert len(spans) == 24 and all(e["attrs"]["lanes"] == 1 for e in spans)


@pytest.mark.card
@pytest.mark.parametrize("w,lanes", [
    (4, 0), (4, 3), (4, 64), (8, 1), (12, 2), (32, 4), (64, 8), (128, 16), (3, 2), (21, 16),
])
def test_entry_point_refuses_fewer_lanes_than_units_on_card(card, w, lanes):
    """`gossip_scatter_or` refuses a lanes value that is no power of two
    from 1 to 32, or narrower than the row's units (at most 32) at the
    instantiation it picks, and leaves ``out`` as it was; the rule's own
    value launches."""
    from p2p_gossip_tpu_torch.ops.build import load_library

    src, offsets, entries, pull, base = (t.to(card) for t in _case(w))
    out = torch.full_like(base, -1)
    assert kernels.scatter_or_vec(src, out, base) == (w % 4 == 0)

    def call(k):
        return load_library().gossip_scatter_or(
            src.data_ptr(), src.shape[0], w, offsets.data_ptr(), entries.data_ptr(),
            pull.data_ptr(), base.data_ptr(), 0, N_OUT, out.data_ptr(), k,
            torch.cuda.current_stream(card).cuda_stream)

    assert call(lanes) != 0
    torch.cuda.synchronize(card)
    assert bool((out == -1).all())
    assert call(kernels.scatter_or_row_lanes(w, w % 4 == 0)) == 0
    want = _call("pull", *(t.cpu() for t in (src, offsets, entries, pull, base)), plain=True)
    assert torch.equal(out.cpu(), want)
