"""--seed makes every input: the same seed repeats them bit for bit, and
another seed changes them."""

import numpy as np
import pytest

from gossipbench import harness
from gossipbench.gen import topology as gen_topology
from gossipbench.tests import tiny

MIXES = [("burst32k", "er100k"), ("coverage4k", "ba1m"), ("renewal", "er100k")]


def inputs(mix, cfg, seed):
    cell = harness.spec.Cell("t", 1, tiny.config(cfg), tiny.traffic(mix), [], [])
    edges = gen_topology.edges_of(cell.config["graph"], [seed % 2**64, 1])
    sims = [harness.draw(cell, seed, 2, i) for i in range(3)]
    return edges, sims


@pytest.mark.parametrize("mix,cfg", MIXES)
def test_same_seed_same_inputs(mix, cfg):
    a, b = inputs(mix, cfg, 2**31 + 7), inputs(mix, cfg, 2**31 + 7)
    assert np.array_equal(a[0], b[0])
    for (o1, t1), (o2, t2) in zip(a[1], b[1]):
        assert np.array_equal(o1, o2) and np.array_equal(t1, t2)


@pytest.mark.parametrize("mix,cfg", MIXES)
def test_other_seed_other_inputs(mix, cfg):
    a, b = inputs(mix, cfg, 2**31 + 7), inputs(mix, cfg, 2**31 + 8)
    assert not np.array_equal(a[0], b[0])
    assert not np.array_equal(a[1][0][0], b[1][0][0])


def test_simulations_differ_within_a_run():
    _, sims = inputs("burst32k", "er100k", 12)
    assert not np.array_equal(sims[0][0], sims[1][0])


def test_schedules_sorted_by_tick():
    for mix, cfg in MIXES:
        for _, ticks in inputs(mix, cfg, 3)[1]:
            assert np.all(np.diff(ticks) >= 0)


def test_frozen_generators_equal_the_programs():
    """The benchmark's frozen ER and renewal copies draw the program's own
    graphs and schedules (so a cell measures the graphs users build); its
    BA copy follows BA at the hubs instead (`test_ba_hubs_follow_ba`)."""
    from p2p_gossip_tpu_torch.models import generation, topology

    from gossipbench.gen import schedule as gen_schedule

    for edges, built in [
        (gen_topology.erdos_renyi(5000, 0.002, 9), topology.erdos_renyi(5000, 0.002, seed=9)),
        (gen_topology.erdos_renyi(300, 0.05, 9), topology.erdos_renyi(300, 0.05, seed=9)),
    ]:
        g = topology.Graph.from_edges(built.n, edges)
        assert np.array_equal(g.indptr, built.indptr)
        assert np.array_equal(g.indices, built.indices)
    s = generation.uniform_renewal_schedule(400, 5.0, 0.005, seed=4)
    o, t = gen_schedule.uniform_renewal(400, 5.0, 0.005, 2.0, 5.0, np.random.default_rng(4))
    assert np.array_equal(s.origins, o) and np.array_equal(s.gen_ticks, t)


def _degrees(n, edges):
    from gossipbench.reference.flood import csr_from_edges

    return np.diff(csr_from_edges(n, edges)[0])


def test_ba_hubs_follow_ba():
    """Preferential attachment gives node i a degree of about m sqrt(N / i),
    so the largest hub is of the order of m sqrt(N): attaching one node at
    a time, 40 seeds at N = 20,000 and m = 3 read 0.79-1.80 m sqrt(N),
    median 1.23. The batches of the frozen copy keep that law; batches of
    1,024 from the start (the program's) put ~3,072 edges on the 4 seed
    nodes at once and read ~8 m sqrt(N)."""
    n, m = 20_000, 3
    scale = m * n ** 0.5
    tops = [_degrees(n, gen_topology.barabasi_albert(n, m, [s, 1])).max() / scale
            for s in range(10)]
    assert max(tops) < 2.5 and 0.8 < float(np.median(tops)) < 1.8, tops
    one_at_a_time = [_degrees(n, gen_topology.barabasi_albert(n, m, [s, 1], n)).max() / scale
                     for s in range(10)]
    assert abs(np.median(tops) - np.median(one_at_a_time)) < 0.3, (tops, one_at_a_time)
    frozen_1024 = _degrees(n, _ba_fixed_batches(n, m, [0, 1], 1024)).max() / scale
    assert frozen_1024 > 2.5


def _ba_fixed_batches(n, m, seed, batch):
    """BA with batches of a fixed size (the program's rule), for the test."""
    rng = np.random.default_rng(seed)
    ring = np.arange(m + 1)
    edges = [np.stack([ring, np.roll(ring, -1)], axis=1)]
    pool = list(edges[0].ravel())
    nxt = m + 1
    while nxt < n:
        b = min(batch, n - nxt)
        new = np.arange(nxt, nxt + b)
        targets = np.asarray(pool)[rng.integers(0, len(pool), size=(b, m))]
        e = np.stack([np.repeat(new, m), targets.ravel()], axis=1)
        edges.append(e)
        pool.extend(e.ravel())
        nxt += b
    return np.concatenate(edges)
