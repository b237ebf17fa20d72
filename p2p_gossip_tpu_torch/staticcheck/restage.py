"""The staging sentinel: a one-time cost is paid once.

The port's counterpart of ``p2p_gossip_tpu/staticcheck/recompile.py``. The
port has no jit cache to recompile; the one-time costs the sweep and the
server must not pay twice are the host staging of a graph
(`engine.sync.DeviceGraph.build` for the flood, `models.protocols.
PartnerGraph.build` for the random-partner protocols; the campaigns call
both) and, on the card, the kernel library's build (`ops.build.build`).

The sentinel replays the JAX sentinel's grid (``default_grid``) through
`batch.sweep.run_sweep` and its serve trace (``default_serve_trace``)
through the single-device `serve.GossipServer`, counting the stagings by
kind (``bucketed``: the flood's default staging; ``partners``: the CSR
partner selection reads; ``full-width``: a `DeviceGraph` built with
``bucketed=False``, which neither replay stages) against
`expected_stagings`, which derives them from the code's own staging
rules:

- the sweep builds its graph and stages it once a cell
  (`batch.sweep.run_cell`: a flood cell bucketed, a protocol cell its
  partners);
- the server stages once per (topology, protocol family) key
  (`serve.server.GossipServer._device_graph`).

Measured != expected fails in either direction, as in JAX: an over-count
is a staging paid twice, an under-count means the model drifted from the
code and is fixed here. `build_sentinel` (the card) requires that a
second `ops.build.build` in the process compiles nothing. The mesh
server's per-dispatch protocol staging is not in the replay, as the mesh
server is not in JAX's.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import unittest.mock


def default_grid() -> dict:
    """The JAX sentinel's grid (its ``default_grid``): 6 cells, the flood
    and the two partnered protocols, with and without loss."""
    return {
        "numNodes": 64, "p": 0.1, "shares": 2, "horizon": 16, "replicas": 4,
        "protocol": ["push", "pushpull", "pushk"], "fanout": [2],
        "lossProb": [0.0, 0.1],
    }


def default_serve_trace() -> list[dict]:
    """The JAX sentinel's mixed request trace (its ``default_serve_trace``):
    2 topologies x 3 protocols, several requests sharing each topology."""
    er = {"family": "erdos_renyi", "n": 64, "p": 0.1, "seed": 1}
    ws = {"family": "watts_strogatz", "n": 64, "k": 4, "beta": 0.1, "seed": 2}
    base = {"shares": 2, "horizon": 12}
    reqs = [
        {"topology": er, "protocol": "flood", "seeds": [0, 1, 2]},
        {"topology": er, "protocol": "flood", "seeds": [3, 4]},
        {"topology": ws, "protocol": "flood", "seeds": [5]},
        {"topology": ws, "protocol": "flood", "seeds": [6, 7, 8]},
        {"topology": er, "protocol": "pushpull", "seeds": [9, 10]},
        {"topology": er, "protocol": "pushpull", "seeds": [11]},
        {"topology": ws, "protocol": "pushk", "seeds": [12, 13]},
        {"topology": er, "protocol": "flood", "seeds": [14, 15], "loss_prob": 0.1},
    ]
    return [{"request_id": f"sentinel-{i}", **base, **r} for i, r in enumerate(reqs)]


def _kind(protocol: str) -> str:
    """The staging a protocol's dispatch builds."""
    return "bucketed" if protocol in ("push", "flood") else "partners"


def expected_stagings(spec: dict) -> dict[str, int]:
    """Stagings by kind the sweep of ``spec`` pays: one a cell."""
    from p2p_gossip_tpu_torch.batch.sweep import expand_grid

    out: collections.Counter = collections.Counter()
    for cell in expand_grid(spec):
        out[_kind(cell["protocol"])] += 1
    return dict(out)


def expected_serve_stagings(trace: list[dict]) -> dict[str, int]:
    """Stagings by kind a server pays for ``trace``: one a distinct
    (topology, protocol family) key."""
    from p2p_gossip_tpu_torch.serve.request import SimRequest

    keys = set()
    for d in trace:
        req = SimRequest.from_dict(d)
        keys.add((req.topology_fp, _kind(req.protocol)))
    return dict(collections.Counter(kind for _, kind in keys))


@dataclasses.dataclass
class SentinelReport:
    ok: bool
    expected: dict
    measured: dict
    cells: int

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    def violations(self, rule: str = "staging-sentinel") -> list[dict]:
        out = []
        for k in sorted(set(self.expected) | set(self.measured)):
            e, m = self.expected.get(k, 0), self.measured.get(k, 0)
            if m > e:
                out.append({"rule": rule, "message": f"{k}: measured {m}, expected {e}: a "
                            "one-time cost is paid again"})
            elif m < e:
                out.append({"rule": rule, "message": f"{k}: measured {m}, but the model "
                            f"expected {e}: the model drifted from the code; fix the model"})
        return out


class _Counter:
    """Counts `DeviceGraph.build` and `PartnerGraph.build` calls by kind
    while patched in."""

    def __init__(self):
        from p2p_gossip_tpu_torch.engine.sync import DeviceGraph
        from p2p_gossip_tpu_torch.models.protocols import PartnerGraph

        self.orig = DeviceGraph.build
        self.orig_partners = PartnerGraph.build
        self.counts: collections.Counter = collections.Counter()

    def build(self, graph, *args, bucketed=None, **kwargs):
        self.counts["full-width" if bucketed is False else "bucketed"] += 1
        return self.orig(graph, *args, bucketed=bucketed, **kwargs)

    def build_partners(self, graph, *args, **kwargs):
        self.counts["partners"] += 1
        return self.orig_partners(graph, *args, **kwargs)

    @contextlib.contextmanager
    def patch(self):
        from p2p_gossip_tpu_torch.engine.sync import DeviceGraph
        from p2p_gossip_tpu_torch.models.protocols import PartnerGraph

        with unittest.mock.patch.object(DeviceGraph, "build", staticmethod(self.build)), \
                unittest.mock.patch.object(PartnerGraph, "build",
                                           staticmethod(self.build_partners)):
            yield


def run_sentinel(device="cpu") -> SentinelReport:
    """Replay `default_grid` through the sweep runner and compare its
    stagings with `expected_stagings`."""
    from p2p_gossip_tpu_torch.batch.sweep import expand_grid, run_sweep

    spec = default_grid()
    counter = _Counter()
    with counter.patch():
        run_sweep(spec, device=device)
    expected, measured = expected_stagings(spec), dict(counter.counts)
    return SentinelReport(expected == measured, expected, measured, len(expand_grid(spec)))


def run_serve_sentinel(device="cpu") -> SentinelReport:
    """Replay `default_serve_trace` through a 4-slot server on ``device``
    and compare its stagings with `expected_serve_stagings`."""
    from p2p_gossip_tpu_torch.serve.request import SimRequest
    from p2p_gossip_tpu_torch.serve.server import GossipServer

    trace = default_serve_trace()
    counter = _Counter()
    with counter.patch():
        server = GossipServer(slots=4, device=device)
        for d in trace:
            server.submit(SimRequest.from_dict(d))
        server.drain()
    expected, measured = expected_serve_stagings(trace), dict(counter.counts)
    return SentinelReport(expected == measured, expected, measured, len(trace))


def build_sentinel() -> dict:
    """The kernel library's build, paid once: a second `ops.build.build` in
    the process finds its library and compiles nothing (the card)."""
    from p2p_gossip_tpu_torch.ops import build

    path, first_s = build.build()
    again, second_s = build.build()
    violations = []
    if again != path or second_s != 0.0:
        violations.append({"rule": "build-sentinel", "message":
                           f"a second build compiled for {second_s:.2f} s ({again}): the "
                           "kernel library must be built once a source"})
    return {"ok": not violations, "library": path, "first_build_s": round(first_s, 3),
            "second_build_s": second_s, "violations": violations}
