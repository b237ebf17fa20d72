"""Simulation request model — the server's wire format (the JAX package's
``serve/request.py``, copied over the port's own topology builders).

A request names everything one campaign run needs: a topology (family +
build parameters, condensed into a fingerprint), a protocol, the
scenario knobs (shares, horizon, loss, churn), and the replica seed
list. Requests are JSON round-trippable and schema-validated host-side
(`validate_request` never raises: every problem comes back as a
message), and this module is numpy-only, so clients and trace generators
can build and validate requests without touching torch or a device.

The scheduling key is `static_signature()`: the tuple of every field
that fixes a dispatch's shapes and shared scenario (topology, protocol,
fanout, shares, horizon, the loss threshold, the churn parameters). Two
requests with equal signatures can share one campaign batch — the whole
premise of the continuous-batching scheduler (serve/scheduler.py).
Per-replica inputs (seeds — origins, partner picks, churn intervals,
loss streams all derive from them) are deliberately NOT part of the
signature. Fingerprints and signature keys are the JAX package's strings
(`utils.checkpoint.fingerprint` hashes the same parts), so a partial
result either server checkpoints, the other resumes.

Churn/loss *values* (not just presence) ride the signature: batching
only equal-churn requests keeps the host-side interval sampling one
`flood_replicas` call per dispatch.
"""

from __future__ import annotations

import dataclasses
import json
import uuid

import numpy as np

from p2p_gossip_tpu_torch.models import topology as topo
from p2p_gossip_tpu_torch.utils.checkpoint import fingerprint

PROTOCOLS = ("flood", "pushpull", "pull", "pushk")

#: Topology families a request may name -> (builder, required params,
#: defaulted params). Every parameter is part of the topology
#: fingerprint; ``seed`` defaults to 0 like the builders themselves.
TOPOLOGY_FAMILIES: dict = {
    "erdos_renyi": (topo.erdos_renyi, ("n", "p"), ("seed",)),
    "barabasi_albert": (topo.barabasi_albert, ("n", "m"), ("seed",)),
    "watts_strogatz": (topo.watts_strogatz, ("n", "k", "beta"), ("seed",)),
    "ring": (topo.ring_graph, ("n",), ()),
    "complete": (topo.complete_graph, ("n",), ()),
    "grid": (topo.grid_graph, ("rows", "cols"), ("torus",)),
}


def topology_fingerprint(topology: dict) -> str:
    """Deterministic fingerprint of a topology spec: the family plus its
    canonically-ordered build parameters (utils.checkpoint.fingerprint).
    Two requests with equal fingerprints build the identical graph, so
    the server caches one Graph, and one staging a protocol family, per
    fingerprint."""
    family = topology.get("family")
    params = sorted(
        (k, v) for k, v in topology.items() if k != "family"
    )
    return fingerprint("serve.topology", family, *params)


def build_graph(topology: dict) -> topo.Graph:
    """Build the spec's graph (numpy only — no device touched)."""
    errs = _validate_topology(topology)
    if errs:
        raise ValueError("; ".join(errs))
    builder, required, optional = TOPOLOGY_FAMILIES[topology["family"]]
    kwargs = {k: topology[k] for k in required}
    kwargs.update({k: topology[k] for k in optional if k in topology})
    return builder(**kwargs)


def _validate_topology(topology) -> list[str]:
    if not isinstance(topology, dict):
        return [f"topology is {type(topology).__name__}, not an object"]
    family = topology.get("family")
    if family not in TOPOLOGY_FAMILIES:
        return [
            f"topology.family is {family!r}, expected one of "
            f"{tuple(TOPOLOGY_FAMILIES)}"
        ]
    errs = []
    _, required, optional = TOPOLOGY_FAMILIES[family]
    for k in required:
        if k not in topology:
            errs.append(f"topology.{k} is required for family {family!r}")
    known = set(required) | set(optional) | {"family"}
    for k in topology:
        if k not in known:
            errs.append(f"topology.{k} is not a parameter of {family!r}")
    for k in ("n", "m", "k", "rows", "cols", "seed"):
        if k in topology and not isinstance(topology[k], int):
            errs.append(f"topology.{k} must be an int")
    for k in ("p", "beta"):
        if k in topology and not isinstance(topology[k], (int, float)):
            errs.append(f"topology.{k} must be a number")
    return errs


@dataclasses.dataclass(frozen=True)
class SimRequest:
    """One unit of server work: run ``replicas`` seed-ensemble replicas
    of one campaign scenario and return per-replica counters/coverage.

    ``seeds`` carries one seed per replica (the solo-run reproduction
    contract: replica i of this request is bitwise a solo
    ``batch/campaign`` run with ``seeds[i]``). Fields default to the
    loss/churn-off scenario."""

    request_id: str
    topology: dict
    protocol: str
    shares: int
    horizon: int
    seeds: tuple
    fanout: int = 2
    loss_prob: float = 0.0
    churn_prob: float = 0.0
    mean_down_ticks: float = 10.0
    max_outages: int = 1
    #: Cross-shard transport of the JAX package's mesh-backed server:
    #: "dense", "delta" or "hub" pin the sharded campaign runners' exchange
    #: mode, "auto" defers to the server's default. A single-device server
    #: accepts and ignores it (the solo campaign runners have no exchange).
    exchange: str = "auto"

    @property
    def replicas(self) -> int:
        return len(self.seeds)

    @classmethod
    def make(cls, topology: dict, protocol: str, shares: int, horizon: int,
             seeds, request_id: str | None = None, **kwargs) -> "SimRequest":
        """Build + validate in one step (fresh UUID when no id given)."""
        req = cls(
            request_id=request_id or uuid.uuid4().hex[:12],
            topology=dict(topology), protocol=protocol, shares=shares,
            horizon=horizon, seeds=tuple(int(s) for s in seeds), **kwargs,
        )
        errs = validate_request(req.to_dict())
        if errs:
            raise ValueError("; ".join(errs))
        return req

    # -- identity ----------------------------------------------------------

    @property
    def topology_fp(self) -> str:
        return topology_fingerprint(self.topology)

    def static_signature(self) -> tuple:
        """Everything that fixes the dispatch this request runs in (its
        shapes and shared scenario) — the scheduler's bin-packing key.
        Seeds are per-replica inputs and excluded by design. The JAX
        package's tuple, part for part, so the keys agree."""
        return (
            self.topology_fp,
            self.protocol,
            self.fanout if self.protocol == "pushk" else None,
            int(self.shares),
            int(self.horizon),
            # The exchange mode only matters to the JAX package's sharded
            # runners; keeping it costs a single-device server batching
            # opportunity, never a result, and keeps the keys equal.
            self.exchange,
            # One loss threshold a dispatch; churn values pin the
            # host-side interval sampling (module docstring).
            int(round(float(self.loss_prob) * (1 << 32))),
            (float(self.churn_prob), float(self.mean_down_ticks),
             int(self.max_outages)) if self.churn_prob > 0.0 else None,
        )

    def signature_key(self) -> str:
        """The signature as a short stable string — what telemetry
        events and the scheduler's queue map carry."""
        return fingerprint("serve.signature", *self.static_signature())[:16]

    # -- JSON --------------------------------------------------------------

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["seeds"] = list(self.seeds)
        return d

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_dict(cls, d: dict) -> "SimRequest":
        errs = validate_request(d)
        if errs:
            raise ValueError("; ".join(errs))
        fields = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in d.items() if k in fields}
        kwargs["seeds"] = tuple(int(s) for s in d["seeds"])
        kwargs["topology"] = dict(d["topology"])
        return cls(**kwargs)

    @classmethod
    def from_json(cls, s: str) -> "SimRequest":
        return cls.from_dict(json.loads(s))


def validate_request(d) -> list[str]:
    """Schema errors for one request dict ([] = valid); never raises."""
    if not isinstance(d, dict):
        return [f"request is {type(d).__name__}, not an object"]
    errs: list[str] = []
    rid = d.get("request_id")
    if not isinstance(rid, str) or not rid:
        errs.append("request_id must be a non-empty string")
    errs.extend(_validate_topology(d.get("topology")))
    if d.get("protocol") not in PROTOCOLS:
        errs.append(
            f"protocol is {d.get('protocol')!r}, expected one of {PROTOCOLS}"
        )
    for key in ("shares", "horizon"):
        if not isinstance(d.get(key), int) or d.get(key, 0) < 1:
            errs.append(f"{key} must be an int >= 1")
    seeds = d.get("seeds")
    if (
        not isinstance(seeds, (list, tuple))
        or not seeds
        or not all(isinstance(s, (int, np.integer)) for s in seeds)
    ):
        errs.append("seeds must be a non-empty list of ints")
    if d.get("protocol") == "pushk" and (
        not isinstance(d.get("fanout", 2), int) or d.get("fanout", 2) < 1
    ):
        errs.append("fanout must be an int >= 1")
    for key in ("loss_prob", "churn_prob"):
        val = d.get(key, 0.0)
        if not isinstance(val, (int, float)) or not 0.0 <= val <= 1.0:
            errs.append(f"{key} must be a number in [0, 1]")
    if not isinstance(d.get("mean_down_ticks", 10.0), (int, float)):
        errs.append("mean_down_ticks must be a number")
    if not isinstance(d.get("max_outages", 1), int) or \
            d.get("max_outages", 1) < 1:
        errs.append("max_outages must be an int >= 1")
    if d.get("exchange", "auto") not in ("auto", "dense", "delta", "hub"):
        errs.append(
            f"exchange is {d.get('exchange')!r}, expected one of "
            f"('auto', 'dense', 'delta', 'hub')"
        )
    return errs
