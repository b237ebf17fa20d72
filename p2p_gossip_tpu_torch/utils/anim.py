"""NetAnim-style visualization export (the JAX package's ``utils/anim.py``;
the same graph writes the same bytes).

Mirrors `SetupNetAnim` (p2pnetwork.cc:153-190): nodes on a ceil(sqrt(N)) grid
at 100-unit spacing, colored by degree (>4 red, >2 green, else blue), written
as a NetAnim-flavored XML file, optionally with per-message packet events.
"""

from __future__ import annotations

import math
import xml.sax.saxutils as sax

import numpy as np

from p2p_gossip_tpu_torch.models.topology import Graph


def _grid_positions(n: int) -> np.ndarray:
    grid = math.ceil(math.sqrt(n)) if n else 1
    i = np.arange(n)
    return np.stack([100.0 * (i % grid), 100.0 * (i // grid)], axis=1)


def _degree_color(degree: int) -> tuple[int, int, int]:
    # p2pnetwork.cc:173-184: >4 red, >2 green, else blue.
    if degree > 4:
        return (255, 0, 0)
    if degree > 2:
        return (0, 255, 0)
    return (0, 0, 255)


def write_animation_xml(
    graph: Graph, path: str, tick_dt: float = 1.0, messages=None
) -> None:
    """Write a NetAnim-style XML trace (reference default file name:
    ``p2p-gossip-tcp-animation.xml``): the nodes on the reference's grid,
    coloured by degree, and the links; optionally per-message packet
    events, the analogue of NetAnim's ``EnablePacketMetadata``
    (p2pnetwork.cc:187): one ``<p>``
    element per transmission with NetAnim's packet attributes (fId/tId
    sender/receiver, fbTx/fbRx first-bit times) plus the share id and the
    outcome (delivered / duplicate / lost / down / horizon), from the
    (src, dst, share, tx_tick, rx_tick, outcome) tuples of
    ``run_event_sim(record_messages=True)``. (The JAX package's function
    can also embed per-tick coverage rows, which no caller passes; without
    them both write the same bytes.)"""
    pos = _grid_positions(graph.n)
    lines = ['<?xml version="1.0" encoding="UTF-8"?>', '<anim ver="netanim-3.108">']
    for i in range(graph.n):
        deg = int(graph.degree[i])
        r, g, b = _degree_color(deg)
        desc = sax.quoteattr(f"Node {i}")
        lines.append(
            f'<node id="{i}" locX="{pos[i, 0]:.1f}" locY="{pos[i, 1]:.1f}" '
            f'descr={desc} r="{r}" g="{g}" b="{b}" degree="{deg}"/>'
        )
    for a, b_ in graph.edges():
        lines.append(f'<link fromId="{int(a)}" toId="{int(b_)}"/>')
    if messages is not None:
        for src, dst, share, tx, rx, outcome in messages:
            lines.append(
                f'<p fId="{int(src)}" tId="{int(dst)}" '
                f'fbTx="{tx * tick_dt:.6g}" fbRx="{rx * tick_dt:.6g}" '
                f'share="{int(share)}" outcome="{outcome}"/>'
            )
    lines.append("</anim>")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
