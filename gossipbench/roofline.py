"""The least bytes a flood tick must move, from the problem and not from
the program's layout, and the card's peaks.

A tick at time t reads the frontier written at t - 1 and writes its own.
Counting each input byte read once and each output byte written once,
over the data these inputs need (never whole planes, never padding):

- the gather reads, for every node u whose frontier is non-empty, the
  32-byte sectors of its row that hold a set bit (``sectors``), and 4 B
  a directed edge out of u (``edges``: the edge's index);
- the update reads and writes ``seen`` and writes the new frontier slot
  in the sectors where the tick's new bits lie (the same sector set one
  tick later): 96 B a sector;
- the per-node int32 counters (``received`` and ``sent`` read and
  written, ``degree`` read) of every node with a new bit: 20 B a node.

The occupancy comes from the benchmark's plain reference
(`gossipbench.reference.flood.occupancy_counts`) over the traced
simulations. New bits are counted where an arrival brings a share that
the node has not seen (a lower bound of the sectors an implementation
that skips empty sectors must touch), so a share of these bytes over the
card's peak cannot pass 100% by the count.
"""

from __future__ import annotations

#: HBM bandwidth by the name `torch.cuda.get_device_name` gives
#: (NVIDIA's data sheet, H100 SXM: 3.35 TB/s at the 700 W limit).
PEAK_HBM_BYTES_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}

SECTOR_BYTES = 32


def peak_hbm_bytes_s(kind: str) -> float | None:
    return PEAK_HBM_BYTES_S.get(kind)


def tick_bytes(occ: dict) -> int:
    """Least bytes of the whole tick (gather, update, counters)."""
    return (SECTOR_BYTES * occ["sectors"] + 4 * occ["edges"]
            + 3 * SECTOR_BYTES * occ["sectors"] + 20 * occ["nodes"])


def gather_bytes(occ: dict) -> int:
    """Least bytes of the gather alone: the occupied source sectors and
    edge indices read, and the arrival sectors written (at least the
    sectors of the new bits)."""
    return 2 * SECTOR_BYTES * occ["sectors"] + 4 * occ["edges"]


def window_bytes(sample_bytes: int, sample_updates: int, window_updates: int) -> float:
    """The window's bytes from the checked simulations' bytes per
    node-update (the simulations of a window are draws of one mix)."""
    if sample_updates <= 0:
        return 0.0
    return sample_bytes * (window_updates / sample_updates)
