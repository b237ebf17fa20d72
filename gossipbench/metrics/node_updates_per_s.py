"""node_updates_per_s: every node-update (``processed``, summed over the
nodes and over the ranks) of the window's simulations, over the window's
whole wall: the first timed simulation's start to the last one's counters
on the host."""


def read(rec):
    return rec["updates"] / rec["window_s"]
