"""device_ms_per_sim: the device's busy time (the union of its busy
intervals, from ``torch.profiler``; the mean over the cards) a simulation
of the traced window, in milliseconds: the device's share of a
simulation's wall, without the host's, which swings between processes."""


def read(rec):
    if not rec["on_device"] or not rec["sims"]:
        return None
    busy = sum(t["busy_s"] for t in rec["traces"]) / len(rec["traces"])
    if busy <= 0:
        return None
    return busy * 1e3 / rec["sims"]
