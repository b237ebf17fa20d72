"""tick_roofline_pct: the window's least bytes (`gossipbench.roofline.
tick_bytes`, over every card of the run) at the card's peak HBM rate,
over the device's busy time (the union of its busy intervals, the mean
over the cards), in percent."""


def read(rec):
    peak = rec["peak_hbm_bytes_s"]
    if not rec["on_device"] or not peak or not rec["bytes_tick"]:
        return None
    busy = sum(t["busy_s"] for t in rec["traces"]) / len(rec["traces"])
    if busy <= 0:
        return None
    return 100.0 * rec["bytes_tick"] / (rec["chips"] * peak) / busy
