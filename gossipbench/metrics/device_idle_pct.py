"""device_idle_pct: the share of the traced window in which no operation
(kernel, copy or fill) ran on the card, from ``torch.profiler`` (the
union of the device's busy intervals); rank 0's card on a mesh."""


def read(rec):
    if not rec["on_device"]:
        return None
    t = rec["traces"][0]
    if t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
