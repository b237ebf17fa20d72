"""exchange_ms_per_tick: device time of the exchange between cards a
tick on rank 0's card: the collective kernels (NCCL's) and the
exchange's own kernels, named below, over the ticks the loops ran."""

NAMES = ("nccl", "compress_deltas", "compress_pad", "scatter_deltas", "or_fold")


def read(rec):
    if not rec["on_device"] or not rec["ticks"]:
        return None
    t = rec["traces"][0]
    secs = sum(s for name, s in t["device_ops"] if any(k in name.lower() for k in NAMES))
    if secs <= 0:
        return None
    return secs * 1e3 / rec["ticks"]
