"""exchange_roofline_pct: the protocol rounds' least bytes (`gossipbench.
roofline.gather_bytes` of the push-pull reference's occupancy: 64 B an
occupied 32-byte sector of the new ``seen`` rows, 4 B a pick; see
`reference/pushpull.py`) at the card's peak HBM rate, over the device
time of the exchange kernel named below (the mean over the cards), in
percent."""

NAMES = ("scatter_or_kernel",)


def read(rec):
    peak = rec["peak_hbm_bytes_s"]
    if not rec["on_device"] or not peak or not rec["bytes_gather"]:
        return None
    secs = [sum(s for name, s in t["device_ops"] if any(k in name for k in NAMES))
            for t in rec["traces"]]
    busy = sum(secs) / len(secs)
    if busy <= 0:
        return None
    return 100.0 * rec["bytes_gather"] / (rec["chips"] * peak) / busy
