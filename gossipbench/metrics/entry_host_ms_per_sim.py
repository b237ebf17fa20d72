"""entry_host_ms_per_sim: the entry's host work outside its tick loop a
simulation of the traced window, in milliseconds: the program's
``inputs`` (options, schedule, padding, the copy onto the card), ``d2h``
(counters and coverage rows to the host) and ``stats`` (the int64
per-node statistics) spans, from the telemetry sink's span events. On a
card only, as ``tick_host_ms``."""

from gossipbench import program_spans

NAMES = ("inputs", "d2h", "stats")


def read(rec):
    if not rec["on_device"] or not rec["sims"]:
        return None
    secs = program_spans.seconds_by_name(program_spans.sink_spans())
    if not all(k in secs for k in NAMES):
        return None
    return sum(secs[k] for k in NAMES) * 1e3 / rec["sims"]
