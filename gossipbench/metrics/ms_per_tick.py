"""ms_per_tick: the traced window's wall over the ticks its loops ran
(``ticks_executed``, or for the coverage entry the ticks its coverage
rows imply), in milliseconds. The profiler is on in this run."""


def read(rec):
    if not rec["ticks"]:
        return None
    return rec["window_s"] * 1e3 / rec["ticks"]
