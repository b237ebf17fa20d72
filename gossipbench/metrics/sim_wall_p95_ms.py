"""sim_wall_p95_ms: the 95th percentile (numpy, linear) of the window's
simulation walls, each from the entry's call (schedule staging in) to its
counters on the host, in milliseconds. End to end in the untraced run;
``sim_wall_p95_ms.coverage`` reads the traced run's, for the coverage
cell whose tail spreads too widely between runs to bound."""

import numpy as np


def read(rec):
    if len(rec["walls"]) < 2:
        return None
    return float(np.percentile(rec["walls"], 95)) * 1e3
