"""stage_s: seconds of the program's staging in set-up (its CSR from the
edge list, then ``DeviceGraph.build`` or ``stage_sharded_graph``), from
the benchmark's span around the call."""


def read(rec):
    return rec["stage_s"]
