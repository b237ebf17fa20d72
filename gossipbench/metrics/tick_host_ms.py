"""tick_host_ms: the host's time to enqueue a tick, in milliseconds: the
mean over the traced window's ticks of the program's ``tick`` span less
its ``sync`` span (the flag read, which waits for the card), from the
telemetry sink's span events. On a card only: on the CPU the tick's
operations run inside the host's own time."""

from gossipbench import program_spans


def read(rec):
    if not rec["on_device"]:
        return None
    events = program_spans.sink_spans()
    n = program_spans.count_by_name(events).get("tick", 0)
    if not n:
        return None
    secs = program_spans.seconds_by_name(events)
    return (secs["tick"] - secs.get("sync", 0.0)) * 1e3 / n
