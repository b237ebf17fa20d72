"""round_host_ms: the host's time to enqueue a protocol round, in
milliseconds: the program's ``round`` spans (each round of
`models.protocols._run_chunk`, its block's draw included; the round loop
reads nothing back from the card) summed over the traced window, over
the rounds (the ``round`` spans), from the telemetry sink's span events.
On a card only: on the CPU a round's operations run inside the host's
own time."""

from gossipbench import program_spans


def read(rec):
    if not rec["on_device"]:
        return None
    events = program_spans.sink_spans()
    n = program_spans.count_by_name(events).get("round", 0)
    if not n:
        return None
    return program_spans.seconds_by_name(events)["round"] * 1e3 / n
