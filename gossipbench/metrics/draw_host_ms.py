"""draw_host_ms: the host's time a protocol round spends drawing the
exchanges, in milliseconds: the program's ``draw`` spans (one a block of
16 rounds: the picks, coins, pull rows and push plan) summed over the
traced window, over the rounds (the ``round`` spans), from the telemetry
sink's span events. On a card only, as ``round_host_ms``."""

from gossipbench import program_spans


def read(rec):
    if not rec["on_device"]:
        return None
    events = program_spans.sink_spans()
    n = program_spans.count_by_name(events).get("round", 0)
    secs = program_spans.seconds_by_name(events)
    if not n or "draw" not in secs:
        return None
    return secs["draw"] * 1e3 / n
