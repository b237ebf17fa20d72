"""Telemetry layer: per-tick metric and digest rings on the device, host
span tracing, progress beats and a heartbeat file — the JAX package's
``telemetry`` package, with its event schema, kernel names and stream
slicing, so a stream from either package compares with the other's.

Off by default. Enable with ``P2P_TELEMETRY=<path>`` (JSONL stream) or
the CLI's ``--telemetry``; programmatic: ``telemetry.configure(path)``.
When off, the engines keep no ring, launch no extra kernel and spans
are no-ops.

Layout: `schema` (event contract), `sink` (the stream), `spans` (host
phase timers), `rings` (device per-tick aggregates), `digest` (per-tick
state digests on the ``tick_digest`` CUDA kernel — the flight
recorder), `progress` (per-chunk liveness beats + heartbeat file),
`compare` (digest-stream alignment), `chrometrace` (Perfetto /
chrome://tracing export). Docs: docs/OBSERVABILITY.md (the JAX
package's; the event contract is the same).
"""

from p2p_gossip_tpu_torch.telemetry.schema import (  # noqa: F401
    METRIC_COLUMNS,
    NUM_METRICS,
    REQUEST_EVENTS,
    SCHEMA_VERSION,
    SUPPORTED_SCHEMAS,
    validate_event,
    validate_stream,
)
from p2p_gossip_tpu_torch.telemetry.sink import (  # noqa: F401
    configure,
    close,
    emit,
    enabled,
    event_count,
    events,
    path,
    reset,
    rings_enabled,
)
from p2p_gossip_tpu_torch.telemetry.spans import span  # noqa: F401
from p2p_gossip_tpu_torch.telemetry.progress import (  # noqa: F401
    configure_heartbeat,
    emit_progress,
    heartbeat_age_s,
    heartbeat_path,
    is_stale,
    read_heartbeat,
    write_heartbeat,
)
