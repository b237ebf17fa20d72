"""Multi-GPU: the sharded flood engine over ``torch.distributed``.

- `mesh`: the (shares, nodes) process mesh, process-group start-up.
- `launch`: spawn W local ranks (tests, chip_smoke).
- `exchange`: the sparse frontier-delta exchange's planners and device ops.
- `async_ticks`: bounded-staleness async reads.
- `engine_sharded`: ``run_sharded_sim`` and ``run_sharded_flood_coverage``.
"""
