"""Scatter-OR: the OR of payload rows per destination row.

The JAX package builds it from XLA's sort and a segmented OR-scan
(`scatter_or`), or from a bit unpack and a scatter-add on narrow rows
(`scatter_or_bits`); the two give the same bits and differ only in XLA
cost. torch has no scatter-OR either (``scatter_reduce`` knows sum, prod,
mean, amax and amin), so the port has one entry point: the entries are
sorted by destination (`ops.kernels.scatter_or_plan`), and the
hand-written CUDA ``scatter_or`` kernel then gives each destination row
one warp that ORs its rows and writes it once — no atomics. The
random-partner protocols (`models.protocols`) call the plan and the
kernel themselves, to write each round's ring row in the same pass.
"""

from __future__ import annotations

import torch

from p2p_gossip_tpu_torch.ops import kernels


def scatter_or(
    n_rows: int,
    dst: torch.Tensor,
    payload: torch.Tensor,
    mask: torch.Tensor | None = None,
    *,
    src_row: torch.Tensor | None = None,
    out: torch.Tensor | None = None,
    plain: bool = False,
) -> torch.Tensor:
    """(n_rows, W) int32: the OR of the payload rows per destination — the
    JAX package's ``scatter_or(n_rows, dst, payload, mask)``, same result.

    ``dst`` (M,) integer destination rows (outside ``[0, n_rows)``:
    dropped); ``payload`` (M, W) int32 bitmask rows, or with ``src_row``
    (M,) any (R, W) table whose row ``src_row[m]`` is entry m's payload
    (outside ``[0, R)``: dropped); ``mask`` (M,) bool drops inactive
    entries. With ``out`` (n_rows, W) the rows are ORed into it in place;
    then no payload row may be a row of ``out``. On a CUDA tensor this
    launches the ``scatter_or`` kernel; ``plain=True`` or a CPU tensor takes
    its plain torch version."""
    offsets, entries = kernels.scatter_or_plan(dst, src_row, mask, n_rows, payload.shape[0])
    base = out
    if out is None:  # the kernel writes every row: no zero fill
        out = torch.empty((n_rows, payload.shape[1]), dtype=torch.int32,
                          device=payload.device)
    return kernels.scatter_or(payload, offsets, entries, base=base, out=out, plain=plain)
