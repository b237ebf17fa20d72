"""Scatter-OR: the OR of payload rows per destination row.

The JAX package builds it from XLA's sort and a segmented OR-scan
(`scatter_or`), or from a bit unpack and a scatter-add on narrow rows
(`scatter_or_bits`); the two give the same bits and differ only in XLA
cost. torch has no scatter-OR either (``scatter_reduce`` knows sum, prod,
mean, amax and amin), so the port has one entry point, backed by the
hand-written CUDA ``scatter_or`` kernel (`ops.kernels`), whose integer
``atomicOr`` is exact in any order. Used by the push directions of the
random-partner protocols (`models.protocols`).
"""

from __future__ import annotations

import torch

from p2p_gossip_tpu_torch.ops import kernels


def _int32_index(idx: torch.Tensor, bound: int) -> torch.Tensor:
    """``idx`` as the kernel's int32, an entry outside [0, bound) as -1
    (dropped) so that no wider value wraps into range."""
    if idx.dtype == torch.int32:
        return idx
    idx = idx.to(torch.int64)
    return torch.where((idx >= 0) & (idx < bound), idx, -1).to(torch.int32)


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
    (M,) any (R, W) table whose row ``src_row[m]`` is entry m's payload;
    ``mask`` (M,) bool drops inactive entries. With ``out`` (n_rows, W) the
    rows are ORed into it in place (no zero fill). On a CUDA tensor this
    launches the ``scatter_or`` kernel; ``plain=True`` or a CPU tensor takes
    its plain torch version."""
    dst = _int32_index(dst, n_rows)
    if src_row is not None:
        src_row = _int32_index(src_row, payload.shape[0])
    if out is None:
        out = torch.zeros((n_rows, payload.shape[1]), dtype=torch.int32,
                          device=payload.device)
    return kernels.scatter_or(
        payload, dst.contiguous(), src_row=None if src_row is None else src_row.contiguous(),
        mask=None if mask is None else mask.contiguous(), out=out, plain=plain,
    )
