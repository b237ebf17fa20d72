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


# --- audit spec (staticcheck/: the op audit runs this tiny case) ------------

def _audit_spec():
    """M = 6 payload rows of W = 2 words into 8 rows (the JAX package's
    ``_audit_spec_scatter``)."""
    import numpy as np

    from p2p_gossip_tpu_torch.staticcheck import specs
    from p2p_gossip_tpu_torch.staticcheck.registry import AuditSpec

    m, w, n_rows = 6, 2, 8
    rng = np.random.default_rng(0)
    return AuditSpec(
        fn=lambda dst, payload, mask: scatter_or(n_rows, dst, payload, mask),
        args=(specs.tensor(rng.integers(0, n_rows, m), np.int32), specs.words(rng, (m, w)),
              specs.tensor(rng.random(m) < 0.8)),
        integer_only=True, bitmask_words=w, bitmask_args=(1,), bitmask_outputs=(0,),
        out_dtypes=("int32",), counterpart_outputs=(0,),
    )


from p2p_gossip_tpu_torch.staticcheck.registry import register_entry  # noqa: E402

register_entry("ops.segment.scatter_or", scatter_or, spec=_audit_spec,
               counterpart="ops.segment.scatter_or")
