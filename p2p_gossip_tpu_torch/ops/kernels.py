"""The port's hand-written CUDA kernels, each beside its plain torch version
— the counterpart of the JAX package's ``ops/pallas_kernels.py``.

| kernel              | replaces (JAX package)                                  |
|---------------------|---------------------------------------------------------|
| `gather_or`         | ops/ell.py gather_or_frontier / propagate (XLA gather)   |
| `sector_occupancy`  | none: the gather's companion pass over each new slot    |
| `popcount_rows`     | ops/pallas_kernels.py popcount_rows_pallas              |
| `tick_update`       | none: engine/sync.py apply_tick_updates, which XLA      |
|                     | fused (the port's torch passes over (N, W) planes)      |
| `coverage_per_slot` | ops/pallas_kernels.py coverage_per_slot_pallas          |
| `scatter_or`        | ops/segment.py scatter_or / scatter_or_bits (XLA) and   |
|                     | the protocols' round OR (models/protocols.py:160)       |
| `tick_digest`       | telemetry/digest.py tick_digest (XLA XOR fold)          |
| `compress_deltas`   | parallel/exchange.py compress_deltas (XLA cumsum ranks  |
|                     | and scatters into capacity + 1 buffers)                 |
| `scatter_deltas`    | parallel/exchange.py scatter_deltas (XLA scatter-set)   |
| `or_fold`           | parallel/protocols_sharded.py _reduce_scatter_or (XLA   |
|                     | OR reduce of the all_to_all's stack)                    |

Dispatch: a tensor on the CPU goes to the plain version; a CUDA tensor
launches the kernel (csrc/gossip_kernels.cu, built and bound by
`ops.build`), and a failed build or launch raises. ``plain=True`` asks for
the plain version on any device — the comparison runs of the kernels use
it; nothing falls back to it.

``launches`` counts kernel launches per kernel (one per launch, and only
there), so a run can show which kernels its main path went through.

Bitmasks are torch.int32 tensors holding the uint32 bit pattern (torch's
uint32 lacks shifts on the CPU). ``>>`` on int32 sign-extends, so every
bit extraction below is written ``(x >> b) & 1``.
"""

from __future__ import annotations

import ctypes

import torch

from p2p_gossip_tpu_torch.models.linkloss import drop_mask_torch

WORD_BITS = 32

launches = {
    "gather_or": 0, "sector_occupancy": 0, "popcount_rows": 0, "coverage_per_slot": 0,
    "scatter_or": 0, "tick_digest": 0,
    "compress_deltas": 0, "scatter_deltas": 0, "or_fold": 0, "tick_update": 0,
}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _use_kernel(t: torch.Tensor, plain: bool) -> bool:
    if plain or t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"no kernel for device {t.device}")
    return True


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _int32_matrix(t: torch.Tensor, name: str) -> None:
    _require(t.dtype == torch.int32, f"{name} must be int32, got {t.dtype}")
    _require(t.dim() == 2, f"{name} must be 2-D, got shape {tuple(t.shape)}")
    _require(t.stride(1) == 1 or t.shape[1] <= 1, f"{name} rows must be contiguous")


def _launch(name: str, fn, *args) -> None:
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
    launches[name] += 1


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _lib():
    from p2p_gossip_tpu_torch.ops.build import load_library

    return load_library()


# --- popcount_rows ----------------------------------------------------------

def popcount_rows_plain(words: torch.Tensor) -> torch.Tensor:
    """SWAR popcount per word in int64 (no sign or overflow hazards), summed
    per row: (N, W) int32 -> (N,) int32."""
    x = words.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = ((x * 0x01010101) >> 24) & 0xFF
    return x.sum(dim=-1).to(torch.int32)


def popcount_rows(
    words: torch.Tensor, *, out: torch.Tensor | None = None, plain: bool = False
) -> torch.Tensor:
    """Per-row set-bit count: (N, W) int32 bitmask -> (N,) int32, written
    into ``out`` when given."""
    n, w = words.shape
    if out is None:
        out = torch.empty((n,), dtype=torch.int32, device=words.device)
    _require(out.shape == (n,) and out.dtype == torch.int32, "out must be (N,) int32")
    if not _use_kernel(words, plain):
        return out.copy_(popcount_rows_plain(words))
    _int32_matrix(words, "words")
    _require(out.device == words.device and out.is_contiguous(),
             "out must be contiguous on the words' device")
    if not (n and w):
        return out.zero_()
    _launch(
        "popcount_rows", _lib().gossip_popcount_rows,
        words.data_ptr(), n, w, words.stride(0), out.data_ptr(),
        _stream(words.device),
    )
    return out


# --- tick_update ------------------------------------------------------------

def tick_update_plain(seen, arrivals, rows, slots, active, gen_cnt, received, sent, degree,
                      frontier, out):
    """The tick's update as torch passes over (N, W) planes: the generation
    events scattered into a fresh plane (`ops.bitmask.slot_scatter`),
    ``newly = arrivals & ~seen`` and its popcount, the ORs into ``seen``
    and the frontier, then the counters. Returns (newly_out, newly_cnt)."""
    from p2p_gossip_tpu_torch.ops import bitmask

    n, w = seen.shape
    gen_bits = bitmask.slot_scatter(n, w, rows, slots, active)
    newly = arrivals & ~seen
    newly_cnt = popcount_rows_plain(newly)
    seen |= arrivals
    seen |= gen_bits
    if frontier:
        newly_out = torch.bitwise_or(newly, gen_bits, out=out)
    else:
        newly_out = newly if out is None else out.copy_(newly)
    received += newly_cnt
    sent += (newly_cnt + gen_cnt) * degree
    return newly_out, newly_cnt


def tick_update(
    seen: torch.Tensor,
    arrivals: torch.Tensor,
    rows: torch.Tensor,
    slots: torch.Tensor,
    active: torch.Tensor,
    gen_cnt: torch.Tensor,
    received: torch.Tensor,
    sent: torch.Tensor,
    degree: torch.Tensor,
    *,
    frontier: bool = True,
    out: torch.Tensor | None = None,
    plain: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One tick's update of the flood state, in place:

        newly = arrivals & ~seen;  seen |= arrivals | G;  out = newly | G
        received += popcount(newly);  sent += (popcount(newly) + gen_cnt) * degree

    per row, G the tick's generation bits: event e sets bit ``slots[e]``
    (word ``slots[e] // 32``) of row ``rows[e]`` where ``active[e]``; rows
    outside ``[0, N)`` are dropped. ``frontier`` False (before the connect
    tick) leaves G out of ``out``. ``seen``, ``arrivals`` and ``out`` (N, W)
    int32, ``rows`` and ``slots`` (S,) int64 with slots in ``[0, 32 W)``,
    ``active`` (S,) bool, ``gen_cnt``, ``received``, ``sent`` and
    ``degree`` (N,) int32; the counters wrap as int32. Returns ``out`` (a
    fresh tensor when None) and the (N,) int32 popcount of ``newly``.

    On the card one call is two launches, counted once: the row pass and
    the events' ORs, with no host read of how many events fire."""
    _require(seen.dim() == 2 and arrivals.shape == seen.shape,
             "seen and arrivals must be (N, W) alike")
    n, w = seen.shape
    _require(max(n, rows.shape[0]) < 2**31, "more than 2^31 - 1 rows or events")
    _require(out is None or out.shape == seen.shape, "out must be shaped like seen")
    _require(rows.dim() == 1 and slots.shape == rows.shape and active.shape == rows.shape,
             "rows, slots and active must be (S,) alike")
    _require(active.dtype == torch.bool, f"active must be bool, got {active.dtype}")
    for name, t in (("gen_cnt", gen_cnt), ("received", received), ("sent", sent),
                    ("degree", degree)):
        _require(t.shape == (n,), f"{name} must be (N,)")
    if not _use_kernel(seen, plain):
        return tick_update_plain(seen, arrivals, rows, slots, active, gen_cnt, received,
                                 sent, degree, frontier, out)
    if out is None:
        out = torch.empty_like(seen)
    tensors = [("seen", seen, torch.int32), ("arrivals", arrivals, torch.int32),
               ("out", out, torch.int32), ("rows", rows, torch.int64),
               ("slots", slots, torch.int64), ("active", active, torch.bool)]
    tensors += [(name, t, torch.int32) for name, t in (
        ("gen_cnt", gen_cnt), ("received", received), ("sent", sent), ("degree", degree))]
    for name, t, dtype in tensors:
        _require(t.dtype == dtype, f"{name} must be {dtype}, got {t.dtype}")
        _require(t.device == seen.device, f"{name} is on {t.device}, not {seen.device}")
        _require(t.is_contiguous(), f"{name} must be contiguous")
    _require(out.data_ptr() not in (seen.data_ptr(), arrivals.data_ptr()),
             "out must not alias seen or arrivals")
    newly_cnt = torch.empty((n,), dtype=torch.int32, device=seen.device)
    if not (n and w):
        return out, newly_cnt.zero_()
    _launch(
        "tick_update", _lib().gossip_tick_update,
        seen.data_ptr(), arrivals.data_ptr(), out.data_ptr(), n, w,
        gen_cnt.data_ptr(), degree.data_ptr(), received.data_ptr(), sent.data_ptr(),
        newly_cnt.data_ptr(), rows.data_ptr(), slots.data_ptr(), active.data_ptr(),
        rows.shape[0], int(frontier), _stream(seen.device),
    )
    return out, newly_cnt


# --- coverage_per_slot ------------------------------------------------------

def coverage_per_slot_plain(words: torch.Tensor, n_slots: int) -> torch.Tensor:
    """32 per-bit column sums: (..., N, W) int32 -> (..., n_slots) int32,
    slot s = word s // 32, bit s % 32."""
    w = words.shape[-1]
    counts = torch.stack(
        [((words >> b) & 1).sum(dim=-2, dtype=torch.int32) for b in range(WORD_BITS)],
        dim=-1,
    )  # (..., W, 32)
    return counts.reshape(*words.shape[:-2], w * WORD_BITS)[..., :n_slots].contiguous()


def coverage_per_slot(
    words: torch.Tensor, n_slots: int, *, plain: bool = False
) -> torch.Tensor:
    """Per-share coverage counts: (N, W) int32 bitmask -> (n_slots,) int32,
    or B replicas' (B, N, W) -> (B, n_slots) in one launch. ``words`` may
    be a column slice (row stride > W) of a wider bitmask, and the
    replicas any view whose rows are contiguous."""
    _require(0 <= n_slots <= words.shape[-1] * WORD_BITS, "n_slots out of range")
    if not _use_kernel(words, plain):
        return coverage_per_slot_plain(words, n_slots)
    _require(words.dim() in (2, 3), "words must be (N, W) or (B, N, W)")
    stacked = words if words.dim() == 3 else words.unsqueeze(0)
    _int32_matrix(stacked[0], "words")
    b, n, w = stacked.shape
    out = torch.zeros((b, n_slots), dtype=torch.int32, device=words.device)
    if b and n and w and n_slots:
        _launch(
            "coverage_per_slot", _lib().gossip_coverage_per_slot,
            stacked.data_ptr(), n, w, stacked.stride(1), b, stacked.stride(0),
            n_slots, out.data_ptr(), _stream(words.device),
        )
    return out if words.dim() == 3 else out[0]


# --- sector_occupancy -------------------------------------------------------

def sector_words(w: int) -> int:
    """Words per occupancy sector of a W-word row: 8 (one 32-byte L2
    sector) while W <= 256, doubled until the row has at most 32 sectors —
    so a row's occupancy is always one int32 word. The CUDA source computes
    the same (``sector_words`` in csrc/gossip_kernels.cu)."""
    sw = 8
    while sw * WORD_BITS < w:
        sw *= 2
    return sw


def sector_occupancy_plain(words: torch.Tensor) -> torch.Tensor:
    """Bit s of row r's word is set iff sector s of row r (words
    ``s*sw .. s*sw + sw - 1``, ``sw = sector_words(W)``) holds a nonzero
    word: (N, W) int32 -> (N,) int32."""
    n, w = words.shape
    sw = sector_words(w)
    nsec = -(-w // sw)
    padded = words.new_zeros((n, nsec * sw))
    padded[:, :w] = words
    nonzero = (padded.reshape(n, nsec, sw) != 0).any(dim=-1)
    weight = 2 ** torch.arange(nsec, dtype=torch.int64, device=words.device)
    bits = (nonzero.to(torch.int64) * weight).sum(dim=-1)
    return torch.where(bits >= 2**31, bits - 2**32, bits).to(torch.int32)  # uint32 bits


def sector_occupancy(
    words: torch.Tensor, *, out: torch.Tensor | None = None, plain: bool = False
) -> torch.Tensor:
    """Per-row sector occupancy of a frontier slot, (N, W) int32 -> (N,)
    int32, written into ``out`` when given. The engine keeps one such word
    per row of its frontier ring, and `gather_or` reads only the sectors it
    marks."""
    n, w = words.shape
    if out is None:
        out = torch.empty((n,), dtype=torch.int32, device=words.device)
    _require(out.shape == (n,) and out.dtype == torch.int32, "out must be (N,) int32")
    if not _use_kernel(words, plain):
        return out.copy_(sector_occupancy_plain(words))
    _int32_matrix(words, "words")
    _require(out.device == words.device and out.is_contiguous(),
             "out must be contiguous on the words' device")
    if n:
        _launch(
            "sector_occupancy", _lib().gossip_sector_occupancy,
            words.data_ptr(), n, w, words.stride(0), out.data_ptr(),
            _stream(words.device),
        )
    return out


# --- gather_or --------------------------------------------------------------

def gather_or_plain(
    hist, tick, idx, mask, delay, uniform_slot, rows, out, occ=None, loss=None, up=None,
    replicas: int = 1, id_offset: int = 0, seen=None,
):
    """A masked ``|=`` over the degree columns, then a write into node
    order that drops rows outside ``[0, len(out))``. The mask (with the
    loss coin's drops cleared from it) is applied as an AND with all-ones
    (kept) or zero words, ``occ`` (when given) as an AND with each gathered
    row's expanded sector mask — exactly what the kernel reads, so a wrong
    occupancy shows here too — and ``up`` as an AND of each destination
    row with all-ones (up) or zero (down). ``seen`` (out's rows) then
    clears what each destination has: the raw OR ``& ~seen``. ``replicas``
    stacked rings run one after the other, each on its own rows and its own
    loss seed; the coin reads destination ids plus ``id_offset``."""
    if replicas > 1:
        d, n_src, w = hist.shape[0], hist.shape[1] // replicas, hist.shape[2]
        n_out = out.shape[0] // replicas
        for r in range(replicas):
            src, dst = slice(r * n_src, (r + 1) * n_src), slice(r * n_out, (r + 1) * n_out)
            r_loss = loss
            if loss is not None and isinstance(loss[1], torch.Tensor):
                r_loss = (loss[0], loss[1][r])
            gather_or_plain(
                hist[:, src], tick, idx, mask, delay, uniform_slot, rows, out[dst],
                None if occ is None else occ[:, src], r_loss,
                None if up is None else up[dst], id_offset=id_offset,
                seen=None if seen is None else seen[dst],
            )
        return out
    d, n_src, w = hist.shape
    n_rows = idx.shape[0]
    dst = (torch.arange(n_rows, device=hist.device) if rows is None
           else rows.to(torch.int64))
    if loss is not None:
        mask = mask & ~drop_mask_torch(idx, dst[:, None] + id_offset, tick, *loss)
    acc = torch.zeros((n_rows, w), dtype=torch.int32, device=hist.device)
    keep = (-mask.to(torch.int32)).t().contiguous()
    if delay is None:
        src = hist[uniform_slot]
        src_occ = None if occ is None else occ[uniform_slot]
        rows_k = idx.to(torch.int64)
    else:
        src = hist.reshape(d * n_src, w)
        src_occ = None if occ is None else occ.reshape(d * n_src)
        rows_k = torch.remainder(tick - delay.to(torch.int64), d) * n_src + idx
    rows_k = rows_k.t().contiguous()
    sector = torch.arange(w, dtype=torch.int32, device=hist.device) // sector_words(w)
    for k in range(idx.shape[1]):
        words = torch.index_select(src, 0, rows_k[k]) & keep[k, :, None]
        if src_occ is not None:
            marked = (src_occ[rows_k[k]][:, None] >> sector) & 1
            words &= -marked
        acc |= words
    ok = (dst >= 0) & (dst < out.shape[0])
    if up is not None:
        live = torch.zeros_like(ok)
        live[ok] = up[dst[ok]]
        acc &= -live.to(torch.int32)[:, None]
    if seen is not None:  # rows outside [0, len(out)) are dropped below
        acc &= ~(seen if rows is None else seen[dst.clamp(0, out.shape[0] - 1)])
    if rows is None:
        out.copy_(acc)
    else:
        out[dst[ok]] = acc[ok]
    return out


def gather_or(
    hist: torch.Tensor,
    tick: int,
    idx: torch.Tensor,
    mask: torch.Tensor,
    delay: torch.Tensor | None = None,
    *,
    uniform_slot: int | None = None,
    rows: torch.Tensor | None = None,
    occ: torch.Tensor | None = None,
    loss: tuple | None = None,
    up: torch.Tensor | None = None,
    out: torch.Tensor,
    replicas: int = 1,
    id_offset: int = 0,
    seen: torch.Tensor | None = None,
    plain: bool = False,
) -> torch.Tensor:
    """ELL gather-OR over a frontier-history ring, written into ``out``:

        out[dst] = up[dst] ? OR_k (mask[r, k] && !drop(idx[r, k], dst, tick))
                                  ? hist[slot(r, k), idx[r, k]] : 0
                           : 0,       dst = rows[r] (r when rows is None)

    and, with ``seen`` ((B*N_out, W) int32, the rows of ``out``), ``out[dst]
    &= ~seen[dst]``: the flood tick's new bits before its generations. The
    kernel then reads a neighbour's 16-byte unit only while the destination
    still lacks a bit of it (none where it has the unit whole, none once
    the neighbours read so far cover it); the result is the same whichever
    neighbours it skipped.

    ``hist`` (D, N_src, W) int32; ``idx`` (R, C) int32; ``mask`` (R, C)
    bool; ``delay`` (R, C) int32 per-edge delays with slot(r, k) = (tick -
    delay[r, k]) mod D, or None with the one ``uniform_slot``; ``rows`` (R,)
    int32 destination rows (None: row r -> r, and then R == len(out)).
    ``occ`` (D, N_src) int32 is the ring's `sector_occupancy`: only the
    sectors it marks are read (an exact or over-approximating occupancy
    leaves the result unchanged); None reads every sector. ``loss`` is the
    link-loss model's (threshold, seed) pair (`models.linkloss`; ``tick``
    is the arrival tick the coin hashes), None or threshold 0 for no loss.
    ``up`` (len(out),) bool is the churn model's up mask of destinations;
    a down destination gets a zero row.

    ``replicas`` B > 1 stacks B independent rings along the rows (a
    Monte-Carlo campaign): ``hist`` (D, B*N_src, W), ``occ`` (D, B*N_src),
    ``out`` (B*N_out, W) and ``up`` (B*N_out,); replica r reads rows r*N_src
    + idx, writes rows r*N_out + dst, and its coin hashes the node ids idx
    and dst. The ELL (``idx``, ``mask``, ``delay``, ``rows``) is shared.
    The loss seed is an int for every replica, or a (B,) int32 tensor
    holding one uint32 seed a replica on ``hist``'s device. One launch
    covers the B replicas.

    ``id_offset`` is added to every destination node id the coin hashes: a
    node shard of the sharded engine gathers its local rows (``dst`` local)
    and passes its first row's global id, so its coins are the
    single-device engine's. Returns ``out``."""
    _require(hist.dim() == 3, "hist must be (D, N, W)")
    _require(replicas >= 1 and hist.shape[1] % replicas == 0
             and out.shape[0] % replicas == 0,
             "hist and out rows must split into the replicas")
    _require(max(hist.shape[1], out.shape[0]) < 2**31, "more than 2^31 - 1 rows")
    d, n_src, w = hist.shape[0], hist.shape[1] // replicas, hist.shape[2]
    n_out = out.shape[0] // replicas
    _require(idx.shape == mask.shape, "idx and mask shapes differ")
    _require(delay is None or delay.shape == idx.shape, "delay shape differs")
    _require((delay is None) != (uniform_slot is None),
             "pass exactly one of delay and uniform_slot")
    _require(uniform_slot is None or 0 <= uniform_slot < d, "uniform_slot out of range")
    _require(out.dim() == 2 and out.shape[1] == w, "out must be (N_out, W)")
    _require(rows is not None or idx.shape[0] == n_out,
             "identity rows need one ELL row per output row")
    _require(occ is None or occ.shape == hist.shape[:2], "occ must be (D, N_src)")
    _require(up is None or (up.shape == (out.shape[0],) and up.dtype == torch.bool),
             "up must be (N_out,) bool")
    _require(seen is None or seen.shape == out.shape, "seen must have out's shape")
    if loss is not None and loss[0] <= 0:
        loss = None  # threshold 0: the coin never drops
    seeds = None
    if loss is not None and isinstance(loss[1], torch.Tensor):
        seeds = loss[1]
        _require(seeds.shape == (replicas,) and seeds.dtype == torch.int32,
                 "per-replica loss seeds must be (B,) int32")
    if not _use_kernel(hist, plain):
        return gather_or_plain(
            hist, tick, idx, mask, delay, uniform_slot, rows, out, occ, loss, up,
            replicas, id_offset, seen,
        )
    tensors = [("hist", hist, torch.int32), ("idx", idx, torch.int32),
               ("mask", mask, torch.bool), ("out", out, torch.int32)]
    if delay is not None:
        tensors.append(("delay", delay, torch.int32))
    if rows is not None:
        _require(rows.shape == (idx.shape[0],), "rows must be (R,)")
        tensors.append(("rows", rows, torch.int32))
    if occ is not None:
        tensors.append(("occ", occ, torch.int32))
    if up is not None:
        tensors.append(("up", up, torch.bool))
    if seeds is not None:
        tensors.append(("loss seeds", seeds, torch.int32))
    if seen is not None:
        tensors.append(("seen", seen, torch.int32))
    for name, t, dtype in tensors:
        _require(t.dtype == dtype, f"{name} must be {dtype}, got {t.dtype}")
        _require(t.device == hist.device, f"{name} is on {t.device}, not {hist.device}")
        _require(t.is_contiguous(), f"{name} must be contiguous")
    loss_seed = loss_limit = 0
    if loss is not None:
        threshold, seed = loss
        if seeds is None:
            loss_seed = int(seed) & 0xFFFFFFFF
        loss_limit = min(int(threshold), 1 << 32) - 1
    n_rows, cap = idx.shape
    if n_rows and w:
        _launch(
            "gather_or", _lib().gossip_gather_or,
            hist.data_ptr(), None if occ is None else occ.data_ptr(),
            n_src, w, d, int(tick),
            -1 if uniform_slot is None else int(uniform_slot),
            idx.data_ptr(), mask.data_ptr(),
            None if delay is None else delay.data_ptr(),
            n_rows, cap, None if rows is None else rows.data_ptr(),
            n_out, None if up is None else up.data_ptr(),
            int(loss is not None), loss_seed, loss_limit,
            None if seeds is None else seeds.data_ptr(), replicas, int(id_offset),
            None if seen is None else seen.data_ptr(),
            out.data_ptr(), _stream(hist.device),
        )
    return out


# --- scatter_or -------------------------------------------------------------

def scatter_or_plan(
    dst: torch.Tensor,
    src_row: torch.Tensor | None,
    mask: torch.Tensor | None,
    n_out: int,
    n_src: int,
    *,
    key_offset: torch.Tensor | None = None,
    rounds: int = 1,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The transpose of a scatter: unsorted entries ``m`` (``dst[m]`` gets
    source row ``src_row[m]``, row m when ``src_row`` is None) into the
    destination-sorted ``(offsets, entries)`` that `scatter_or` reads.

    Masked entries, destinations outside ``[0, n_out)`` and source rows
    outside ``[0, n_src)`` are dropped. The kept entries are stable-sorted
    by key ``dst`` — or, with ``key_offset`` (M,) holding each entry's
    round ``i < rounds`` times ``n_out``, by ``i * n_out + dst``, so one
    call plans a block of rounds and round i reads the slice
    ``offsets[i * n_out : (i + 1) * n_out + 1]``. ``offsets``
    (rounds * n_out + 1,) int32 gives each key's run in ``entries`` (M,)
    int32 (dropped entries sit past ``offsets[-1]``). Index bookkeeping in
    torch (a sort and a binary search, no host sync); the OR of the words
    is the kernel."""
    _require(dst.dim() == 1, "dst must be (M,)")
    m = dst.shape[0]
    _require(m < 2**31, "more than 2^31 - 1 entries: int32 offsets would wrap")
    _require(src_row is None or src_row.shape == (m,), "src_row must be (M,)")
    _require(mask is None or (mask.shape == (m,) and mask.dtype == torch.bool),
             "mask must be (M,) bool")
    _require(key_offset is None or key_offset.shape == (m,), "key_offset must be (M,)")
    n_keys = rounds * n_out
    key_dtype = torch.int32 if n_keys < 2**31 - 1 else torch.int64
    d = dst.to(torch.int64)
    s = (torch.arange(m, device=dst.device) if src_row is None
         else src_row.to(torch.int64))
    keep = (d >= 0) & (d < n_out) & (s >= 0) & (s < n_src)
    if mask is not None:
        keep &= mask
    key = d if key_offset is None else d + key_offset
    key = torch.where(keep, key, n_keys).to(key_dtype)  # dropped: past every key
    key, order = torch.sort(key, stable=True)
    entries = torch.where(keep, s, -1)[order].to(torch.int32)
    bounds = torch.arange(n_keys + 1, dtype=key_dtype, device=dst.device)
    offsets = torch.searchsorted(key, bounds, out_int32=True)
    return offsets, entries


def scatter_or_plain(src, offsets, entries, pull_row, base, andnot, out):
    """Exact and small in memory: the base (or zeros), the pulled rows,
    then for each rank r the r-th entry of every destination run longer
    than r — the rows of one rank are distinct, so a plain indexed ``|=``
    is safe. (The JAX package's bit-unpack form would build an (M, W, 32)
    tensor.) Reads ``base`` before it writes ``out``, which may be it."""
    n_src, w = src.shape
    n_out = out.shape[0]
    if base is None or andnot:
        acc = torch.zeros((n_out, w), dtype=torch.int32, device=src.device)
    else:
        acc = base.clone()
    if pull_row is not None and n_src:
        p = pull_row.to(torch.int64)
        ok = (p >= 0) & (p < n_src)
        acc |= torch.index_select(src, 0, torch.where(ok, p, 0)) & -ok.to(torch.int32)[:, None]
    if offsets is not None and n_out:
        start = offsets[:-1].to(torch.int64)
        count = offsets[1:].to(torch.int64) - start
        for r in range(int(count.max())):
            rows = torch.nonzero(count > r).squeeze(1)
            s = entries[start[rows] + r].to(torch.int64)
            ok = (s >= 0) & (s < n_src)
            rows, s = rows[ok], s[ok]
            acc[rows] = acc[rows] | torch.index_select(src, 0, s)
    if andnot:
        acc &= ~base
    return out.copy_(acc)


def scatter_or(
    src: torch.Tensor,
    offsets: torch.Tensor | None,
    entries: torch.Tensor | None,
    *,
    pull_row: torch.Tensor | None = None,
    base: torch.Tensor | None = None,
    andnot: bool = False,
    out: torch.Tensor,
    plain: bool = False,
) -> torch.Tensor:
    """Destination-owned scatter-OR of table rows, written into ``out``:

        acc    = base[d] (zeros when base is None or andnot)
               | src[pull_row[d]]                 (0 <= pull_row[d] < R)
               | OR_{offsets[d] <= e < offsets[d+1]} src[entries[e]]
        out[d] = andnot ? acc & ~base[d] : acc

    ``src`` (R, W) int32 — for the protocols the flattened (D*N, W)
    history ring; ``offsets`` (N + 1,) int32 and ``entries`` int32 from
    `scatter_or_plan` (both None: no entries); ``pull_row`` (N,) int32
    (-1 or out of range: nothing pulled); ``base`` (N, W) int32, which may
    be ``out`` itself (in place: ``out |= ...``). Every row of ``out``
    (N, W) int32 is written. Entries outside ``[0, R)`` are dropped.
    Precondition: no entry and no pull row reads a row of ``out`` (src may
    hold ``out``, as the ring holds its slot t). Returns ``out``."""
    _require(src.dim() == 2 and out.dim() == 2 and src.shape[1] == out.shape[1],
             "src and out must be (R, W) and (N, W)")
    n_src, w = src.shape
    n_out = out.shape[0]
    _require((offsets is None) == (entries is None), "pass both offsets and entries, or neither")
    _require(offsets is None or (offsets.dim() == 1 and offsets.shape[0] == n_out + 1),
             "offsets must be (N + 1,)")
    _require(entries is None or entries.dim() == 1, "entries must be 1-D")
    _require(pull_row is None or pull_row.shape == (n_out,), "pull_row must be (N,)")
    _require(base is None or base.shape == out.shape, "base must be shaped like out")
    _require(not andnot or base is not None, "andnot needs a base")
    if not _use_kernel(src, plain):
        return scatter_or_plain(src, offsets, entries, pull_row, base, andnot, out)
    tensors = [("src", src), ("out", out)]
    for name, t in (("offsets", offsets), ("entries", entries), ("pull_row", pull_row),
                    ("base", base)):
        if t is not None:
            tensors.append((name, t))
    for name, t in tensors:
        _require(t.dtype == torch.int32, f"{name} must be int32, got {t.dtype}")
        _require(t.device == src.device, f"{name} is on {t.device}, not {src.device}")
        _require(t.is_contiguous(), f"{name} must be contiguous")

    def ptr(t):
        return None if t is None else t.data_ptr()

    if n_out and w:
        _launch(
            "scatter_or", _lib().gossip_scatter_or,
            src.data_ptr(), n_src, w, ptr(offsets), ptr(entries), ptr(pull_row),
            ptr(base), int(andnot), n_out, out.data_ptr(), _stream(src.device),
        )
    return out


# --- tick_digest ------------------------------------------------------------

# The digest's mix (lowbias32) and lane salts, the JAX package's
# telemetry/digest.py constants; csrc/gossip_kernels.cu holds the same.
MIX_M1 = 0x21F0AAAD
MIX_M2 = 0xD35A2D97
SALT_NODE = 0xB5297A4D
SALT_WORD = 0x68E31DA4
SALT_RECV = 0x1B56C4E9
SALT_SENT_LO = 0x7F4A7C15
SALT_SENT_HI = 0x94D049BB
_U32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, m: int) -> torch.Tensor:
    """``x * m`` mod 2^32 for int64 ``x`` in [0, 2^32): the multiplier in
    two 16-bit halves, so no product passes 2^48."""
    lo = x * (m & 0xFFFF)
    hi = ((x * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """lowbias32 on int64 values holding uint32: every shift reads a value
    masked to 32 bits, every multiply is masked back to 32 bits."""
    x = x ^ (x >> 16)
    x = _mul32(x, MIX_M1)
    x = x ^ (x >> 15)
    x = _mul32(x, MIX_M2)
    return x ^ (x >> 15)


def _xor_fold(x: torch.Tensor) -> torch.Tensor:
    """XOR of every element of an int64 tensor, as a 0-d int64, by halving:
    ``x[:h] ^ x[h:2h]`` with the odd tail carried (log2 passes, no host
    sync)."""
    x = x.reshape(-1)
    carry = torch.zeros((), dtype=torch.int64, device=x.device)
    while x.numel() > 1:
        h = x.numel() // 2
        if x.numel() % 2:
            carry = carry ^ x[2 * h]
        x = x[:h] ^ x[h:2 * h]
    return carry ^ x[0] if x.numel() else carry


def _fold_sparse(values: torch.Tensor, salt: torch.Tensor) -> torch.Tensor:
    """XOR-fold of mix(value ^ salt) over the nonzero values (int64
    holding uint32): a zero value contributes nothing."""
    return _xor_fold(torch.where(values == 0, 0, _mix32(values ^ salt)))


def tick_digest_plain(
    seen: torch.Tensor,
    received: torch.Tensor,
    sent_lo: torch.Tensor,
    sent_hi: torch.Tensor | None = None,
    replicas: int = 1,
    id_offset: int = 0,
) -> torch.Tensor:
    """The digests as a (B,) int64 tensor of values in [0, 2^32), one per
    replica of ``replicas`` B stacked along the rows: (B*N, W) int32
    ``seen`` and the (B*N,) int32 counters, each entry read as its uint32
    bit pattern, salted by node id i (row r*N + i holds node i of replica
    r), word index k and counter kind, mixed and XOR-folded (the JAX
    package's ``tick_digest``, once per replica). Node i is salted as node
    ``i + id_offset``."""
    rows, w = seen.shape
    n = rows // replicas
    dev = seen.device
    node_salt = _mul32(torch.arange(id_offset, id_offset + n, dtype=torch.int64, device=dev)
                       & _U32, SALT_NODE)
    word_salt = _mul32(torch.arange(w, dtype=torch.int64, device=dev), SALT_WORD)
    out = []
    for r in range(replicas):
        part = slice(r * n, (r + 1) * n)
        h = _fold_sparse(seen[part].to(torch.int64) & _U32,
                         word_salt[None, :] ^ node_salt[:, None])
        for values, salt in ((received, SALT_RECV), (sent_lo, SALT_SENT_LO),
                             (sent_hi, SALT_SENT_HI)):
            if values is not None:
                h = h ^ _fold_sparse(values[part].to(torch.int64) & _U32, node_salt ^ salt)
        out.append(h)
    return torch.stack(out)


def tick_digest(
    seen: torch.Tensor,
    received: torch.Tensor,
    sent_lo: torch.Tensor,
    sent_hi: torch.Tensor | None = None,
    *,
    out: torch.Tensor | None = None,
    replicas: int = 1,
    id_offset: int = 0,
    plain: bool = False,
) -> torch.Tensor:
    """XOR one tick's state digest of each of ``replicas`` B stacked
    replicas into ``out``, a (B,) int32 tensor of slots holding uint32 bit
    patterns (any stride, so a column of a (B, capacity) ring; a fresh
    zeroed one when None), and return it. One launch covers all B.

    ``seen`` (B*N, W) int32 with contiguous rows (the row stride may exceed
    W), row r*N + i holding node i of replica r; ``received``, ``sent_lo``
    and, when given, ``sent_hi`` (B*N,) int32 (an engine's int64 counter
    passes its low and high words). Replica r's digest salts node ids,
    never stacked rows, so it equals its solo run's. The engines give each
    tick its own zeroed ring slots, so ``out`` ends holding that tick's
    digests; emit them as ``v & 0xFFFFFFFF``. ``id_offset`` shifts the
    node ids (a node shard's first global row), so the XOR of every
    shard's digest is the whole state's."""
    _require(seen.dim() == 2, "seen must be (B*N, W)")
    _require(replicas >= 1 and seen.shape[0] % replicas == 0,
             f"seen's {seen.shape[0]} rows are not {replicas} replicas")
    rows = seen.shape[0]
    counters = [("received", received), ("sent_lo", sent_lo)]
    if sent_hi is not None:
        counters.append(("sent_hi", sent_hi))
    for name, t in counters:
        _require(t.shape == (rows,), f"{name} must be (B*N,)")
    if out is None:
        out = torch.zeros((replicas,), dtype=torch.int32, device=seen.device)
    _require(out.shape == (replicas,) and out.dtype == torch.int32,
             f"out must be ({replicas},) int32")
    if not _use_kernel(seen, plain):
        value = tick_digest_plain(seen, received, sent_lo, sent_hi, replicas, id_offset)
        return out.bitwise_xor_(torch.where(value >= 2**31, value - 2**32, value).to(torch.int32))
    _int32_matrix(seen, "seen")
    for name, t in counters:
        _require(t.dtype == torch.int32, f"{name} must be int32, got {t.dtype}")
        _require(t.device == seen.device, f"{name} is on {t.device}, not {seen.device}")
        _require(t.is_contiguous(), f"{name} must be contiguous")
    _require(out.device == seen.device, f"out is on {out.device}, not {seen.device}")
    if rows:
        _launch(
            "tick_digest", _lib().gossip_tick_digest,
            seen.data_ptr(), rows // replicas, seen.shape[1], seen.stride(0),
            received.data_ptr(), sent_lo.data_ptr(),
            None if sent_hi is None else sent_hi.data_ptr(), replicas, int(id_offset),
            out.data_ptr(), out.stride(0), _stream(seen.device),
        )
    return out


# --- compress_deltas / scatter_deltas ---------------------------------------

def compress_deltas_plain(changed: torch.Tensor, need: torch.Tensor, capacity: int,
                          replicas: int | None = None):
    """The JAX package's formula: each destination's candidate words
    (nonzero, row in its cut) ranked by a cumsum in flat-index order,
    scattered into (k, capacity + 1) buffers whose last slot takes every
    rank >= capacity and is cut off. ``replicas`` B: the formula on each
    replica's (n_loc, W) rows in turn, stacked to (B, k, capacity) and
    (B, k)."""
    if replicas is not None:
        n_loc = changed.shape[0] // replicas
        parts = [compress_deltas_plain(changed[b * n_loc:(b + 1) * n_loc], need, capacity)
                 for b in range(replicas)]
        return tuple(torch.stack(p) for p in zip(*parts))
    n_loc, w = changed.shape
    k = need.shape[1]
    flat = changed.reshape(-1)
    cand = (flat != 0)[None, :] & need.t().repeat_interleave(w, dim=1)
    rank = torch.cumsum(cand.to(torch.int64), dim=1) - 1
    slot = torch.where(cand & (rank < capacity), rank, capacity)
    ids = torch.arange(n_loc * w, dtype=torch.int32, device=changed.device)
    idx = torch.full((k, capacity + 1), -1, dtype=torch.int32, device=changed.device)
    val = torch.zeros((k, capacity + 1), dtype=torch.int32, device=changed.device)
    idx.scatter_(1, slot, ids.expand(k, -1))
    val.scatter_(1, slot, flat.expand(k, -1))
    counts = cand.sum(dim=1, dtype=torch.int32)
    return idx[:, :capacity].contiguous(), val[:, :capacity].contiguous(), counts


def compress_deltas(
    changed: torch.Tensor, need: torch.Tensor, capacity: int, *,
    replicas: int | None = None, plain: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pack each destination's nonzero words into a fixed-capacity buffer:
    ``changed`` (n_loc, W) int32 and ``need`` (n_loc, k) bool (row r is in
    destination d's cut) -> idx (k, capacity) int32 flat word indices in
    ascending order (-1 padding), val (k, capacity) int32 the words (0
    padding), counts (k,) int32 the true candidate counts (above capacity
    when a buffer truncated). On the card: one pass of the CUDA kernel
    over the slice (an ordered compaction with a decoupled look-back
    across tiles) that writes every slot once, then a small launch that
    writes the padding from the counts; nothing is pre-filled.

    ``replicas`` B stacks B independent slices along the rows (a campaign
    batch): ``changed`` (B*n_loc, W), the shared ``need`` (n_loc, k), and
    idx, val (B, k, capacity) and counts (B, k), replica b's indices flat
    over its own slice. The same launches cover the B replicas."""
    _require(changed.dim() == 2 and need.dim() == 2, "changed and need must be 2-D")
    _require(need.dtype == torch.bool, f"need must be bool, got {need.dtype}")
    _require(capacity >= 1, "capacity must be >= 1")
    b = 1 if replicas is None else replicas
    _require(b >= 1 and changed.shape[0] == b * need.shape[0],
             "changed must be (B*n_loc, W) over need's (n_loc, k)")
    n_loc, w = need.shape[0], changed.shape[1]
    k = need.shape[1]
    _require(n_loc * w < 2**31, "more than 2^31 - 1 words a replica: int32 indices would wrap")
    if not _use_kernel(changed, plain):
        return compress_deltas_plain(changed, need, capacity, replicas)
    _int32_matrix(changed, "changed")
    _require(1 <= k <= 32, f"the kernel takes 1..32 destinations, got {k}")
    for name, t in (("changed", changed), ("need", need)):
        _require(t.device == changed.device and t.is_contiguous(),
                 f"{name} must be contiguous on the changed words' device")
    dev = changed.device
    idx = torch.empty((b, k, capacity), dtype=torch.int32, device=dev)
    val = torch.empty((b, k, capacity), dtype=torch.int32, device=dev)
    counts = torch.empty((b, k), dtype=torch.int32, device=dev)
    lib = _lib()
    # The tiles' ticket and status words, zeroed by the launch.
    scratch = torch.empty((1 + b * k * lib.gossip_compress_tiles(n_loc * w),),
                          dtype=torch.int64, device=dev)
    _launch(
        "compress_deltas", lib.gossip_compress_deltas,
        changed.data_ptr(), n_loc, w, need.data_ptr(), k, int(capacity),
        scratch.data_ptr(), idx.data_ptr(), val.data_ptr(), counts.data_ptr(), b,
        _stream(dev),
    )
    if replicas is None:
        return idx[0], val[0], counts[0]
    return idx, val, counts


def scatter_deltas_plain(idx, val, n_loc, w, n_padded, out, replicas=None):
    """The JAX package's formula: source s's id i is canvas word s*n_loc*W
    + i, and -1 (or anything past the canvas) is dropped. ``replicas`` B:
    the formula on each replica's (n_srcs, capacity) buffers in turn, into
    its (n_padded, W) canvas of ``out`` (B, n_padded, W)."""
    if replicas is not None:
        for b in range(replicas):
            scatter_deltas_plain(idx[:, b], val[:, b], n_loc, w, n_padded, out[b])
        return out
    n_srcs = idx.shape[0]
    offsets = torch.arange(n_srcs, dtype=torch.int64, device=idx.device)[:, None] * (n_loc * w)
    gidx = idx.to(torch.int64) + offsets
    keep = (idx >= 0) & (gidx < n_padded * w)
    flat = out.view(-1)
    flat.zero_()
    flat[gidx[keep]] = val[keep]
    return out


def scatter_deltas(
    idx: torch.Tensor, val: torch.Tensor, n_loc: int, w: int, n_padded: int, *,
    out: torch.Tensor | None = None, replicas: int | None = None, plain: bool = False,
) -> torch.Tensor:
    """Rebuild the global (n_padded, W) int32 slice from received delta
    buffers ``idx``/``val`` (n_srcs, capacity) int32 (axis 0 = source
    shard): word ``s * n_loc * W + idx[s, e]`` gets ``val[s, e]``, -1 and
    out-of-canvas entries are dropped, every other word is zero. ``out``
    is reused when given. One launch of the CUDA kernel on the card, after
    a zero fill of the canvas.

    ``replicas`` B: ``idx``/``val`` (n_srcs, B, capacity), as an exchange
    of `compress_deltas`' (B, k, capacity) buffers leaves them, rebuilt
    into ``out`` (B, n_padded, W), replica b's canvas from its own
    entries. One launch covers the B replicas."""
    b = 1 if replicas is None else replicas
    shape = (n_padded, w) if replicas is None else (b, n_padded, w)
    _require(idx.dim() == (2 if replicas is None else 3) and val.shape == idx.shape
             and (replicas is None or idx.shape[1] == b),
             "idx and val must be (n_srcs, capacity), or (n_srcs, B, capacity)")
    if out is None:
        out = torch.empty(shape, dtype=torch.int32, device=idx.device)
    _require(out.shape == shape and out.dtype == torch.int32 and out.is_contiguous(),
             f"out must be a contiguous {shape} int32 tensor")
    if not _use_kernel(idx, plain):
        return scatter_deltas_plain(idx, val, n_loc, w, n_padded, out, replicas)
    for name, t in (("idx", idx), ("val", val), ("out", out)):
        _require(t.dtype == torch.int32, f"{name} must be int32, got {t.dtype}")
        _require(t.device == idx.device and t.is_contiguous(),
                 f"{name} must be contiguous on the idx device")
    _require(b <= 65535, "at most 65535 replicas a launch")
    out.zero_()
    if idx.numel():
        _launch(
            "scatter_deltas", _lib().gossip_scatter_deltas,
            idx.data_ptr(), val.data_ptr(), idx.shape[0], idx.shape[-1],
            n_loc * w, n_padded * w, b, out.data_ptr(), _stream(idx.device),
        )
    return out


# --- or_fold ------------------------------------------------------------------

def or_fold_plain(stack: torch.Tensor) -> torch.Tensor:
    """Slice 0 copied, then slices 1..k-1 ORed into it: (k, n, W) -> (n, W)."""
    out = stack[0].clone()
    for j in range(1, stack.shape[0]):
        out.bitwise_or_(stack[j])
    return out


def or_fold(
    stack: torch.Tensor, *, out: torch.Tensor | None = None, plain: bool = False
) -> torch.Tensor:
    """The OR of a (k, n, W) int32 stack of bitmasks over its first axis,
    ``out[r, w] = OR_j stack[j, r, w]``, written into ``out`` (n, W) when
    given (a fresh tensor otherwise) and returned: the fold of the sharded
    protocols' push, whose all_to_all leaves each node shard the k shards'
    pushes into its rows. One launch for any k >= 1 (k = 1 copies)."""
    _require(stack.dim() == 3 and stack.shape[0] >= 1, "stack must be (k >= 1, n, W)")
    k, n, w = stack.shape
    if out is None:
        out = torch.empty((n, w), dtype=torch.int32, device=stack.device)
    _require(out.shape == (n, w) and out.dtype == torch.int32, "out must be (n, W) int32")
    if not _use_kernel(stack, plain):
        return out.copy_(or_fold_plain(stack))
    _require(stack.dtype == torch.int32, f"stack must be int32, got {stack.dtype}")
    for name, t in (("stack", stack), ("out", out)):
        _require(t.device == stack.device and t.is_contiguous(),
                 f"{name} must be contiguous on the stack's device")
    if n * w:
        _launch("or_fold", _lib().gossip_or_fold, stack.data_ptr(), n * w, k, out.data_ptr(),
                _stream(stack.device))
    return out
