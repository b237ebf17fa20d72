"""Checkpoint/resume between share chunks.

The tick engine runs shares in independent fixed-size chunks, so the
checkpoint boundary is between chunks: the accumulated per-node counters
plus the index of the next chunk determine the rest of the run (graphs and
schedules are rebuilt from their seeds on resume, never stored).

A checkpoint is one ``.npz`` holding the counter arrays, a JSON meta blob
and a **fingerprint** of everything that determines the run. A resume whose
fingerprint differs ignores the file and starts fresh. Writes are atomic
(pid-unique tmp + ``os.replace``).

The file format, the keys and the fingerprint are the JAX package's (its
``utils/checkpoint.py``): a checkpoint one package writes, the other
resumes.
"""

from __future__ import annotations

import glob
import hashlib
import json
import os
import time
import zipfile

import numpy as np

from p2p_gossip_tpu_torch.utils import logging as p2plog

log = p2plog.get_logger("Checkpoint")

_META_KEY = "__meta_json__"
_FORMAT_VERSION = 1

#: Stable-name tmps ("<path>.tmp") older than this are reclaimed as litter.
_LEGACY_TMP_MAX_AGE_S = 3600.0


def fingerprint(*parts) -> str:
    """SHA-256 over an ordered mix of arrays / scalars / strings."""
    h = hashlib.sha256()
    for part in parts:
        if part is None:
            h.update(b"\x00none")
        elif isinstance(part, np.ndarray):
            h.update(np.ascontiguousarray(part).tobytes())
            h.update(str(part.dtype).encode())
            h.update(str(part.shape).encode())
        else:
            h.update(repr(part).encode())
        h.update(b"\x1f")
    return h.hexdigest()


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    return True


def atomic_savez(path: str, **arrays) -> None:
    """Atomic npz write: pid-unique tmp + fsync + os.replace, tmp removed on
    failure. Tmps left by writers that no longer run are unlinked first."""
    for old in glob.glob(f"{glob.escape(path)}.*.tmp"):
        try:
            pid = int(old.rsplit(".", 2)[-2])
        except ValueError:
            continue
        if pid != os.getpid() and not _pid_alive(pid):
            try:
                os.unlink(old)
            except OSError:
                pass
    legacy = f"{path}.tmp"
    try:
        if time.time() - os.path.getmtime(legacy) > _LEGACY_TMP_MAX_AGE_S:
            os.unlink(legacy)
    except OSError:
        pass

    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def save_checkpoint(path: str, arrays: dict[str, np.ndarray], meta: dict) -> None:
    """Atomically write ``arrays`` + ``meta`` to ``path`` (.npz)."""
    meta = dict(meta, format_version=_FORMAT_VERSION)
    atomic_savez(
        path,
        **arrays,
        **{_META_KEY: np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)},
    )
    log.debug(f"saved checkpoint to {path}: {meta}")


def load_checkpoint(path: str) -> tuple[dict[str, np.ndarray], dict] | None:
    """Read a checkpoint; None if missing or unreadable."""
    if not os.path.exists(path):
        return None
    try:
        with np.load(path) as z:
            arrays = {k: z[k] for k in z.files if k != _META_KEY}
            meta = json.loads(bytes(z[_META_KEY]).decode())
    except (
        OSError, ValueError, KeyError, json.JSONDecodeError,
        zipfile.BadZipFile,
    ) as e:
        log.warn(f"ignoring unreadable checkpoint {path}: {e}")
        return None
    if meta.get("format_version") != _FORMAT_VERSION:
        log.warn(
            f"ignoring checkpoint {path}: format version "
            f"{meta.get('format_version')} != {_FORMAT_VERSION}"
        )
        return None
    return arrays, meta


class ChunkCheckpointer:
    """Chunk-boundary checkpoints: load-and-match on construction (adding a
    matching checkpoint's counters into ``arrays`` in place, or warning on a
    fingerprint mismatch), and periodic atomic saves of ``arrays``."""

    def __init__(
        self,
        path: str,
        run_fingerprint: str,
        arrays: dict[str, np.ndarray],
        checkpoint_every: int = 1,
    ):
        if checkpoint_every < 1:
            raise ValueError(
                f"checkpoint_every must be >= 1, got {checkpoint_every}"
            )
        self.path = path
        self.fingerprint = run_fingerprint
        self.arrays = arrays
        self.checkpoint_every = checkpoint_every
        self.start_chunk = 0
        loaded = load_checkpoint(path)
        if loaded is not None:
            saved, meta = loaded
            if meta.get("fingerprint") == run_fingerprint:
                self.start_chunk = int(meta["next_chunk"])
                for name, arr in arrays.items():
                    arr += saved[name].astype(arr.dtype)
                log.info(f"resuming from {path} at chunk {self.start_chunk}")
            else:
                log.warn(
                    f"checkpoint {path} is from a different run "
                    "(fingerprint mismatch); starting fresh"
                )

    def save(self, next_chunk: int) -> None:
        save_checkpoint(
            self.path,
            self.arrays,
            {"fingerprint": self.fingerprint, "next_chunk": next_chunk},
        )

    def maybe_save(self, done_this_call: int, ci: int, last_ci: int) -> None:
        """Every ``checkpoint_every`` completed chunks this call, and always
        after the final chunk."""
        if done_this_call % self.checkpoint_every == 0 or ci == last_ci:
            self.save(ci + 1)


def checkpointed_chunks(chunks, checkpointer, stop_after_chunks=None):
    """Yield (ci, chunk) for exactly the chunks this call should run:
    skipping the chunks a resume already completed, stopping early after
    ``stop_after_chunks``, and saving after each yielded chunk returns.
    ``checkpointer`` may be None (no skip, no save)."""
    done = 0
    last = len(chunks) - 1
    for ci, chunk in enumerate(chunks):
        if checkpointer is not None and ci < checkpointer.start_chunk:
            continue
        if stop_after_chunks is not None and done >= stop_after_chunks:
            break
        yield ci, chunk
        done += 1
        if checkpointer is not None:
            checkpointer.maybe_save(done, ci, last)


def make_checkpointer(
    checkpoint_path, checkpoint_every, record_coverage, fp_parts_fn, arrays
):
    """Checkpoint set-up of the random-partner protocols: None when
    checkpointing is off; a ValueError with ``record_coverage`` (a resumed
    run would lack the skipped chunks' coverage rows); otherwise a
    ChunkCheckpointer over ``arrays`` keyed by ``fingerprint(
    *fp_parts_fn())``. ``fp_parts_fn`` is a thunk, so the O(edges) parts are
    built only when a checkpoint is asked for."""
    if checkpoint_path is None:
        return None
    if record_coverage:
        raise ValueError(
            "checkpointing is not combinable with record_coverage (a "
            "resumed run would be missing the skipped chunks' coverage)"
        )
    return ChunkCheckpointer(
        checkpoint_path, fingerprint(*fp_parts_fn()), arrays, checkpoint_every
    )
