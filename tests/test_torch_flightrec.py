"""The port's flight recorder against the JAX package's: the per-tick
digest (the ``tick_digest`` kernel's plain version, which the CPU runs,
against the JAX package's XLA fold and its numpy twin, bitwise), the
saturating ``u32sum``, digest-stream alignment across the two packages,
progress beats and the heartbeat file.

The CUDA kernel itself runs only on the card: chip_smoke.py holds it
against ``tick_digest_plain`` there, on ragged shapes and at the main
path's size."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import p2p_gossip_tpu as pg
import p2p_gossip_tpu_torch as pt
from p2p_gossip_tpu import telemetry as jax_tel
from p2p_gossip_tpu.engine.sync import run_sync_sim as jax_sync_sim
from p2p_gossip_tpu.ops import bitmask as jax_bitmask
from p2p_gossip_tpu.telemetry import digest as jax_digest
from p2p_gossip_tpu.telemetry import rings as jax_rings
from p2p_gossip_tpu_torch import telemetry
from p2p_gossip_tpu_torch.engine.sync import run_sync_sim
from p2p_gossip_tpu_torch.ops import kernels
from p2p_gossip_tpu_torch.telemetry import compare, digest, progress, rings


@pytest.fixture(autouse=True)
def _clean_telemetry(monkeypatch):
    monkeypatch.delenv("P2P_TELEMETRY", raising=False)
    monkeypatch.delenv("P2P_HEARTBEAT", raising=False)
    for tel in (telemetry, jax_tel):
        tel.reset()
        tel.configure_heartbeat(None)
    yield
    for tel in (telemetry, jax_tel):
        tel.reset()
        tel.configure_heartbeat(None)


def _state(rng, n, w, zero_share=0.3):
    """Random uint32 words (bit 31 set in about half) with some zeros, and
    int32 counters spanning the whole range (negative bit patterns too)."""
    seen = rng.integers(0, 2**32, (n, w), dtype=np.uint32)
    seen[rng.random((n, w)) < zero_share] = 0
    received = rng.integers(-2**31, 2**31, n).astype(np.int32)
    received[rng.random(n) < zero_share] = 0
    sent_lo = rng.integers(-2**31, 2**31, n).astype(np.int32)
    sent_hi = rng.integers(0, 7, n).astype(np.int32)
    return seen, received, sent_lo, sent_hi


def _port_digest(seen, received, sent_lo, sent_hi=None) -> int:
    got = kernels.tick_digest(
        torch.as_tensor(seen.view(np.int32)), torch.as_tensor(received),
        torch.as_tensor(sent_lo), None if sent_hi is None else torch.as_tensor(sent_hi),
    )
    assert got.shape == (1,) and got.dtype == torch.int32
    return int(got[0]) & 0xFFFFFFFF


def _jax_digest(seen, received, sent_lo, sent_hi=None) -> int:
    return int(jax_digest.tick_digest(
        jnp.asarray(seen), jnp.asarray(received), jnp.asarray(sent_lo),
        None if sent_hi is None else jnp.asarray(sent_hi),
    ))


@pytest.mark.parametrize("shape", [(12, 3), (1, 1), (37, 5), (64, 8), (9, 0)])
@pytest.mark.parametrize("with_hi", [False, True])
def test_digest_equals_the_jax_fold_and_numpy_twin(shape, with_hi):
    rng = np.random.default_rng(shape[0] * 10 + shape[1])
    seen, received, sent_lo, sent_hi = _state(rng, *shape)
    hi = sent_hi if with_hi else None
    want = _jax_digest(seen, received, sent_lo, hi)
    assert want == jax_digest.tick_digest_np(seen, received, sent_lo, hi)
    assert digest.tick_digest_np(seen, received, sent_lo, hi) == want
    assert _port_digest(seen, received, sent_lo, hi) == want
    plain = kernels.tick_digest_plain(
        torch.as_tensor(seen.view(np.int32)), torch.as_tensor(received),
        torch.as_tensor(sent_lo), None if hi is None else torch.as_tensor(hi))
    assert plain.dtype == torch.int64 and int(plain) == want


def test_digest_of_words_with_bit_31_set():
    """Every word negative as int32: the mix reads the uint32 value."""
    rng = np.random.default_rng(31)
    seen = rng.integers(2**31, 2**32, (20, 4), dtype=np.uint32)
    received = np.full(20, -1, dtype=np.int32)
    sent = np.full(20, -(2**31), dtype=np.int32)
    want = _jax_digest(seen, received, sent)
    assert want != 0
    assert _port_digest(seen, received, sent) == want


def test_digest_pad_width_invariance():
    """Zero pad words and zero pad rows leave the digest unchanged, and an
    all-zero sent_hi folds like an absent one."""
    rng = np.random.default_rng(3)
    seen, received, sent_lo, _ = _state(rng, 8, 2)
    base = _port_digest(seen, received, sent_lo)
    wide = np.concatenate([seen, np.zeros((8, 5), dtype=np.uint32)], axis=1)
    assert _port_digest(wide, received, sent_lo) == base
    pad_rows = np.zeros((4, 2), dtype=np.uint32)
    pad_cnt = np.zeros(4, dtype=np.int32)
    assert _port_digest(np.concatenate([seen, pad_rows]),
                        np.concatenate([received, pad_cnt]),
                        np.concatenate([sent_lo, pad_cnt])) == base
    assert _port_digest(seen, received, sent_lo, np.zeros(8, dtype=np.int32)) == base
    assert base == _jax_digest(seen, received, sent_lo)


def test_digest_all_zero_state_is_zero():
    z = np.zeros((6, 2), dtype=np.uint32)
    zi = np.zeros(6, dtype=np.int32)
    assert _port_digest(z, zi, zi) == _port_digest(z, zi, zi, zi) == 0


def test_digest_xors_into_its_slot_and_reads_a_column_slice():
    """The wrapper XORs into the slot it is given (the engines' zeroed ring
    slots), and reads a column slice (row stride > W) as its own words."""
    rng = np.random.default_rng(5)
    seen, received, sent_lo, _ = _state(rng, 10, 6)
    want = _jax_digest(seen[:, :4], received, sent_lo)
    ring = digest.init(3, "cpu")
    digest.write(ring, 1, torch.as_tensor(seen.view(np.int32))[:, :4],
                 torch.as_tensor(received), torch.as_tensor(sent_lo))
    assert int(ring[0]) == int(ring[2]) == 0
    assert int(ring[1]) & 0xFFFFFFFF == want
    slot = torch.full((1,), 0x1234, dtype=torch.int32)
    kernels.tick_digest(torch.as_tensor(seen.view(np.int32))[:, :4],
                        torch.as_tensor(received), torch.as_tensor(sent_lo), out=slot)
    assert int(slot[0]) & 0xFFFFFFFF == want ^ 0x1234


def test_digest_dispatch_and_argument_checks():
    """On the CPU the wrapper takes the plain version and counts no launch;
    a tensor on neither the CPU nor CUDA raises, nothing falls back."""
    kernels.reset_launches()
    seen = torch.ones((4, 2), dtype=torch.int32)
    cnt = torch.zeros(4, dtype=torch.int32)
    kernels.tick_digest(seen, cnt, cnt)
    assert kernels.launches["tick_digest"] == 0
    with pytest.raises(ValueError):
        kernels.tick_digest(seen, cnt[:3], cnt)
    with pytest.raises(ValueError):
        kernels.tick_digest(seen, cnt, cnt, out=torch.zeros(2, dtype=torch.int32))
    meta = torch.empty((4, 2), dtype=torch.int32, device="meta")
    meta_cnt = torch.empty(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        kernels.tick_digest(meta, meta_cnt, meta_cnt)


def test_digest_constants_are_the_jax_packages():
    for name in ("MIX_M1", "MIX_M2", "SALT_NODE", "SALT_WORD", "SALT_RECV",
                 "SALT_SENT_LO", "SALT_SENT_HI"):
        assert getattr(digest, name) == getattr(jax_digest, name), name


def test_split_u64_is_the_jax_pair():
    sent = torch.tensor([0, 5, 2**31, 2**32 - 1, 2**32, 3 * 2**32 + 7, 2**40 + 2**31],
                        dtype=torch.int64)
    lo, hi = digest.split_u64(sent)
    assert lo.dtype == hi.dtype == torch.int32
    back = jax_bitmask.combine_u64(lo.numpy().view(np.uint32), hi.numpy().view(np.uint32))
    np.testing.assert_array_equal(back, sent.numpy())


def test_pack_seen_np_is_the_jax_packages():
    rng = np.random.default_rng(2)
    member = rng.random((7, 70)) < 0.4
    np.testing.assert_array_equal(digest.pack_seen_np(member, 3),
                                  jax_digest.pack_seen_np(member, 3))


# --- u32sum ------------------------------------------------------------------------

def test_u32sum_saturates_as_the_jax_limb_sum():
    cases = [
        [3, 5, 7],
        [rings.U32_MAX] * 3,
        [rings.U32_MAX - 1, 1],
        [rings.U32_MAX - 1, 2],
        [2**31, 2**31 - 1],
        [2**31, 2**31],
        list(range(1000)),
    ]
    for values in cases:
        want = int(jax_rings.u32sum(jnp.asarray(values, dtype=jnp.uint32)))
        as_int32 = torch.tensor(np.asarray(values, dtype=np.uint32).view(np.int32))
        assert int(rings.u32sum(as_int32)) == want, values
        assert int(rings.u32sum(torch.tensor(values, dtype=torch.int64))) == want
    assert int(rings.u32sum(torch.tensor([True, False, True]))) == 2


def test_total_bits_counts_every_bit():
    rng = np.random.default_rng(4)
    words = rng.integers(0, 2**32, (5, 3, 4), dtype=np.uint32)
    want = int(jax_rings.total_bits(jnp.asarray(words)))
    assert int(rings.total_bits(torch.as_tensor(words.view(np.int32)))) == want


# --- stream alignment across the two packages ----------------------------------------

def _flood_streams():
    """The digest streams of one multi-chunk flood in each package."""
    g, gt = pg.erdos_renyi(48, 0.15, seed=0), pt.erdos_renyi(48, 0.15, seed=0)
    rng = np.random.default_rng(1)
    origins = rng.integers(0, 48, 40).astype(np.int32)
    ticks = rng.integers(0, 10, 40).astype(np.int32)
    jax_tel.configure(None, rings=True)
    telemetry.configure(None, rings=True)
    jax_sync_sim(g, pg.Schedule(48, origins, ticks), 30, chunk_size=32)
    run_sync_sim(gt, pt.Schedule(48, origins, ticks), 30, chunk_size=32, device="cpu")
    return (compare.digest_streams(jax_tel.events()),
            compare.digest_streams(telemetry.events()))


def test_streams_of_the_two_packages_align_tick_for_tick():
    want, got = _flood_streams()
    assert sorted(got) == sorted(want)
    assert len(got) == 2  # one stream per chunk
    for chunk in (0, 1):
        a = compare.select_stream(want, "run_sync_sim", chunk=chunk)
        b = compare.select_stream(got, "run_sync_sim", chunk=chunk)
        div = compare.first_divergence(a, b)
        assert not div.diverged and div.compared == len(a) > 0
        tick = sorted(b)[len(b) // 2]
        faulty = compare.first_divergence(a, compare.inject_fault(b, tick, bit=7))
        assert faulty.diverged and faulty.tick == tick
        assert faulty.a_value ^ faulty.b_value == 1 << 7
    with pytest.raises(ValueError):
        compare.select_stream(got, "run_sync_sim")  # two chunks: ambiguous
    with pytest.raises(KeyError):
        compare.select_stream(got, "models.protocols")


def test_alignment_compares_only_common_ticks():
    a = {t: t * 7 for t in range(5)}
    b = {t: t * 7 for t in range(9)}
    div = compare.first_divergence(a, b)
    assert not div.diverged and div.compared == 5 and div.only_b == 4
    with pytest.raises(ValueError):
        compare.inject_fault(a, 99)


# --- progress beats and the heartbeat ----------------------------------------------

def _small_flood():
    g = pt.erdos_renyi(48, 0.15, seed=0)
    sched = pt.Schedule(48, np.array([1, 5, 9], dtype=np.int32),
                        np.array([0, 0, 2], dtype=np.int32))
    return run_sync_sim(g, sched, 16, device="cpu")


def test_progress_events_carry_the_digest_head():
    telemetry.configure(None, rings=True)
    _small_flood()
    (beat,) = [e for e in telemetry.events() if e["type"] == "progress"]
    (dig,) = [e for e in telemetry.events() if e["type"] == "digest"]
    assert beat["kernel"] == "engine.sync.run_sync_sim" and beat["elapsed_s"] >= 0
    assert beat["digest_head"] == f"{dig['values'][-1]:08x}"
    assert beat["ticks_done"] == dig["ticks"]


def test_heartbeat_works_with_telemetry_off(tmp_path):
    hb = str(tmp_path / "hb.json")
    progress.configure_heartbeat(hb)
    _small_flood()
    data = progress.read_heartbeat(hb)
    assert data is not None and data["kernel"] == "engine.sync.run_sync_sim"
    assert "digest_head" not in data  # no digests with the rings off
    assert not telemetry.enabled()


def test_heartbeat_env_var(tmp_path, monkeypatch):
    hb = tmp_path / "env_hb.json"
    monkeypatch.setenv("P2P_HEARTBEAT", str(hb))
    monkeypatch.setattr(progress, "_heartbeat_configured", False)  # read the environment
    assert progress.heartbeat_path() == str(hb)
    _small_flood()
    assert progress.read_heartbeat(str(hb))["chunk"] == 0


def test_heartbeat_atomic_write_read_and_staleness(tmp_path):
    hb = str(tmp_path / "hb.json")
    assert progress.is_stale(hb, 10.0)  # missing = stale
    progress.write_heartbeat({"kernel": "k", "chunk": 1}, hb)
    data = progress.read_heartbeat(hb)
    assert data["kernel"] == "k" and data["chunk"] == 1 and data["pid"] == os.getpid()
    assert os.listdir(tmp_path) == ["hb.json"]  # no tmp sibling left behind
    assert not progress.is_stale(hb, 10.0)
    old = os.stat(hb).st_mtime - 120.0
    os.utime(hb, (old, old))
    assert progress.heartbeat_age_s(hb) > 100.0 and progress.is_stale(hb, 60.0)
    with open(hb, "w") as f:
        f.write('{"half": ')
    assert progress.read_heartbeat(hb) is None
