"""Streaming RDS decode + burst-error correction.

Closes the offline-only gap: the offline path (`decode_rds_soft`) buffers
the whole capture; `StreamingRdsDecoder` consumes per-block soft output
with O(1) carried state and must yield the same groups (reference's live
model: src/project.cpp:392-393 `rtl_sdr | ./project`).
"""

from __future__ import annotations

import numpy as np
import pytest

from sdr_tpu import tx
from sdr_tpu.config import MODES
from sdr_tpu.models.receiver import Receiver
from sdr_tpu.rds import tx as rds_tx
from sdr_tpu.rds import decode_rds_soft
from sdr_tpu.rds.correct import BURST_TABLE, correct_block
from sdr_tpu.rds.framing import extract_groups
from sdr_tpu.rds.matrix import SYNDROMES, encode_block, syndrome
from sdr_tpu.rds.streaming import StreamingRdsDecoder


@pytest.fixture(scope="module")
def rds_soft_capture():
    """One clean mode-0 capture's per-block RRC soft output (via the full
    RF receiver), plus the TX ground truth."""
    cfg = MODES[0]
    seconds = 1.2
    bits = rds_tx.standard_group_stream(pi=0x3D44, ps_name="SDR FM  ",
                                        n_groups=int(seconds * 1187.5 / 104)
                                        + 2)
    rds_bb = rds_tx.bits_to_baseband(bits, cfg.rf_fs)
    n = int(seconds * cfg.rf_fs)
    cap = tx.synthesize_capture(cfg, seconds=seconds,
                                mono=tx.tone(cfg.rf_fs, 1000.0, n),
                                rds_baseband=rds_bb[:n], a_rds=0.1)
    rx = Receiver(0, rds=True)
    out, _ = rx.run(cap, blocks_per_step=4)
    return np.asarray(out["rds_soft"]), cfg


# --------------------------------------------------------------- streaming
@pytest.mark.slow
def test_streaming_equals_offline(rds_soft_capture):
    """Blocks fed one at a time yield the same groups as the offline
    decode."""
    soft, cfg = rds_soft_capture
    offline = decode_rds_soft(soft, cfg.rds_sps)

    dec = StreamingRdsDecoder(cfg.rds_sps, correct_bursts=False)
    # feed in awkward uneven chunks (not multiples of sps) to exercise the
    # sample-carry path
    sizes = [101, 37, 1024, 64]
    i = 0
    k = 0
    while i < len(soft):
        sz = sizes[k % len(sizes)]
        dec.push(soft[i:i + sz])
        i += sz
        k += 1
    assert dec.info.pi == offline.pi == 0x3D44
    assert dec.info.groups_seen == offline.groups_seen
    assert dec.info.ps_name == offline.ps_name


@pytest.mark.slow
def test_streaming_memory_bounded(rds_soft_capture):
    """Carried state stays O(1) in stream length."""
    soft, cfg = rds_soft_capture
    dec = StreamingRdsDecoder(cfg.rds_sps)
    peaks = []
    step = 512
    for i in range(0, len(soft) - step, step):
        dec.push(soft[i:i + step])
        peaks.append(dec.buffered_bytes)
    assert dec.info.groups_seen >= 3
    # after parity lock the footprint must not grow with stream length
    tail = peaks[len(peaks) // 2:]
    assert max(tail) < 8192, f"state grew to {max(tail)} bytes"
    assert max(tail) - min(tail) <= 104 * 8  # only the <104-bit window varies


@pytest.mark.slow
def test_streaming_incremental_groups(rds_soft_capture):
    """Groups arrive DURING the stream, not only at the end."""
    soft, cfg = rds_soft_capture
    dec = StreamingRdsDecoder(cfg.rds_sps)
    first_group_at = None
    step = 512
    for i in range(0, len(soft) - step, step):
        if dec.push(soft[i:i + step]) and first_group_at is None:
            first_group_at = i
    assert first_group_at is not None
    assert first_group_at < len(soft) // 2, (
        "first group should decode in the first half of the stream")


def test_streaming_bitlevel_matches_track():
    """Pure bit-level path (no RF): streaming state machine == offline
    _track on a stream with a corrupted middle (sync loss + re-search)."""
    bits = rds_tx.standard_group_stream(pi=0x1234, n_groups=8)
    # corrupt a whole group in the middle to force sync loss
    bad = bits.copy()
    bad[104 * 3 + 50:104 * 3 + 60] ^= 1
    offline_groups, _ = extract_groups(bad, correct_bursts=False)

    # drive the streaming decoder from the bit layer directly
    dec = StreamingRdsDecoder(16, correct_bursts=False)
    dec.polarity = 0
    for i in range(0, len(bad), 77):
        dec._bits = np.concatenate([dec._bits, bad[i:i + 77]])
        got = dec._advance_sync()
        for g in got:
            dec.groups.append(g)
    assert [g.blocks for g in dec.groups] == \
        [g.blocks for g in offline_groups]
    assert [g.bit_offset for g in dec.groups] == \
        [g.bit_offset for g in offline_groups]


# --------------------------------------------------------- burst correction
def test_burst_table_complete():
    assert len(BURST_TABLE) == 367  # 26+25+48+92+176 distinct syndromes


@pytest.mark.parametrize("span", [1, 2, 3, 4, 5])
def test_correct_block_restores(span):
    rng = np.random.default_rng(span)
    block = encode_block(0xBEEF, "B")
    for start in (0, 7, 26 - span):
        e = np.zeros(26, np.uint8)
        e[start] = 1
        if span > 1:
            e[start + span - 1] = 1
            e[start + 1:start + span - 1] = rng.integers(
                0, 2, span - 2, dtype=np.uint8)
        fixed, n = correct_block(block ^ e, "B")
        assert np.array_equal(fixed, block)
        assert n == int(e.sum())


def test_correct_block_rejects_wide_burst():
    block = encode_block(0xBEEF, "A")
    e = np.zeros(26, np.uint8)
    e[[0, 6]] = 1  # span 7 — beyond the code's correction power
    assert syndrome(block ^ e) != SYNDROMES["A"]
    res = correct_block(block ^ e, "A")
    # either uncorrectable (None) or a miscorrection — never silently exact
    if res is not None:
        fixed, n = res
        assert n > 0


def test_extract_groups_burst_correction_improves_yield():
    """A burst inside a locked-position group is recovered with correction
    on; without it the group is lost and sync re-searches."""
    bits = rds_tx.standard_group_stream(pi=0x3D44, n_groups=6)
    bad = bits.copy()
    # 4-bit burst inside group 2's block B (locked position by then)
    pos = 104 * 2 + 26 + 5
    bad[pos:pos + 4] ^= np.array([1, 0, 1, 1], dtype=np.uint8)

    plain, _ = extract_groups(bad, correct_bursts=False)
    fixed, _ = extract_groups(bad, correct_bursts=True)
    assert len(fixed) == len(plain) + 1
    corrected = [g for g in fixed if g.bits_corrected]
    assert len(corrected) == 1 and corrected[0].bits_corrected == 3
    # corrected group matches the clean decode
    clean, _ = extract_groups(bits)
    assert corrected[0].blocks == clean[2].blocks


@pytest.mark.slow
def test_cli_rds_incremental_stderr(tmp_path, capsys):
    """The CLI prints RDS station info DURING the stream (multiple updates),
    not a single end-of-capture line (reference live model
    src/project.cpp:392-393)."""
    from sdr_tpu.cli import main

    cfg = MODES[0]
    seconds = 1.2
    bits = rds_tx.standard_group_stream(pi=0x3D44, ps_name="SDR FM  ",
                                        n_groups=int(seconds * 1187.5 / 104)
                                        + 2)
    rds_bb = rds_tx.bits_to_baseband(bits, cfg.rf_fs)
    n = int(seconds * cfg.rf_fs)
    cap = tx.synthesize_capture(cfg, seconds=seconds,
                                mono=tx.tone(cfg.rf_fs, 1000.0, n),
                                rds_baseband=rds_bb[:n], a_rds=0.1)
    inp = str(tmp_path / "cap.raw")
    cap.tofile(inp)
    rc = main(["0", "1", "--rds", "--in", inp,
               "--out", str(tmp_path / "a.raw"), "--blocks-per-step", "8"])
    assert rc == 0
    err = capsys.readouterr().err
    updates = [ln for ln in err.splitlines() if ln.startswith("RDS: PI=")]
    assert len(updates) >= 2, f"expected incremental updates, got:\n{err}"
    assert "PI=0x3d44" in updates[-1]
    assert "RDS final: PI=0x3d44" in err


def test_streaming_burst_correction():
    """Streaming decoder corrects the same burst mid-stream."""
    bits = rds_tx.standard_group_stream(pi=0x3D44, n_groups=6)
    bad = bits.copy()
    pos = 104 * 2 + 26 + 5
    bad[pos:pos + 4] ^= np.array([1, 0, 1, 1], dtype=np.uint8)

    dec = StreamingRdsDecoder(16, correct_bursts=True)
    dec.polarity = 0
    for i in range(0, len(bad), 64):
        dec._bits = np.concatenate([dec._bits, bad[i:i + 64]])
        dec.groups.extend(dec._advance_sync())
    assert len(dec.groups) == 6
    assert dec.bits_corrected == 3


def test_multi_streaming_matches_per_channel_offline():
    """MultiStreamingRds (fleet-scale live decode): N
    stations pushed block-wise decode the same groups as N offline
    decodes of each channel's full soft stream."""
    from sdr_tpu.rds import decode_rds_soft
    from sdr_tpu.rds import tx as rds_tx
    from sdr_tpu.rds.streaming import MultiStreamingRds
    from sdr_tpu.models.receiver import Receiver
    from sdr_tpu import tx
    from sdr_tpu.config import MODES

    cfg = MODES[0]
    sec = 0.8
    n = int(sec * cfg.rf_fs)
    caps = []
    for k in range(3):
        bits = rds_tx.standard_group_stream(pi=0x1000 + k,
                                            ps_name=f"STATION{k}",
                                            n_groups=12)
        caps.append(tx.synthesize_capture(
            cfg, seconds=sec, mono=tx.tone(cfg.rf_fs, 700.0 + 200 * k, n),
            rds_baseband=rds_tx.bits_to_baseband(bits, cfg.rf_fs)[:n],
            a_rds=0.12, seed=k))
    batch = np.stack(caps)
    rx = Receiver(0, rds=True, pll_impl="ff")
    out, _ = rx.run(batch)
    soft = np.asarray(out["rds_soft"])     # (3, n_soft)

    mrds = MultiStreamingRds(cfg.rds_sps, 3)
    bs = soft.shape[-1] // 10
    for b in range(10):
        mrds.push(soft[:, b * bs:(b + 1) * bs])
    for k in range(3):
        offline = decode_rds_soft(soft[k], cfg.rds_sps)
        live = mrds.info(k)
        assert offline.pi == 0x1000 + k
        assert live.pi == offline.pi
        assert live.ps_name == offline.ps_name
        assert live.groups_seen == offline.groups_seen


# ------------------------------------------------- real-signal impairments
def _synth_soft(bits: np.ndarray, sps: int, seed: int = 0) -> np.ndarray:
    """Clean RRC-matched soft waveform straight from the bit layer:
    differential-encode, biphase (HL=1/LH=0), pulse-shape symbol impulses
    with the raised-cosine (TX RRC * RX RRC) pulse — the waveform the full
    receiver hands the decoder, without the (slow) RF round trip."""
    from sdr_tpu.ops import firdes

    diff = np.zeros(len(bits), dtype=np.int8)
    prev = 0
    for i, b in enumerate(bits):
        prev = prev ^ b
        diff[i] = prev
    symbols = np.zeros(2 * len(bits))
    symbols[0::2] = np.where(diff == 1, 1.0, -1.0)
    symbols[1::2] = -symbols[0::2]
    x = np.zeros(len(symbols) * sps)
    x[sps // 2::sps] = symbols
    rrc = firdes.root_raised_cosine(sps * 2375.0, 8 * sps + 1, 2375.0)
    rc = np.convolve(rrc, rrc)
    return np.convolve(x, rc, mode="same")


def _clock_stretch(x: np.ndarray, ppm: float) -> np.ndarray:
    """Resample a smooth waveform by (1 + ppm*1e-6): the receiver's view of
    a transmitter whose sample clock runs fast/slow."""
    n_out = int(len(x) / (1.0 + ppm * 1e-6))
    pos = np.arange(n_out) * (1.0 + ppm * 1e-6)
    return np.interp(pos, np.arange(len(x)), x)


@pytest.mark.parametrize("ppm", [100.0, -100.0])
def test_streaming_survives_clock_offset(ppm):
    """+-100 ppm symbol-clock offset (every real RTL-SDR capture has some):
    the fractional unwrapped CDR must cross integer-sample boundaries
    without slipping a symbol index, so pairing never inverts and groups
    keep decoding to the END of the stream (an integer-argmax CDR died
    permanently at the first wraparound)."""
    sps = 16
    n_groups = 90                # ~8 s of stream: ~2 full SPS wraps at 100ppm
    bits = rds_tx.standard_group_stream(pi=0x3D44, ps_name="DRIFT! !",
                                        n_groups=n_groups)
    soft = _clock_stretch(_synth_soft(bits, sps), ppm)

    dec = StreamingRdsDecoder(sps, correct_bursts=False)
    step = 1219                  # deliberately not a multiple of sps
    for i in range(0, len(soft), step):
        dec.push(soft[i:i + step])
    assert dec.info.pi == 0x3D44
    # nearly every group must decode (boundary transients may cost a few)
    assert dec.info.groups_seen >= n_groups - 6, dec.info
    # and decoding must have continued past the LAST slip point
    total_bits = len(soft) // sps // 2
    assert dec.groups[-1].bit_offset > 0.9 * total_bits, (
        dec.groups[-1].bit_offset, total_bits)
    assert dec.parity_switches == 0  # absolute-m pairing never flipped


def test_streaming_polarity_repin_after_wrong_pin():
    """A false first sync that pins the WRONG bit polarity (e.g. a noise
    burst that happened to satisfy the inverted syndromes) must not kill
    the decoder forever: after polarity_repin_bits of fruitless search the
    pin is dropped and the real stream resyncs (a polarity pinned once,
    permanently, killed the decode)."""
    bits = rds_tx.standard_group_stream(pi=0x3D44, n_groups=8)
    decoy = rds_tx.standard_group_stream(pi=0x0BAD, n_groups=1) ^ 1

    dec = StreamingRdsDecoder(16, correct_bursts=False)
    stream = np.concatenate([decoy, bits])
    for i in range(0, len(stream), 77):
        dec._bits = np.concatenate([dec._bits, stream[i:i + 77]])
        dec.groups.extend(dec._advance_sync())
    # the decoy pinned polarity=1; the repin let the real stream through
    assert dec.polarity_repins >= 1
    assert dec.polarity == 0
    real = [g for g in dec.groups if g.bit_offset >= 104]
    assert len(real) >= 5, [g.bit_offset for g in dec.groups]
