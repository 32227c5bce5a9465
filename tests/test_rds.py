"""RDS stack tests: block code, framing, baseband codec, full RF loop.

The block-code tests pin the spec Appendix's published syndromes; the full
loop modulates real RDS groups onto a synthesized FM capture and decodes
them back through the complete receiver (the capability the reference never
finished, SURVEY §2.5).
"""

import numpy as np
import pytest

from sdr_tpu.config import MODES
from sdr_tpu.models.receiver import Receiver
from sdr_tpu import tx
from sdr_tpu.rds import (biphase_decode, decode_groups, decode_rds_soft,
                         differential_decode, extract_groups)
from sdr_tpu.rds import tx as rds_tx
from sdr_tpu.rds.decode import biphase_encode, differential_encode
from sdr_tpu.rds.groups import make_group_0a, parse_header
from sdr_tpu.rds.matrix import (H, OFFSET_WORDS, SYNDROMES, encode_block,
                                int_to_bits, syndrome)


# ------------------------------------------------------------------ block code
@pytest.mark.parametrize("name", list(OFFSET_WORDS))
def test_offset_syndromes_match_spec(name):
    """A zero-info block with offset word O yields the spec's syndrome."""
    block = np.concatenate([np.zeros(16, np.uint8),
                            int_to_bits(OFFSET_WORDS[name], 10)])
    assert syndrome(block) == SYNDROMES[name]


@pytest.mark.parametrize("name", list(OFFSET_WORDS))
@pytest.mark.parametrize("info", [0x0000, 0xFFFF, 0x3D44, 0x5A5A])
def test_encoded_block_syndrome(info, name):
    assert syndrome(encode_block(info, name)) == SYNDROMES[name]


def test_single_bit_error_changes_syndrome():
    block = encode_block(0x1234, "A")
    for i in range(26):
        bad = block.copy()
        bad[i] ^= 1
        assert syndrome(bad) != SYNDROMES["A"]


def test_h_matrix_shape():
    assert H.shape == (26, 10)
    assert set(np.unique(H)) <= {0, 1}


# ------------------------------------------------------------------- bit codec
def test_differential_roundtrip(rng):
    bits = rng.integers(0, 2, 200).astype(np.uint8)
    assert np.array_equal(differential_decode(differential_encode(bits)), bits)


def test_biphase_roundtrip(rng):
    bits = rng.integers(0, 2, 100).astype(np.uint8)
    sym = biphase_encode(bits)
    dec, parity = biphase_decode(sym)
    assert parity == 0
    assert np.array_equal(dec, bits)


def test_biphase_odd_parity_detection(rng):
    bits = rng.integers(0, 2, 100).astype(np.uint8)
    sym = np.concatenate([[0.01], biphase_encode(bits)])  # shift by one symbol
    dec, parity = biphase_decode(sym)
    assert parity == 1
    assert np.array_equal(dec, bits)


def test_polarity_invariance(rng):
    """Differential decode is invariant to a global carrier polarity flip."""
    bits = rng.integers(0, 2, 120).astype(np.uint8)
    sym = biphase_encode(differential_encode(bits))
    b_pos, _ = biphase_decode(sym)
    b_neg, _ = biphase_decode(-sym)
    assert np.array_equal(differential_decode(b_pos)[1:],
                          differential_decode(b_neg)[1:])


# -------------------------------------------------------------------- framing
def test_framing_clean_stream():
    stream = rds_tx.standard_group_stream(pi=0x3D44, n_groups=6)
    # prepend junk so sync must search
    bits = np.concatenate([np.random.default_rng(0).integers(0, 2, 37),
                           stream]).astype(np.uint8)
    groups, pol = extract_groups(bits)
    assert pol == 0
    assert len(groups) == 6
    info = decode_groups(groups)
    assert info.pi == 0x3D44
    assert info.ps_name[:4] == "SDR "


def test_framing_inverted_stream():
    stream = rds_tx.standard_group_stream(n_groups=4)
    groups, pol = extract_groups(stream.astype(np.uint8) ^ 1)
    assert pol == 1 and len(groups) == 4


def test_group_header_roundtrip():
    g = make_group_0a(pi=0xBEEF, pty=7, ps_name="ABCDEFGH", segment=2,
                      tp=True, ta=True)
    b1 = int("".join(map(str, g[:16])), 2)
    b2 = int("".join(map(str, g[26:42])), 2)
    hdr = parse_header(b1, b2)
    assert hdr.pi == 0xBEEF and hdr.pty == 7 and hdr.tp
    assert hdr.group_type == 0 and not hdr.version_b
    assert hdr.payload5 & 3 == 2


# ------------------------------------------------------------- baseband codec
def test_baseband_waveform_roundtrip():
    """bits -> RRC biphase baseband -> matched filter -> CDR -> bits."""
    from sdr_tpu.ops.firdes import root_raised_cosine
    from sdr_tpu.rds.timing import recover_symbols

    bits = rds_tx.standard_group_stream(n_groups=3)
    sps = 16
    fs = 2375.0 * sps
    bb = rds_tx.bits_to_baseband(bits, fs, sps_shape=sps)
    rrc = root_raised_cosine(fs, 151, 2375.0)
    matched = np.convolve(bb, rrc.astype(np.float64), mode="same")
    n = (len(matched) // sps) * sps
    symbols, phase = recover_symbols(matched[:n], sps)
    dec_diff, _ = biphase_decode(np.asarray(symbols))
    dec = differential_decode(dec_diff)
    groups, _ = extract_groups(dec)
    assert len(groups) >= 2
    assert decode_groups(groups).pi == 0x3D44


# ------------------------------------------------------------------ full loop
@pytest.mark.slow
def test_full_rf_rds_loop():
    """Groups -> 57 kHz subcarrier -> FM -> u8 IQ -> full receiver -> groups."""
    cfg = MODES[0]
    seconds = 1.2
    bits = rds_tx.standard_group_stream(pi=0x3D44, ps_name="SDR FM  ",
                                        n_groups=int(seconds * 1187.5 / 104) + 2)
    rds_bb = rds_tx.bits_to_baseband(bits, cfg.rf_fs)
    n = int(seconds * cfg.rf_fs)
    mono = tx.tone(cfg.rf_fs, 1000.0, n)
    cap = tx.synthesize_capture(cfg, seconds=seconds, mono=mono,
                                rds_baseband=rds_bb[:n], a_rds=0.1)
    rx = Receiver(0, rds=True)
    out, _ = rx.run(cap, blocks_per_step=4)
    info = decode_rds_soft(np.asarray(out["rds_soft"]), cfg.rds_sps)
    assert info.groups_seen >= 3, f"only {info.groups_seen} groups decoded"
    assert info.pi == 0x3D44


@pytest.mark.slow
def test_full_rf_rds_loop_mode2():
    """Mode 2: SPS=35, RDS resampler 133/384 — exercises the rational
    polyphase factors derived in config.py for the 44.1 kHz mode."""
    cfg = MODES[2]
    seconds = 1.0
    bits = rds_tx.standard_group_stream(pi=0x2AB5, ps_name="MODE2FM ",
                                        n_groups=int(seconds * 1187.5 / 104) + 2)
    rds_bb = rds_tx.bits_to_baseband(bits, cfg.rf_fs)
    n = int(seconds * cfg.rf_fs)
    cap = tx.synthesize_capture(cfg, seconds=seconds,
                                mono=tx.tone(cfg.rf_fs, 1000.0, n),
                                rds_baseband=rds_bb[:n], a_rds=0.1)
    rx = Receiver(2, rds=True)
    out, _ = rx.run(cap)
    info = decode_rds_soft(np.asarray(out["rds_soft"]), cfg.rds_sps)
    assert info.groups_seen >= 2, f"only {info.groups_seen} groups decoded"
    assert info.pi == 0x2AB5


@pytest.mark.slow
def test_rds_noise_robustness():
    """RDS still syncs at moderate RF SNR; heavy noise degrades without
    crashing (the spec's sync-loss brute-force re-search, SURVEY §5.3)."""
    cfg = MODES[0]
    seconds = 1.0
    bits = rds_tx.standard_group_stream(pi=0x3D44,
                                        n_groups=int(seconds * 1187.5 / 104) + 2)
    rds_bb = rds_tx.bits_to_baseband(bits, cfg.rf_fs)
    n = int(seconds * cfg.rf_fs)
    for noise_db, min_groups in [(-40.0, 2), (-10.0, 0)]:
        cap = tx.synthesize_capture(cfg, seconds=seconds,
                                    mono=tx.tone(cfg.rf_fs, 1000.0, n),
                                    rds_baseband=rds_bb[:n], a_rds=0.1,
                                    noise_db=noise_db)
        rx = Receiver(0, rds=True)
        out, _ = rx.run(cap, blocks_per_step=4)
        info = decode_rds_soft(np.asarray(out["rds_soft"]), cfg.rds_sps)
        assert info.groups_seen >= min_groups, (
            f"noise {noise_db} dB: {info.groups_seen} groups")


def test_manchester_pairing_score_agrees_with_decoder(rng):
    """The on-device pairing-score formulation picks the same parity as the
    host decoder."""
    import jax.numpy as jnp
    from sdr_tpu.rds.timing import manchester_pairing_score
    bits = rng.integers(0, 2, 80).astype(np.uint8)
    sym = biphase_encode(differential_encode(bits))
    s_even, s_odd = manchester_pairing_score(jnp.asarray(sym))
    assert float(s_even) > float(s_odd)
    shifted = np.concatenate([[0.0], sym])
    s_even2, s_odd2 = manchester_pairing_score(jnp.asarray(shifted))
    assert float(s_odd2) > float(s_even2)


def test_group_4a_clock_time_roundtrip():
    """Clock-time group (4A): MJD/hour/minute encode -> frame -> app decode."""
    from sdr_tpu.rds.groups import make_group_4a
    g1 = make_group_4a(pi=0x3D44, pty=2, mjd=60000, hour=23, minute=59)
    g2 = make_group_4a(pi=0x3D44, pty=2, mjd=45678, hour=7, minute=5)
    bits = np.concatenate([g1, g2])
    groups, _ = extract_groups(bits)
    assert len(groups) == 2
    info = decode_groups(groups)
    assert info.clock == (45678, 7, 5)  # last 4A wins
    info1 = decode_groups(groups[:1])
    assert info1.clock == (60000, 23, 59)


def test_version_b_group_syncs():
    """Version-B groups (C' offset in block 3) still frame-sync."""
    from sdr_tpu.rds.groups import make_group
    g = make_group(pi=0x1234, group_type=0, version_b=True, tp=False, pty=1,
                   payload5=2, block3=0x1234, block4=0x4142)
    bits = np.concatenate([g, g, g])
    groups, _ = extract_groups(bits)
    assert len(groups) == 3
    assert all(gr.version_b for gr in groups)


def test_syndromes_sliding_device_matches_host(rng):
    """The jitted int32-matmul frame sync equals the numpy formulation,
    batched, and finds the same sync positions on an encoded stream."""
    import jax
    from sdr_tpu.rds.matrix import syndromes_sliding, syndromes_sliding_device

    bits = rng.integers(0, 2, size=(3, 400)).astype(np.uint8)
    dev = np.asarray(jax.jit(syndromes_sliding_device)(bits))
    for c in range(3):
        np.testing.assert_array_equal(dev[c], syndromes_sliding(bits[c]))

    # a real encoded group embedded at a known offset syncs identically
    stream = rng.integers(0, 2, size=200).astype(np.uint8)
    blk = encode_block(0x1234, "A")
    stream[50:76] = blk
    host = syndromes_sliding(stream)
    devs = np.asarray(syndromes_sliding_device(stream))
    np.testing.assert_array_equal(devs, host)
    assert devs[50] == SYNDROMES["A"]
