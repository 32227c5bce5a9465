"""Real-signal impairment matrix: the receiver's operating envelope.

Every real RTL-SDR capture carries carrier frequency offset (crystal ppm
at ~100 MHz), TX/RX sample-clock mismatch, oscillator phase noise, and
finite RF SNR — none of which the reference's clean golden WAVs exercise
(SURVEY §4.2).  These tests gate the full
stereo+RDS chain — mono/left SNR, stereo separation, AND RDS group yield
through the drift-tracking streaming decoder — for BOTH the default
(exact) and the production `--fast` engine set, under each impairment and
their combination.

Physics notes (why the gates hold):
  * CFO becomes a DC shift after the FM discriminator (a frequency offset
    adds a constant to the instantaneous-frequency output); every
    subcarrier stays at its multiplex frequency, and the channel BPFs
    reject the DC — reference chain: src/filter.cpp:106-133 demod into
    src/project.cpp:162-165 BPFs.
  * clock ppm scales every baseband frequency by (1+1e-6*ppm): the pilot
    moves ~1.9 mHz/ppm (trivially inside both PLL pull-in and the
    feedforward estimator's fs/(2*window) ~ 469 Hz range), but the RDS
    SYMBOL clock slips a full sample every ~1/(2375*sps*1e-6*ppm) s —
    the part that killed the round-3 integer-phase CDR
    (rds/streaming.py now tracks fractional timing; see
    tests/test_rds_streaming.py::test_streaming_survives_clock_offset).
  * pilot phase noise stresses carrier tracking directly (it scales 2x/3x
    onto the 38/57 kHz subcarriers).
"""

from __future__ import annotations

import numpy as np
import pytest

from sdr_tpu import tx
from sdr_tpu.config import MODES
from sdr_tpu.device import interpret_kernels
from sdr_tpu.models.receiver import Receiver
from sdr_tpu.rds import tx as rds_tx
from sdr_tpu.rds.streaming import StreamingRdsDecoder
from sdr_tpu.utils.compare import stereo_separation_db, tone_snr_db

# the --fast engine set as on a GPU; the front-end kernel runs in the
# Pallas interpreter here
FAST = dict(fused_frontend=True, pll_impl="ff", conv_dtype="bf16")

IMPAIRMENTS = {
    # +-30 ppm crystal at ~100 MHz -> up to ~3 kHz LO offset
    "cfo": dict(cfo_hz=3000.0),
    # RTL-SDR-class sample-clock mismatch
    "clock_ppm": dict(clock_ppm=-100.0),
    # noisy exciter reference (2 Hz Lorentzian linewidth at the pilot)
    "phase_noise": dict(pilot_linewidth_hz=2.0),
    # everything at once, at reduced RF SNR
    "combo": dict(cfo_hz=2000.0, clock_ppm=100.0,
                  pilot_linewidth_hz=0.5, noise_db=-14.0),
}


@pytest.fixture(scope="module")
def impaired_captures():
    cfg = MODES[0]
    sec = 0.9
    n = int(sec * cfg.rf_fs)
    bits = rds_tx.standard_group_stream(pi=0x3D44, ps_name="IMPAIR  ",
                                        n_groups=14)
    base = dict(seconds=sec, left=tx.tone(cfg.rf_fs, 1000.0, n),
                right=tx.tone(cfg.rf_fs, 2500.0, n),
                rds_baseband=rds_tx.bits_to_baseband(bits, cfg.rf_fs)[:n],
                a_rds=0.1)
    return cfg, {name: tx.synthesize_capture(cfg, **base, **kw)
                 for name, kw in IMPAIRMENTS.items()}


@pytest.mark.slow
def test_fast_matches_default_group_yield_clean():
    """On a clean capture the `--fast` engine set decodes the SAME number of
    RDS groups as the default engines.  The round-4 envelope table showed a
    constant 2-group 'fast' deficit that was misattributed to a feedforward
    warm-up transient — it was run()'s trailing-block truncation (the fast
    engines' coarse step alignment dropped ~0.25 s of capture), fixed by
    the aligned EOF flush in Receiver.run."""
    cfg = MODES[0]
    sec = 1.2
    n = int(sec * cfg.rf_fs)
    bits = rds_tx.standard_group_stream(pi=0x3D44, ps_name="CLEAN   ",
                                        n_groups=16)
    cap = tx.synthesize_capture(
        cfg, seconds=sec, left=tx.tone(cfg.rf_fs, 1000.0, n),
        right=tx.tone(cfg.rf_fs, 2500.0, n),
        rds_baseband=rds_tx.bits_to_baseband(bits, cfg.rf_fs)[:n], a_rds=0.1)
    yields = {}
    for name, kw in [("default", {}), ("fast", FAST)]:
        rx = Receiver(0, stereo=True, rds=True, **kw)
        with interpret_kernels():
            out, _ = rx.run(cap, blocks_per_step=8)
        dec = StreamingRdsDecoder(cfg.rds_sps)
        soft = np.asarray(out["rds_soft"])
        for i in range(0, len(soft), 2048):
            dec.push(soft[i:i + 2048])
        yields[name] = dec.info.groups_seen
    assert yields["fast"] == yields["default"], yields
    assert yields["default"] >= 12, yields


@pytest.mark.slow
@pytest.mark.parametrize("impairment", sorted(IMPAIRMENTS))
@pytest.mark.parametrize("engines", ["default", "fast"])
def test_impairment_envelope(impaired_captures, impairment, engines):
    cfg, caps = impaired_captures
    rx = Receiver(0, stereo=True, rds=True,
                  **(FAST if engines == "fast" else {}))
    with interpret_kernels():
        out, _ = rx.run(caps[impairment], blocks_per_step=8)
    left = np.asarray(out["left"])
    right = np.asarray(out["right"])
    skip = cfg.audio_fs // 4

    sep = stereo_separation_db(left, right, cfg.audio_fs, 1000.0, skip=skip)
    assert sep > 20.0, f"{impairment}/{engines}: separation {sep:.1f} dB"
    snr = tone_snr_db(left[skip:], cfg.audio_fs, 1000.0)
    assert snr > 18.0, f"{impairment}/{engines}: L SNR {snr:.1f} dB"

    dec = StreamingRdsDecoder(cfg.rds_sps)
    soft = np.asarray(out["rds_soft"])
    for i in range(0, len(soft), 2048):
        dec.push(soft[i:i + 2048])
    assert dec.info.pi == 0x3D44, f"{impairment}/{engines}: {dec.info}"
    assert dec.info.groups_seen >= 6, f"{impairment}/{engines}: {dec.info}"
    assert dec.info.ps_name == "IMPAIR  "
