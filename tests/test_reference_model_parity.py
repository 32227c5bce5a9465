"""Cross-validation against the reference's OWN golden-model code.

Every other test in this suite validates against self-authored oracles
(ops/resample.py resample_reference, ops/pll.py pll_reference, scipy).  This
module closes the loop: it imports the reference's actual Python golden
models (/root/reference/model/fmMonoBlock.py, fmStereoBlock.py — both are
__main__-guarded and importable), runs THEIR functions / block loops on
sdr_tpu-synthesized captures, and asserts our outputs track code we did not
write.  It also feeds the reference's real-signal stage dumps
(data/fm_demod_10.bin / fm_demod_11.bin — 5120 float32 IF samples per block,
produced by model/fmMonoBlock.py:277-280 from a real FM capture) through the
audio/stereo back halves.

Citations into /root/reference:
  model/fmMonoBlock.py:17-37   lp_impulse_response_coeff
  model/fmMonoBlock.py:59-81   myDemod (discriminator)
  model/fmMonoBlock.py:83-93   upsample / downsample
  model/fmMonoBlock.py:217-264 the golden block loop (lfilter w/ zi carry)
  model/fmStereoBlock.py:10-26 bandpassFilt (n_taps-1 allocation quirk)
  model/fmStereoBlock.py:28-61 fmPll (stateless per call)
  model/fmStereoBlock.py:63-80 filter (stateful block conv)
  model/fmStereoBlock.py:139-151 mixer (in-place, no x2) / lrExtraction
"""

import os
import sys

import numpy as np
import pytest
from scipy import signal

from sdr_tpu.config import MODES, ModeConfig
from sdr_tpu.models.receiver import Receiver
from sdr_tpu.ops import firdes
from sdr_tpu.ops.pll import pll, pll_init, pll_reference
from sdr_tpu.ops.demod import fm_discriminator
from sdr_tpu.ops.resample import PolyphaseResampler
from sdr_tpu.utils.compare import stream_snr_db, tone_snr_db
from sdr_tpu import tx

REF = "/root/reference"
pytestmark = pytest.mark.skipif(not os.path.isdir(os.path.join(REF, "model")),
                                reason="reference mount not present")


@pytest.fixture(scope="module")
def refmod():
    """Import the reference golden models (read-only mount: no bytecode)."""
    sys.dont_write_bytecode = True
    import matplotlib
    matplotlib.use("Agg")
    path = os.path.join(REF, "model")
    if path not in sys.path:
        sys.path.insert(0, path)
    import fmMonoBlock
    import fmStereoBlock
    return fmMonoBlock, fmStereoBlock


@pytest.fixture(scope="module")
def demod_bins():
    """The reference's real-signal IF dumps (two consecutive mode-0 blocks)."""
    b10 = np.fromfile(os.path.join(REF, "data/fm_demod_10.bin"), np.float32)
    b11 = np.fromfile(os.path.join(REF, "data/fm_demod_11.bin"), np.float32)
    assert b10.shape == (5120,) and b11.shape == (5120,)
    return b10, b11


# --------------------------------------------------------------- filter design
def test_lowpass_matches_reference_model_code(refmod):
    """firdes.lowpass == the model's lp_impulse_response_coeff, run live
    (model/fmMonoBlock.py:17-37), at both the model's 101-tap and the C++
    51-tap configurations."""
    M, _ = refmod
    for fc, fs, taps in [(100e3, 2.4e6, 101), (16e3, 240e3, 101),
                         (100e3, 2.4e6, 51), (16e3, 240e3 * 147, 101 * 147)]:
        theirs = M.lp_impulse_response_coeff(fc, fs, taps)
        ours = firdes.lowpass(fs, fc, taps, 1)
        np.testing.assert_allclose(ours, theirs, atol=1e-7)


def test_bandpass_matches_reference_model_code(refmod):
    """firdes.bandpass == the model's bandpassFilt (fmStereoBlock.py:10-26)
    on the overlapping region: the model allocates n_taps-1 coefficients
    (its documented off-by-one) computed with the same formulas, so it
    equals the first n_taps-1 entries of the full design."""
    _, S = refmod
    for fb, fe, taps in [(18.5e3, 19.5e3, 101), (22e3, 54e3, 101),
                         (18.5e3, 19.5e3, 51)]:
        theirs = S.bandpassFilt(fb, fe, 240e3, taps)
        ours = firdes.bandpass(240e3, fb, fe, taps)
        assert len(theirs) == taps - 1
        np.testing.assert_allclose(ours[: taps - 1], theirs, atol=1e-7)


# -------------------------------------------------------------------- demod
def test_discriminator_matches_reference_model_code(refmod, rng):
    """fm_discriminator == the model's myDemod (fmMonoBlock.py:59-81),
    including prev_i/prev_q state carry across block splits."""
    M, _ = refmod
    i_s = rng.standard_normal(600).astype(np.float32) * 0.5
    q_s = rng.standard_normal(600).astype(np.float32) * 0.5
    d1, pi_, pq = M.myDemod(i_s[:300], q_s[:300])
    d2, _, _ = M.myDemod(i_s[300:], q_s[300:], pi_, pq)
    theirs = np.concatenate([d1, d2])

    import jax.numpy as jnp
    o1, oi, oq = fm_discriminator(jnp.asarray(i_s[:300]), jnp.asarray(q_s[:300]),
                                  jnp.float32(0), jnp.float32(0))
    o2, _, _ = fm_discriminator(jnp.asarray(i_s[300:]), jnp.asarray(q_s[300:]),
                                oi, oq)
    ours = np.concatenate([np.asarray(o1), np.asarray(o2)])
    np.testing.assert_allclose(ours, theirs, atol=1e-4)


# ---------------------------------------------------------------------- PLL
def test_pll_oracle_matches_reference_model_code(refmod):
    """ops.pll.pll_reference (the oracle every PLL engine is pinned to) ==
    the model's fmPll run live (fmStereoBlock.py:28-61), same stateless
    init (integrator=0, phaseEst=0, fbI=1, fbQ=0, trigOffset=0)."""
    _, S = refmod
    fs, f = 240e3, 19e3
    t = np.arange(4096) / fs
    x = np.cos(2 * np.pi * f * t + 0.7).astype(np.float32)
    theirs = S.fmPll(x, f, fs, 2.0, 0.0, 0.01)
    ours, _ = pll_reference(x, f, fs, 2.0, 0.0, 0.01, (0, 0, 1, 0, 0))
    # identical recurrence; difference is f32 (oracle, like the C++) vs the
    # model's f64 — bounded because the loop is locked, not accumulating
    assert stream_snr_db(ours, theirs) > 40.0


def test_pll_jax_tracks_reference_model_code(refmod):
    """The jitted scan PLL in its bit-faithful configuration tracks fmPll on
    a locked pilot."""
    _, S = refmod
    import jax.numpy as jnp
    fs, f = 240e3, 19e3
    t = np.arange(4096) / fs
    x = np.cos(2 * np.pi * f * t + 0.7).astype(np.float32)
    theirs = S.fmPll(x, f, fs, 2.0, 0.0, 0.01)
    nco, _ = pll(jnp.asarray(x), pll_init(), freq=f, fs=fs, nco_scale=2.0,
                 wrap_phase=False, lag_correction=False)
    assert stream_snr_db(np.asarray(nco), theirs) > 40.0


# ------------------------------------------------- golden mono block loop
def _reference_mono_loop(M, iq_data, *, rf_fs, rf_decim, audio_interp,
                         audio_decim, block_size, rf_taps=101,
                         audio_taps_base=101):
    """The reference's golden block loop (model/fmMonoBlock.py:217-264),
    executed with the reference's own imported functions.  Only the loop
    scaffolding (slicing / state plumbing) is transcribed; every DSP call is
    the reference's: lp_impulse_response_coeff, signal.lfilter(zi=...),
    downsample, myDemod, upsample."""
    audio_taps = audio_taps_base * audio_interp
    if_fs = (rf_fs / rf_decim) * audio_interp
    rf_coeff = M.lp_impulse_response_coeff(100e3, rf_fs, rf_taps)
    audio_coeff = M.lp_impulse_response_coeff(16e3, if_fs, audio_taps)
    audio_coeff = audio_coeff * audio_interp
    st_i = np.zeros(rf_taps - 1)
    st_q = np.zeros(rf_taps - 1)
    prev_i = prev_q = 0
    audio_state = np.zeros(audio_taps - 1)
    audio, demod_all = [], []
    n_blocks = len(iq_data) // block_size
    for b in range(n_blocks):
        i_filt, st_i = signal.lfilter(
            rf_coeff, 1.0, iq_data[b * block_size: (b + 1) * block_size: 2],
            zi=st_i)
        q_filt, st_q = signal.lfilter(
            rf_coeff, 1.0,
            iq_data[b * block_size + 1: (b + 1) * block_size: 2], zi=st_q)
        i_ds = M.downsample(i_filt, rf_decim)
        q_ds = M.downsample(q_filt, rf_decim)
        fm_demod, prev_i, prev_q = M.myDemod(i_ds, q_ds, prev_i, prev_q)
        demod_all.append(fm_demod)
        fm_demod_us = M.upsample(fm_demod, audio_interp)
        audio_filt, audio_state = signal.lfilter(audio_coeff, 1.0,
                                                 fm_demod_us, zi=audio_state)
        audio.append(M.downsample(audio_filt, audio_decim))
    return np.concatenate(audio), np.concatenate(demod_all)


def _model_cfg(mode: int) -> ModeConfig:
    """The reference *model*'s constants: like MODES[mode] but with the
    Python model's 101-tap filters (fmMonoBlock.py:100,103 — the C++ uses
    51, src/project.cpp:347)."""
    base = MODES[mode]
    return ModeConfig(mode=base.mode, rf_fs=base.rf_fs,
                      rf_decim=base.rf_decim, audio_interp=base.audio_interp,
                      audio_decim=base.audio_decim, audio_fs=base.audio_fs,
                      rds_sps=base.rds_sps, rf_taps=101, base_audio_taps=101)


@pytest.mark.parametrize("mode", [0, 2])
def test_mono_matches_reference_model_loop(refmod, mode):
    """Receiver.run vs the reference's own golden block loop on the same
    synthesized capture, at both the demodulated-IF and audio stages."""
    M, _ = refmod
    base = MODES[mode]
    # block sizes: the model's 512*rf_decim*audio_decim*2 for mode 0
    # (fmMonoBlock.py:193); for mode 2 that is 8.2 MB — use a smaller block
    # that keeps every alignment (phase continuity is state-carried, so the
    # model's output is block-size invariant)
    block = (512 * 10 * 5 * 2) if mode == 0 else (2 * 10 * 800 * 4)
    n_blocks = 6 if mode == 0 else 4
    n_u8 = block * n_blocks
    sec = n_u8 / 2 / base.rf_fs
    mono_in = tx.tone(base.rf_fs, 800.0, n_u8 // 2)
    cap = tx.synthesize_capture(base, seconds=sec, mono=mono_in)[:n_u8]

    iq = (np.float32(cap) - 128.0) / 128.0
    theirs, theirs_demod = _reference_mono_loop(
        M, iq, rf_fs=base.rf_fs, rf_decim=base.rf_decim,
        audio_interp=base.audio_interp, audio_decim=base.audio_decim,
        block_size=block)

    rx = Receiver(_model_cfg(mode), emit_if=True)
    outs, _ = rx.run(cap)
    ours = np.asarray(outs["mono"])
    ours_demod = np.asarray(outs["fm_demod"])

    n = min(len(ours), len(theirs))
    nd = min(len(ours_demod), len(theirs_demod))
    assert n > 0 and nd > 0
    # skip the filter warm-up where both sides are near-zero
    assert stream_snr_db(ours_demod[:nd], theirs_demod[:nd], skip=256) > 50.0
    assert stream_snr_db(ours[:n], theirs[:n], skip=64) > 50.0


# --------------------------------------------- golden stereo block loop
def test_stereo_matches_reference_model_loop(refmod):
    """Run the reference's own stereo block loop (fmStereoBlock.py:317-378:
    stereoExtract, stereoRecovery w/ stateless fmPll, monoProcess,
    stereoProcess) on a synthesized stereo capture and cross-check:
      - its mono path (their `filter` + downsample) matches our mono output
        near-exactly (linear, stateful — same math), and
      - both receivers put each tone in the correct channel; ours with at
        least as much separation (their model halves stereo gain by the
        missing x2 mixer and skips the audio LPF before decimation).
    """
    M, S = refmod
    base = MODES[0]
    block = 512 * 10 * 5 * 2
    n_blocks = 4
    n_u8 = block * n_blocks
    sec = n_u8 / 2 / base.rf_fs
    n = n_u8 // 2
    left = tx.tone(base.rf_fs, 1000.0, n)
    right = tx.tone(base.rf_fs, 2500.0, n)
    cap = tx.synthesize_capture(base, seconds=sec, left=left,
                                right=right)[:n_u8]
    iq = (np.float32(cap) - 128.0) / 128.0

    # --- their loop (fmStereoBlock.py:317-378), their functions throughout
    rf_taps, audio_taps, audio_decim = 101, 101, 5
    rf_coeff = S.lp_impulse_response_coeff(100e3, base.rf_fs, rf_taps)
    mono_coeff = S.lp_impulse_response_coeff(16e3, 240e3, audio_taps)
    st_i, st_q = np.zeros(rf_taps - 1), np.zeros(rf_taps - 1)
    prev_i = prev_q = 0
    mono_state = np.zeros(audio_taps - 1)
    chan_state = np.zeros(audio_taps - 1)
    carr_state = np.zeros(audio_taps - 1)
    left_d = np.array([])
    right_d = np.array([])
    stereo_d = np.array([])
    mono_all = np.array([])
    for b in range(n_blocks):
        i_filt, st_i = signal.lfilter(
            rf_coeff, 1.0, iq[b * block: (b + 1) * block: 2], zi=st_i)
        q_filt, st_q = signal.lfilter(
            rf_coeff, 1.0, iq[b * block + 1: (b + 1) * block: 2], zi=st_q)
        i_ds, q_ds = S.downsample(i_filt, 10), S.downsample(q_filt, 10)
        fm_demod, prev_i, prev_q = S.myDemod(i_ds, q_ds, prev_i, prev_q)
        chan, chan_state = S.stereoExtract(fm_demod, chan_state, None)
        carr, carr_state = S.stereoRecovery(fm_demod, carr_state, None)
        mono_blk, mono_state = S.monoProcess(fm_demod, mono_coeff,
                                             mono_state, audio_decim, None)
        mono_all = np.concatenate([mono_all, mono_blk])
        left_d, right_d, stereo_d = S.stereoProcess(
            chan, carr, mono_blk, left_d, right_d, 1, audio_decim, stereo_d)

    # --- ours on the identical capture
    rx = Receiver(_model_cfg(0), stereo=True)
    outs, _ = rx.run(cap)
    ours_mono = np.asarray(outs["mono"])
    ours_l, ours_r = np.asarray(outs["left"]), np.asarray(outs["right"])

    # the linear mono path is the same math: near-exact
    nm = min(len(ours_mono), len(mono_all))
    assert stream_snr_db(ours_mono[:nm], mono_all[:nm], skip=64) > 50.0

    # both decoders put each tone in its channel (model: weakly, given its
    # stateless-PLL relock each block, halved stereo gain and aliasing;
    # ours: strongly)
    fs = float(base.audio_fs)
    skip = len(ours_l) // 4
    from sdr_tpu.utils.compare import band_power_db
    their_sep = (band_power_db(left_d, fs, 1000.0, skip=skip)
                 - band_power_db(right_d, fs, 1000.0, skip=skip))
    our_sep = (band_power_db(ours_l, fs, 1000.0, skip=skip)
               - band_power_db(ours_r, fs, 1000.0, skip=skip))
    assert their_sep > 1.0    # the reference model does separate channels
    assert our_sep > 20.0     # ours separates strictly better
    assert our_sep > their_sep
    # and both hear the tones at the right places (the model only barely:
    # its un-filtered decimation aliases the 76 kHz mixer image into the
    # audio band, leaving ~2.8 dB of tone SNR on this capture)
    assert tone_snr_db(ours_l, fs, 1000.0, skip=skip) > 20.0
    assert tone_snr_db(left_d, fs, 1000.0, skip=skip) > 1.5


# --------------------------------------- real-signal stage dumps (fm_demod_*)
def test_fm_demod_bins_mono_back_half(refmod, demod_bins):
    """Feed the reference's real-signal IF dumps through the mono back half:
    their upsample+lfilter+downsample (fmMonoBlock.py:249-255) vs our
    PolyphaseResampler, with state carried block 10 -> block 11."""
    M, _ = refmod
    b10, b11 = demod_bins
    audio_coeff = M.lp_impulse_response_coeff(16e3, 240e3, 101)
    st = np.zeros(100)
    a1, st = signal.lfilter(audio_coeff, 1.0, M.upsample(b10, 1), zi=st)
    a2, _ = signal.lfilter(audio_coeff, 1.0, M.upsample(b11, 1), zi=st)
    theirs = np.concatenate([M.downsample(a1, 5), M.downsample(a2, 5)])

    ours_rs = PolyphaseResampler(audio_coeff.astype(np.float32), 1, 5)
    t = ours_rs.init_state()
    o1, t = ours_rs(b10, t)
    o2, _ = ours_rs(b11, t)
    ours = np.concatenate([np.asarray(o1), np.asarray(o2)])
    assert stream_snr_db(ours, theirs) > 55.0


def test_fm_demod_bins_stereo_stages(refmod, demod_bins):
    """Real-signal cross-check of the stereo stages: the model's stateful
    `filter` (fmStereoBlock.py:63-80) with its own bandpassFilt coefficients
    vs our conv engine on the same coefficients, then its fmPll vs our
    oracle on the really-filtered pilot."""
    _, S = refmod
    b10, b11 = demod_bins
    coeff = S.bandpassFilt(18.5e3, 19.5e3, 240e3, 101)   # their 100 taps
    st = np.zeros(100)
    p1, st = S.filter(coeff, b10, st)
    p2, _ = S.filter(coeff, b11, st)
    theirs_pilot = np.concatenate([p1, p2])

    ours_f = PolyphaseResampler(coeff.astype(np.float32), 1, 1)
    t = ours_f.init_state()
    o1, t = ours_f(b10, t)
    o2, _ = ours_f(b11, t)
    ours_pilot = np.concatenate([np.asarray(o1), np.asarray(o2)])
    # the model's `filter` carries a state of n_taps-1 = 100 samples for its
    # 100 coefficients (one longer than the lfilter convention), adding one
    # sample of extra delay — align by that shift
    assert stream_snr_db(ours_pilot[:-1], theirs_pilot[1:]) > 55.0

    # their PLL on the real pilot vs our oracle — same recurrence
    theirs_nco = S.fmPll(theirs_pilot, 19e3, 240e3, 2.0, 0.0, 0.01)
    ours_nco, _ = pll_reference(theirs_pilot.astype(np.float32), 19e3, 240e3,
                                2.0, 0.0, 0.01, (0, 0, 1, 0, 0))
    assert stream_snr_db(ours_nco, theirs_nco) > 30.0


def test_fm_demod_bins_rds_front(demod_bins):
    """The real IF dumps carry a live FM multiplex; run our RDS front chain
    (54-60 kHz channel extraction -> squaring -> 114 kHz carrier) on them
    and check the squared channel really concentrates energy at 114 kHz —
    evidence the chain is extracting a real-world RDS subcarrier, not just
    synthesized ones."""
    import jax.numpy as jnp
    b10, b11 = demod_bins
    x = np.concatenate([b10, b11])
    cfg = MODES[0]
    chan_coeff = firdes.bandpass(cfg.if_fs, cfg.rds_lo, cfg.rds_hi, 151)
    f = PolyphaseResampler(chan_coeff, 1, 1)
    chan, _ = f(jnp.asarray(x), f.init_state())
    squared = np.asarray(chan) ** 2
    spec = np.abs(np.fft.rfft(squared * np.hanning(len(squared)))) ** 2
    freqs = np.fft.rfftfreq(len(squared), 1.0 / cfg.if_fs)
    band = spec[(freqs > 113.5e3) & (freqs < 114.5e3)].max()
    # compare against the 100-113 kHz shoulder (same nonlinearity output)
    shoulder = spec[(freqs > 100e3) & (freqs < 113e3)].max()
    assert band > 3.0 * shoulder


# ------------------------------------------------------------------ PSD (C10)
def test_estimate_psd_matches_reference_model_code(refmod):
    """ops/fourier.estimate_psd == the reference's own Bartlett estimator
    (model/fmSupportLib.py:86-161), run live, to float tolerance — the
    exactness gate for C10 (not just the peak location)."""
    sys.dont_write_bytecode = True
    import fmSupportLib

    from sdr_tpu.ops.fourier import estimate_psd

    rng = np.random.default_rng(42)
    fs = 240e3
    t = np.arange(4096) / fs
    x = (np.sin(2 * np.pi * 19e3 * t) + 0.3 * np.sin(2 * np.pi * 57e3 * t)
         + 0.05 * rng.standard_normal(t.size)).astype(np.float64)
    for nfft in (512, 256):
        f_ref, p_ref = fmSupportLib.estimatePSD(x, NFFT=nfft, Fs=fs)
        f_ours, p_ours = estimate_psd(x.astype(np.float32), nfft=nfft, fs=fs)
        np.testing.assert_allclose(np.asarray(f_ours), f_ref, rtol=1e-12)
        # f32 FFT vs f64 FFT on dB-scale bins: agree to ~1e-3 dB
        np.testing.assert_allclose(np.asarray(p_ours), p_ref, atol=5e-3)


def test_psd_complex_matches_numpy_oracle():
    """ops/spectrum.psd_complex windowing/scaling pinned to a direct f64
    NumPy oracle of the same definition (the reference has no two-sided
    estimator; this closes the exactness gap the same way)."""
    from sdr_tpu.ops.spectrum import psd_complex

    rng = np.random.default_rng(3)
    fs = 2.4e6
    n, nfft = 8192, 1024
    t = np.arange(n) / fs
    i_w = np.cos(2 * np.pi * 250e3 * t) + 0.1 * rng.standard_normal(n)
    q_w = np.sin(2 * np.pi * 250e3 * t) + 0.1 * rng.standard_normal(n)

    x = i_w + 1j * q_w
    hann = np.sin(np.arange(nfft) * np.pi / nfft) ** 2
    segs = x[: (n // nfft) * nfft].reshape(-1, nfft) * hann
    power = np.mean(np.abs(np.fft.fft(segs, axis=-1)) ** 2, axis=0) / nfft
    expect = 10.0 * np.log10(np.fft.fftshift(power) + 1e-20)

    ours = np.asarray(psd_complex(i_w.astype(np.float32),
                                  q_w.astype(np.float32), nfft=nfft))
    np.testing.assert_allclose(ours, expect, atol=5e-3)
