"""End-to-end receiver tests on synthesized FM captures.

Reference methodology: golden-output comparison (SURVEY §4.2).  The repo's
raw acceptance captures are stripped, so these tests close the loop with the
framework's own spec-faithful transmitter (sdr_tpu/tx.py): modulate known
audio -> receive -> assert recovered tone SNR / stereo separation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sdr_tpu.config import MODES
from sdr_tpu.device import interpret_kernels
from sdr_tpu.models.receiver import Receiver
from sdr_tpu import tx

# the --fast engine set with the fused front-end kernel (as on a GPU); on
# the CPU the kernel runs in the Pallas interpreter
FAST = dict(fused_frontend=True, pll_impl="ff", conv_dtype="bf16")
from sdr_tpu.utils.compare import stereo_separation_db, tone_snr_db


@pytest.mark.parametrize("mode", [0, 1, 2, 3])
def test_mono_tone_recovery(mode):
    cfg = MODES[mode]
    n = int(0.4 * cfg.rf_fs)
    mono = tx.tone(cfg.rf_fs, 1000.0, n)
    cap = tx.synthesize_capture(cfg, seconds=0.4, mono=mono)
    rx = Receiver(mode)
    out, _ = rx.run(cap)
    audio = np.asarray(out["mono"])
    # drop the filter warm-up, measure 1 kHz tone SNR at the audio rate.
    # ~25-30 dB is the physics ceiling here: the discriminator's first-order
    # phase-difference approximation distorts at 75 kHz deviation (the
    # reference's demod has identical distortion); implementation fidelity
    # is pinned separately by test_mono_matches_scipy_oracle.
    snr = tone_snr_db(audio, cfg.audio_fs, 1000.0, skip=cfg.audio_fs // 10)
    assert snr > 25.0, f"mode {mode} mono SNR {snr:.1f} dB"


@pytest.mark.parametrize("mode", [0, 2])
def test_mono_matches_scipy_oracle(mode):
    """Implementation fidelity: the JAX mono chain == the golden model's
    scipy formulation (model/fmMonoBlock.py:224-255: lfilter + [::decim] +
    discriminator + zero-stuff + lfilter + [::decim]) to float32 precision."""
    import scipy.signal as sps
    from sdr_tpu.ops import firdes
    from sdr_tpu.utils.compare import stream_snr_db

    cfg = MODES[mode]
    secs = 0.12
    n = int(secs * cfg.rf_fs)
    cap = tx.synthesize_capture(cfg, seconds=secs,
                                mono=tx.tone(cfg.rf_fs, 1000.0, n))
    rx = Receiver(mode)
    out, _ = rx.run(cap)
    audio = np.asarray(out["mono"], np.float64)

    # scipy oracle (float64, whole-capture single pass)
    iq = (cap.astype(np.float64) - 128.0) / 128.0
    i_raw, q_raw = iq[0::2], iq[1::2]
    rf_coeff = firdes.lowpass(cfg.rf_fs, cfg.rf_fc, cfg.rf_taps, 1).astype(np.float64)
    i_ds = sps.lfilter(rf_coeff, 1.0, i_raw)[::cfg.rf_decim]
    q_ds = sps.lfilter(rf_coeff, 1.0, q_raw)[::cfg.rf_decim]
    di = np.diff(i_ds, prepend=0.0)
    dq = np.diff(q_ds, prepend=0.0)
    den = i_ds ** 2 + q_ds ** 2
    demod = np.where(den == 0, 0.0, (i_ds * dq - q_ds * di) / np.where(den == 0, 1, den))
    up = np.zeros(len(demod) * cfg.audio_interp)
    up[:: cfg.audio_interp] = demod
    audio_coeff = firdes.lowpass(cfg.if_fs * cfg.audio_interp, cfg.audio_fc,
                                 cfg.audio_taps, cfg.audio_gain).astype(np.float64)
    ref = sps.lfilter(audio_coeff, 1.0, up)[:: cfg.audio_decim]

    m = min(len(audio), len(ref))
    snr = stream_snr_db(audio[:m], ref[:m])
    assert snr > 55.0, f"mode {mode} fidelity vs scipy oracle: {snr:.1f} dB"


def test_mono_block_split_invariance():
    """One jit step per reference block == 4 fused blocks per step
    (state carry fidelity, SURVEY §7 hard-part 3)."""
    cfg = MODES[0]
    mono = tx.tone(cfg.rf_fs, 2000.0, int(0.2 * cfg.rf_fs))
    cap = tx.synthesize_capture(cfg, seconds=0.2, mono=mono)
    rx = Receiver(0)
    o1, _ = rx.run(cap, blocks_per_step=1)
    o4, _ = rx.run(cap, blocks_per_step=4)
    n = min(o1["mono"].shape[-1], o4["mono"].shape[-1])
    np.testing.assert_allclose(np.asarray(o1["mono"])[:n],
                               np.asarray(o4["mono"])[:n], atol=1e-5)


def test_stereo_separation():
    """L-only 1 kHz tone + R-only 2.5 kHz tone: each lands in its channel."""
    cfg = MODES[0]
    n = int(0.6 * cfg.rf_fs)
    left = tx.tone(cfg.rf_fs, 1000.0, n)
    right = tx.tone(cfg.rf_fs, 2500.0, n)
    cap = tx.synthesize_capture(cfg, seconds=0.6, left=left, right=right)
    rx = Receiver(0, stereo=True)
    out, _ = rx.run(cap)
    skip = cfg.audio_fs // 4  # PLL lock + filter warm-up
    l = np.asarray(out["left"])
    r = np.asarray(out["right"])
    sep_l = stereo_separation_db(l, r, cfg.audio_fs, 1000.0, skip=skip)
    sep_r = stereo_separation_db(r, l, cfg.audio_fs, 2500.0, skip=skip)
    assert sep_l > 12.0, f"left separation {sep_l:.1f} dB"
    assert sep_r > 12.0, f"right separation {sep_r:.1f} dB"
    # and each channel actually carries its tone
    assert tone_snr_db(l, cfg.audio_fs, 1000.0, skip=skip) > 15.0
    assert tone_snr_db(r, cfg.audio_fs, 2500.0, skip=skip) > 15.0


def test_stereo_mono_compatibility():
    """A stereo broadcast's (L+R)/2 appears on the mono output too."""
    cfg = MODES[0]
    n = int(0.3 * cfg.rf_fs)
    t = tx.tone(cfg.rf_fs, 1200.0, n)
    cap = tx.synthesize_capture(cfg, seconds=0.3, left=t, right=t)
    rx = Receiver(0, stereo=True)
    out, _ = rx.run(cap)
    snr = tone_snr_db(np.asarray(out["mono"]), cfg.audio_fs, 1200.0,
                      skip=cfg.audio_fs // 10)
    assert snr > 25.0


def test_batched_channels_match_single():
    """Two RF channels batched == each run alone (DP correctness)."""
    cfg = MODES[0]
    n = int(0.1 * cfg.rf_fs)
    cap_a = tx.synthesize_capture(cfg, seconds=0.1,
                                  mono=tx.tone(cfg.rf_fs, 800.0, n))
    cap_b = tx.synthesize_capture(cfg, seconds=0.1,
                                  mono=tx.tone(cfg.rf_fs, 1700.0, n), seed=7)
    rx = Receiver(0)
    batched = np.stack([cap_a, cap_b])
    ob, _ = rx.run(batched)
    oa, _ = rx.run(cap_a)
    np.testing.assert_allclose(np.asarray(ob["mono"][0]),
                               np.asarray(oa["mono"]), atol=1e-6)


def test_noise_robustness():
    """Receiver still recovers audio at moderate RF SNR."""
    cfg = MODES[0]
    n = int(0.3 * cfg.rf_fs)
    mono = tx.tone(cfg.rf_fs, 1000.0, n)
    cap = tx.synthesize_capture(cfg, seconds=0.3, mono=mono, noise_db=-30.0)
    rx = Receiver(0)
    out, _ = rx.run(cap)
    snr = tone_snr_db(np.asarray(out["mono"]), cfg.audio_fs, 1000.0,
                      skip=cfg.audio_fs // 10)
    assert snr > 15.0


def test_stereo_separation_chunked_pll():
    """The chunk-vectorized PLL engine preserves stereo quality."""
    cfg = MODES[0]
    n = int(0.5 * cfg.rf_fs)
    left = tx.tone(cfg.rf_fs, 1000.0, n)
    right = tx.tone(cfg.rf_fs, 2500.0, n)
    cap = tx.synthesize_capture(cfg, seconds=0.5, left=left, right=right)
    rx = Receiver(0, stereo=True, pll_impl="chunked")
    out, _ = rx.run(cap)
    skip = cfg.audio_fs // 4
    sep = stereo_separation_db(np.asarray(out["left"]),
                               np.asarray(out["right"]),
                               cfg.audio_fs, 1000.0, skip=skip)
    assert sep > 12.0, f"chunked-PLL separation {sep:.1f} dB"


def test_arctan_demod_receiver():
    """The arctan demod option (golden model P1) recovers audio too — and at
    high deviation it is the *more* linear demodulator."""
    cfg = MODES[0]
    n = int(0.25 * cfg.rf_fs)
    cap = tx.synthesize_capture(cfg, seconds=0.25,
                                mono=tx.tone(cfg.rf_fs, 1000.0, n))
    rx = Receiver(0, demod="arctan")
    out, _ = rx.run(cap)
    snr = tone_snr_db(np.asarray(out["mono"]), cfg.audio_fs, 1000.0,
                      skip=cfg.audio_fs // 10)
    assert snr > 25.0, f"arctan demod SNR {snr:.1f} dB"


def test_compat_shared_audio_state():
    """The compat flag reproduces the reference's cross-contaminated
    audio_state (src/project.cpp:146,172): outputs must differ from the
    fixed version but the defective threading must be self-consistent
    (split-invariant)."""
    cfg = MODES[0]
    n = int(0.2 * cfg.rf_fs)
    left = tx.tone(cfg.rf_fs, 1000.0, n)
    cap = tx.synthesize_capture(cfg, seconds=0.2, left=left, right=left)
    fixed = Receiver(0, stereo=True)
    compat = Receiver(0, stereo=True, compat_shared_audio_state=True)
    o_fix, _ = fixed.run(cap, blocks_per_step=1)
    o_c1, _ = compat.run(cap, blocks_per_step=1)
    o_c1b, _ = compat.run(cap, blocks_per_step=1)
    # defect changes the output (state cross-contamination is real)
    assert not np.allclose(np.asarray(o_fix["left"]), np.asarray(o_c1["left"]),
                           atol=1e-4)
    # and is deterministic; note it is inherently block-size-dependent
    # (that is precisely the defect), so no split-invariance here
    np.testing.assert_allclose(np.asarray(o_c1["left"]),
                               np.asarray(o_c1b["left"]), atol=0)


@pytest.mark.parametrize("variant", ["f32", "bf16"])
def test_fused_frontend_end_to_end(variant):
    """Fused front-end kernel through the whole mono chain, with f32 and
    with bf16 FIR stages downstream (the bf16 profile also stores the fm
    stream at bf16): fidelity against the plain path at each profile's
    precision, tone SNR above the FM demod distortion floor."""
    from sdr_tpu.utils.compare import stream_snr_db
    cfg = MODES[0]
    n = int(0.15 * cfg.rf_fs)
    cap = tx.synthesize_capture(cfg, seconds=0.15,
                                mono=tx.tone(cfg.rf_fs, 1000.0, n))
    direct = Receiver(0)
    fused = Receiver(0, fused_frontend=True, conv_dtype=variant)
    od, _ = direct.run(cap)
    with interpret_kernels():
        of, _ = fused.run(cap)
    snr_fidelity = stream_snr_db(np.asarray(of["mono"]),
                                 np.asarray(od["mono"]), skip=100)
    floor = 90.0 if variant == "f32" else 40.0
    assert snr_fidelity > floor, f"{variant}: {snr_fidelity:.1f} dB vs direct"
    snr_tone = tone_snr_db(np.asarray(of["mono"]), cfg.audio_fs, 1000.0,
                           skip=cfg.audio_fs // 10)
    assert snr_tone > 25.0


def test_stereo_with_fused_frontend():
    """Stereo decode through the fused front-end kernel with the chunked
    PLL."""
    cfg = MODES[0]
    n = int(0.4 * cfg.rf_fs)
    cap = tx.synthesize_capture(cfg, seconds=0.4,
                                left=tx.tone(cfg.rf_fs, 1000.0, n),
                                right=tx.tone(cfg.rf_fs, 2500.0, n))
    rx = Receiver(0, stereo=True, fused_frontend=True, pll_impl="chunked")
    with interpret_kernels():
        out, _ = rx.run(cap)
    skip = cfg.audio_fs // 4
    sep = stereo_separation_db(np.asarray(out["left"]),
                               np.asarray(out["right"]),
                               cfg.audio_fs, 1000.0, skip=skip)
    assert sep > 12.0, f"fused+chunked separation {sep:.1f} dB"


@pytest.mark.parametrize("mode", [0, 2])
def test_fft_filter_engine_matches_direct(mode):
    """The FFT overlap-save engine is interchangeable with the direct
    polyphase engine across the whole receiver — including mode 2's
    rational 147/800 audio stage (U>1 spectral replication)."""
    from sdr_tpu.utils.compare import stream_snr_db
    cfg = MODES[mode]
    n = int(0.15 * cfg.rf_fs)
    cap = tx.synthesize_capture(cfg, seconds=0.15,
                                left=tx.tone(cfg.rf_fs, 1000.0, n),
                                right=tx.tone(cfg.rf_fs, 2500.0, n))
    od, _ = Receiver(mode, stereo=True).run(cap)
    of, _ = Receiver(mode, stereo=True, filter_engine="fft").run(cap)
    for key in ("mono", "left", "right"):
        snr = stream_snr_db(np.asarray(of[key]), np.asarray(od[key]),
                            skip=100)
        assert snr > 70.0, f"{key}: fft vs direct {snr:.1f} dB"


def test_stereo_phase_adjust_compensates_sin_convention():
    """A capture whose 38 kHz subcarrier is in *sine* convention (90 deg from
    what the cos-locking loop recovers) nulls the stereo product — and the
    stereo_phase_adjust trim restores it."""
    cfg = MODES[0]
    n = int(0.5 * cfg.rf_fs)
    t = np.arange(n) / cfg.rf_fs
    left = tx.tone(cfg.rf_fs, 1000.0, n)
    right = -left  # pure L-R content
    # hand-build a sin-convention multiplex: cos pilot, SIN subcarrier
    theta = 2 * np.pi * 19e3 * t
    m = (0.45 * (left + right) / 2 + 0.1 * np.cos(theta)
         + 0.45 * ((left - right) / 2) * np.sin(2 * theta))
    i, q = tx.fm_modulate(m, cfg.rf_fs)
    cap = tx.to_u8_iq(i, q, dither=np.random.default_rng(0))
    cap = cap[: (len(cap) // (2 * cfg.rf_decim * cfg.audio_decim))
              * 2 * cfg.rf_decim * cfg.audio_decim]
    skip = cfg.audio_fs // 4

    out0, _ = Receiver(0, stereo=True).run(cap)
    power_unadj = float(np.mean(np.asarray(out0["left"])[skip:] ** 2))
    outc, _ = Receiver(0, stereo=True,
                       stereo_phase_adjust=np.pi / 2).run(cap)
    power_adj = float(np.mean(np.asarray(outc["left"])[skip:] ** 2))
    # quadrature mismatch nulls the product; the trim restores >10x power
    assert power_adj > 10 * power_unadj


def test_timeshard_with_fused_frontend():
    """Halo-exchange time sharding composes with the fused u8 front-end
    kernel (the carried tail is raw u8 either way)."""
    import jax
    from sdr_tpu.parallel.mesh import make_mesh
    from sdr_tpu.parallel.timeshard import timesharded_mono
    if len(jax.devices()) < 4:
        import pytest as _pytest
        _pytest.skip("needs multi-device mesh")
    cfg = MODES[0]
    rx = Receiver(0, fused_frontend=True)
    mesh = make_mesh(4, "time")
    align = 4 * 2 * cfg.rf_decim * cfg.audio_decim
    n = ((int(0.2 * cfg.rf_fs) * 2) // align) * align
    cap = tx.synthesize_capture(cfg, seconds=n / 2 / cfg.rf_fs,
                                mono=tx.tone(cfg.rf_fs, 900.0, n // 2))[:n]
    with interpret_kernels():
        audio_p = timesharded_mono(rx, cap, mesh)
        serial, _ = rx.run(cap)
    np.testing.assert_allclose(np.asarray(audio_p),
                               np.asarray(serial["mono"]), atol=2e-5)


@pytest.mark.slow
def test_long_stream_stability():
    """Wrapped-phase PLL and state carries stay stable over a long stream:
    stereo separation in the final second matches the first (no float32
    drift — the failure mode of the reference's unbounded trigOffset,
    SURVEY §7 hard-part 6)."""
    cfg = MODES[0]
    seconds = 3.0
    n = int(seconds * cfg.rf_fs)
    left = tx.tone(cfg.rf_fs, 1000.0, n)
    right = tx.tone(cfg.rf_fs, 2500.0, n)
    cap = tx.synthesize_capture(cfg, seconds=seconds, left=left, right=right)
    rx = Receiver(0, stereo=True)
    out, _ = rx.run(cap, blocks_per_step=8)
    l = np.asarray(out["left"])
    r = np.asarray(out["right"])
    fs = cfg.audio_fs
    sep_early = stereo_separation_db(l[fs // 2: fs + fs // 2],
                                     r[fs // 2: fs + fs // 2], fs, 1000.0)
    sep_late = stereo_separation_db(l[-fs:], r[-fs:], fs, 1000.0)
    assert sep_late > sep_early - 3.0, (
        f"separation degraded: {sep_early:.1f} -> {sep_late:.1f} dB")


@pytest.mark.slow
def test_stereo_matches_cpp_oracle():
    """Full C++-semantics stereo oracle: scipy front-end + reference-exact
    scalar PLL (pll_reference) + mixer/matrix, vs the receiver in
    compat_pll mode.  In lock the tracking loop contracts numeric
    differences, so float32 vs float64 agree closely after acquisition."""
    import scipy.signal as sps
    from sdr_tpu.ops import firdes
    from sdr_tpu.ops.pll import pll_reference
    from sdr_tpu.utils.compare import stream_snr_db

    cfg = MODES[0]
    secs = 0.15
    n = int(secs * cfg.rf_fs)
    cap = tx.synthesize_capture(cfg, seconds=secs,
                                left=tx.tone(cfg.rf_fs, 1000.0, n),
                                right=tx.tone(cfg.rf_fs, 2500.0, n))
    rx = Receiver(0, stereo=True, compat_pll=True)
    out, _ = rx.run(cap)

    # ---- numpy oracle with the reference's C++ semantics ----
    iq = (cap.astype(np.float64) - 128.0) / 128.0
    rf = firdes.lowpass(cfg.rf_fs, cfg.rf_fc, cfg.rf_taps, 1).astype(np.float64)
    i_ds = sps.lfilter(rf, 1.0, iq[0::2])[::cfg.rf_decim]
    q_ds = sps.lfilter(rf, 1.0, iq[1::2])[::cfg.rf_decim]
    di = np.diff(i_ds, prepend=0.0)
    dq = np.diff(q_ds, prepend=0.0)
    den = i_ds**2 + q_ds**2
    demod = np.where(den == 0, 0.0,
                     (i_ds * dq - q_ds * di) / np.where(den == 0, 1, den))
    af = firdes.lowpass(cfg.if_fs, cfg.audio_fc, cfg.audio_taps,
                        1).astype(np.float64)
    mono = sps.lfilter(af, 1.0, demod)[::cfg.audio_decim]
    mono_shift = np.concatenate([np.zeros(cfg.mono_delay),
                                 mono[:-cfg.mono_delay]])
    bp_ch = firdes.bandpass(cfg.if_fs, cfg.stereo_lo, cfg.stereo_hi,
                            cfg.bp_taps).astype(np.float64)
    bp_pl = firdes.bandpass(cfg.if_fs, cfg.pilot_lo, cfg.pilot_hi,
                            cfg.bp_taps).astype(np.float64)
    channel = sps.lfilter(bp_ch, 1.0, demod)
    pilot = sps.lfilter(bp_pl, 1.0, demod)
    nco, _ = pll_reference(pilot.astype(np.float32), 19000.0, cfg.if_fs,
                           2.0, 0.0, 0.01, (0.0, 0.0, 1.0, 0.0, 0.0))
    mixed = 2.0 * channel * nco.astype(np.float64)
    stereo = sps.lfilter(af, 1.0, mixed)[::cfg.audio_decim]
    left_ref = (mono_shift + stereo) * 0.5

    left = np.asarray(out["left"], np.float64)
    m = min(len(left), len(left_ref))
    skip = 2000  # past the PLL acquisition transient
    snr = stream_snr_db(left[skip:m], left_ref[skip:m])
    assert snr > 30.0, f"compat stereo vs C++ oracle: {snr:.1f} dB"


def test_random_block_split_invariance(rng):
    """State-carry fidelity under arbitrary (aligned) step sizes: a random
    sequence of differently-sized steps equals one single-shot run."""
    cfg = MODES[0]
    rx = Receiver(0, stereo=True)
    n = int(0.12 * cfg.rf_fs)
    cap = tx.synthesize_capture(cfg, seconds=0.12,
                                left=tx.tone(cfg.rf_fs, 1000.0, n),
                                right=tx.tone(cfg.rf_fs, 2000.0, n))
    align = rx.block_align_u8()
    total = (len(cap) // align) * align
    cap = cap[:total]
    full, _ = rx.run(cap, blocks_per_step=1)

    import jax
    state = rx.init_state()
    step = jax.jit(rx.step)
    pos, chunks = 0, []
    while pos < total:
        k = int(rng.integers(1, 7))
        size = min(k * align, total - pos)
        state, out = step(state, cap[pos: pos + size])
        chunks.append(np.asarray(out["left"]))
        pos += size
    joined = np.concatenate(chunks)
    ref = np.asarray(full["left"])[: len(joined)]
    np.testing.assert_allclose(joined, ref, atol=2e-5)


def test_deemphasis_attenuates_treble():
    """75 us de-emphasis: ~unity at 100 Hz, strong cut at 10 kHz
    (|H| = 1/sqrt(1+(2*pi*f*tau)^2) -> ~ -13.5 dB at 10 kHz)."""
    from sdr_tpu.utils.compare import band_power_db
    cfg = MODES[0]
    n = int(0.3 * cfg.rf_fs)
    mono = (tx.tone(cfg.rf_fs, 200.0, n) + tx.tone(cfg.rf_fs, 10000.0, n)) / 2
    cap = tx.synthesize_capture(cfg, seconds=0.3, mono=mono)
    flat, _ = Receiver(0).run(cap)
    de, _ = Receiver(0, deemphasis_us=75.0).run(cap)
    skip = cfg.audio_fs // 10
    a_flat = np.asarray(flat["mono"])
    a_de = np.asarray(de["mono"])
    drop_lo = (band_power_db(a_flat, cfg.audio_fs, 200.0, skip=skip)
               - band_power_db(a_de, cfg.audio_fs, 200.0, skip=skip))
    drop_hi = (band_power_db(a_flat, cfg.audio_fs, 10000.0, skip=skip)
               - band_power_db(a_de, cfg.audio_fs, 10000.0, skip=skip))
    assert drop_lo < 3.0, f"low band dropped {drop_lo:.1f} dB"
    assert 9.0 < drop_hi < 18.0, f"10 kHz dropped {drop_hi:.1f} dB"


def test_rssi_metering():
    """emit_rssi reports the channelized envelope power: a strong capture
    reads near 0 dBFS, an attenuated one ~20 dB lower."""
    cfg = MODES[0]
    n = int(0.05 * cfg.rf_fs)
    mono = tx.tone(cfg.rf_fs, 1000.0, n)
    strong = tx.synthesize_capture(cfg, seconds=0.05, mono=mono, amplitude=0.9)
    weak = tx.synthesize_capture(cfg, seconds=0.05, mono=mono, amplitude=0.09)
    rx = Receiver(0, emit_rssi=True)
    o_s, _ = rx.run(strong)
    o_w, _ = rx.run(weak)
    rssi_s = float(np.mean(np.asarray(o_s["rssi_db"])))
    rssi_w = float(np.mean(np.asarray(o_w["rssi_db"])))
    assert 15.0 < rssi_s - rssi_w < 25.0, (rssi_s, rssi_w)


def test_stereo_rds_ff_pll():
    """The feedforward carrier-recovery engine (pll_impl='ff') preserves
    stereo separation and RDS decode — the round-3 production engine."""
    from sdr_tpu.rds import decode_rds_soft
    from sdr_tpu.rds import tx as rds_tx

    cfg = MODES[0]
    sec = 0.8
    n = int(sec * cfg.rf_fs)
    bits = rds_tx.standard_group_stream(pi=0x3D44, ps_name="SDR FM  ",
                                        n_groups=12)
    cap = tx.synthesize_capture(
        cfg, seconds=sec, left=tx.tone(cfg.rf_fs, 1000.0, n),
        right=tx.tone(cfg.rf_fs, 2500.0, n),
        rds_baseband=rds_tx.bits_to_baseband(bits, cfg.rf_fs)[:n], a_rds=0.1)
    rx = Receiver(0, stereo=True, rds=True, pll_impl="ff")
    out, _ = rx.run(cap)
    skip = cfg.audio_fs // 4
    sep = stereo_separation_db(np.asarray(out["left"]),
                               np.asarray(out["right"]),
                               cfg.audio_fs, 1000.0, skip=skip)
    assert sep > 15.0, f"ff-PLL separation {sep:.1f} dB"
    info = decode_rds_soft(np.asarray(out["rds_soft"]), cfg.rds_sps)
    assert info.pi == 0x3D44 and info.groups_seen >= 4


def test_mixed_engine_state_dtypes_stable():
    """Mixed engine configs (the fast set, which stores the fm stream at
    bf16, with either FIR engine; bf16 FIRs on the plain front end) must
    produce step-output state dtypes that MATCH init_state dtypes — a
    disagreement forces a second jit trace and means the materialization
    policy is inconsistent."""
    from sdr_tpu import tx
    from sdr_tpu.config import MODES
    from sdr_tpu.models.receiver import Receiver

    cfg = MODES[0]
    configs = [
        FAST,                                        # --fast on a GPU
        dict(FAST, conv_engine="tiled"),             # fast + tiled FIRs
        dict(pll_impl="ff", conv_dtype="bf16"),      # --fast on the CPU
    ]
    for kw in configs:
        rx = Receiver(0, stereo=True, rds=True, **kw)
        bs = rx.block_size_u8()
        cap = tx.synthesize_capture(cfg, seconds=2 * bs / 2 / cfg.rf_fs,
                                    mono=tx.tone(cfg.rf_fs, 1000.0, bs))
        st0 = rx.init_state()
        with interpret_kernels():
            st1, _ = rx.step(st0, jnp.asarray(cap[:bs]))
        d0 = jax.tree.map(lambda l: jnp.asarray(l).dtype, st0)
        d1 = jax.tree.map(lambda l: jnp.asarray(l).dtype, st1)
        assert jax.tree.all(jax.tree.map(lambda a, b: a == b, d0, d1)), (
            kw, d0, d1)


def test_run_flushes_trailing_remainder():
    """run() processes the capture tail at the finest aligned block size
    instead of dropping up to a whole (coarsely aligned) step: a capture
    sized as an odd multiple of block_align_u8 yields the same output
    length at blocks_per_step=4 as at blocks_per_step=1."""
    rx = Receiver(0, **FAST)
    align = rx.block_align_u8()
    n = 9 * align  # not a multiple of block_size_u8(4)
    assert n % rx.block_size_u8(4) != 0
    cap = tx.synthesize_capture(MODES[0], seconds=n / 2 / MODES[0].rf_fs,
                                mono=tx.tone(MODES[0].rf_fs, 800.0, n))[:n]
    with interpret_kernels():
        o1, s1 = rx.run(cap, blocks_per_step=1)
        o4, s4 = rx.run(cap, blocks_per_step=4)
    assert o1["mono"].shape == o4["mono"].shape
    np.testing.assert_allclose(np.asarray(o4["mono"]), np.asarray(o1["mono"]),
                               atol=2e-2)
    # final states agree too (the flush consumed the same samples)
    for a, b in zip(jax.tree.leaves(s1), jax.tree.leaves(s4)):
        assert np.asarray(a).shape == np.asarray(b).shape


def test_fast_engine_split_invariance(rng):
    """Split-invariance of the fast engine set (fused front-end kernel +
    feedforward carriers + bf16 FIRs with the bf16 fm stream): a random
    sequence of aligned step sizes equals one single-shot run — the state
    carry (raw u8 front-end tail, discriminator carry, bf16 FIR tails, ff
    phase track) is exact."""
    cfg = MODES[0]
    rx = Receiver(0, stereo=True, rds=True, **FAST)
    align = rx.block_align_u8()
    n_u8 = 8 * align
    n = n_u8 // 2
    cap = tx.synthesize_capture(cfg, seconds=n / cfg.rf_fs,
                                left=tx.tone(cfg.rf_fs, 1000.0, n),
                                right=tx.tone(cfg.rf_fs, 2000.0, n))[:n_u8]
    with interpret_kernels():
        full, _ = rx.run(cap, blocks_per_step=1)

    state = rx.init_state()
    step = jax.jit(rx.step)
    pos, chunks = 0, {"left": [], "rds_soft": []}
    while pos < n_u8:
        k = int(rng.integers(1, 4))
        size = min(k * align, n_u8 - pos)
        with interpret_kernels():
            state, out = step(state, cap[pos: pos + size])
        for key in chunks:
            chunks[key].append(np.asarray(out[key], np.float32))
        pos += size
    for key, atol in (("left", 5e-3), ("rds_soft", 5e-3)):
        joined = np.concatenate(chunks[key])
        ref = np.asarray(full[key], np.float32)[: len(joined)]
        scale = max(np.abs(ref).max(), 1e-6)
        np.testing.assert_allclose(joined, ref, atol=atol * scale)


def test_mode2_fast_stereo_rds():
    """Mode 2 (44.1 kHz rational audio 147/800, RDS SPS=35, rf_decim 10)
    on the fast engine set: quality gates hold."""
    from sdr_tpu.rds import decode_rds_soft
    from sdr_tpu.rds import tx as rds_tx
    from sdr_tpu.utils.compare import stereo_separation_db

    cfg = MODES[2]
    sec = 0.7
    n = int(sec * cfg.rf_fs)
    bits = rds_tx.standard_group_stream(pi=0x3D44, ps_name="MODE2   ",
                                        n_groups=10)
    cap = tx.synthesize_capture(
        cfg, seconds=sec, left=tx.tone(cfg.rf_fs, 1000.0, n),
        right=tx.tone(cfg.rf_fs, 2500.0, n),
        rds_baseband=rds_tx.bits_to_baseband(bits, cfg.rf_fs)[:n], a_rds=0.1)
    rx = Receiver(2, stereo=True, rds=True, **FAST)
    with interpret_kernels():
        out, _ = rx.run(cap, blocks_per_step=2)
    skip = cfg.audio_fs // 4
    sep = stereo_separation_db(np.asarray(out["left"]),
                               np.asarray(out["right"]),
                               cfg.audio_fs, 1000.0, skip=skip)
    assert sep > 15.0, f"mode-2 fast separation {sep:.1f} dB"
    info = decode_rds_soft(np.asarray(out["rds_soft"]), cfg.rds_sps)
    assert info.pi == 0x3D44 and info.groups_seen >= 3
