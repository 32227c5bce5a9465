"""Parallelism correctness on the 8-device virtual CPU mesh (SURVEY §4.3):
channel DP and time-axis halo-exchange sharding must match serial exactly."""

import jax
import numpy as np
import pytest

from sdr_tpu.config import MODES
from sdr_tpu.models.receiver import Receiver
from sdr_tpu.parallel.channels import sharded_run
from sdr_tpu.parallel.mesh import make_mesh
from sdr_tpu.parallel.timeshard import timesharded_mono, timesharded_stereo
from sdr_tpu import tx


@pytest.fixture(scope="module")
def captures():
    cfg = MODES[0]
    caps = []
    for c in range(8):
        n = int(0.05 * cfg.rf_fs)
        mono = tx.tone(cfg.rf_fs, 500.0 + 300.0 * c, n)
        caps.append(tx.synthesize_capture(cfg, seconds=0.05, mono=mono,
                                          seed=c))
    return np.stack(caps)


def test_devices_available():
    assert len(jax.devices()) == 8


def test_channel_dp_matches_serial(captures):
    rx = Receiver(0)
    mesh = make_mesh(8, "channels")
    outs, _ = sharded_run(rx, captures, mesh)
    serial, _ = rx.run(captures)
    np.testing.assert_allclose(np.asarray(outs["mono"]),
                               np.asarray(serial["mono"]), atol=1e-6)


def test_channel_dp_ragged(captures):
    """Channel counts that do not divide the mesh are padded with silent
    channels internally and sliced back — 5 stations on 8 devices."""
    rx = Receiver(0)
    mesh = make_mesh(8, "channels")
    outs, final = sharded_run(rx, captures[:5], mesh)
    serial, _ = rx.run(captures[:5])
    assert np.asarray(outs["mono"]).shape[0] == 5
    np.testing.assert_allclose(np.asarray(outs["mono"]),
                               np.asarray(serial["mono"]), atol=1e-6)


def test_channel_dp_stereo(captures):
    rx = Receiver(0, stereo=True)
    mesh = make_mesh(4, "channels")
    outs, _ = sharded_run(rx, captures[:4], mesh)
    serial, _ = rx.run(captures[:4])
    np.testing.assert_allclose(np.asarray(outs["left"]),
                               np.asarray(serial["left"]), atol=1e-5)


@pytest.mark.parametrize("mode", [0, 2])
def test_timeshard_mono_exact(mode):
    """Halo-exchange time sharding == sequential scan, including the
    rational-resampler mode (phase-grid alignment, SURVEY §7 hard-part 2)."""
    cfg = MODES[mode]
    rx = Receiver(mode)
    mesh = make_mesh(8, "time")
    align = 8 * 2 * cfg.rf_decim * cfg.audio_decim
    n = ((int(0.2 * cfg.rf_fs) * 2) // align) * align
    mono = tx.tone(cfg.rf_fs, 900.0, n // 2)
    cap = tx.synthesize_capture(cfg, seconds=n / 2 / cfg.rf_fs, mono=mono)
    cap = cap[:n]
    audio_p = timesharded_mono(rx, cap, mesh)
    serial, _ = rx.run(cap)
    np.testing.assert_allclose(np.asarray(audio_p),
                               np.asarray(serial["mono"]), atol=2e-5)


@pytest.mark.slow
def test_timeshard_stereo():
    """PLL warm-up halo time-sharding of the stereo chain: behaviorally
    equivalent to the serial scan (stream SNR + stereo separation within
    tolerance after the serial lock-in transient) — extending
    timesharded_mono past its former PLL limit."""
    from sdr_tpu.parallel.timeshard import stereo_warmup_if
    from sdr_tpu.utils.compare import stereo_separation_db, stream_snr_db

    cfg = MODES[0]
    rx = Receiver(0, stereo=True)
    mesh = make_mesh(8, "time")
    warm_if = stereo_warmup_if(rx)
    # chunks must cover the warm-up halo: ~1.6 s capture -> 8 x 0.2 s chunks
    align = 8 * 2 * cfg.rf_decim * cfg.audio_decim
    n = ((int(1.6 * cfg.rf_fs) * 2) // align) * align
    left = tx.tone(cfg.rf_fs, 1000.0, n // 2)
    right = tx.tone(cfg.rf_fs, 2500.0, n // 2)
    cap = tx.synthesize_capture(cfg, seconds=n / 2 / cfg.rf_fs,
                                left=left, right=right)[:n]
    assert (n // 8) >= 2 * cfg.rf_decim * warm_if

    l_p, r_p = timesharded_stereo(rx, cap, mesh)
    serial, _ = rx.run(cap)
    l_s, r_s = np.asarray(serial["left"]), np.asarray(serial["right"])
    assert l_p.shape == l_s.shape and r_p.shape == r_s.shape

    # skip the serial cold-start lock-in (device 0 warms differently)
    skip = int(0.2 * cfg.audio_fs)
    snr_l = stream_snr_db(np.asarray(l_p), l_s, skip=skip)
    snr_r = stream_snr_db(np.asarray(r_p), r_s, skip=skip)
    assert snr_l > 30 and snr_r > 30, (snr_l, snr_r)

    # the sharded decode preserves stereo separation within 2 dB of serial
    fs = float(cfg.audio_fs)
    sep_p = stereo_separation_db(np.asarray(l_p), np.asarray(r_p), fs,
                                 1000.0, skip=skip)
    sep_s = stereo_separation_db(l_s, r_s, fs, 1000.0, skip=skip)
    assert sep_s > 20
    assert sep_p > sep_s - 2.0, (sep_p, sep_s)


def test_timeshard_mono_nondivisible(captures):
    """Capture lengths that don't divide the mesh are trimmed to the
    serial-equivalent alignment and right-padded internally — outputs
    still match the serial run exactly."""
    cfg = MODES[0]
    rx = Receiver(0)
    mesh = make_mesh(8, "time")
    align = 2 * cfg.rf_decim * cfg.audio_decim
    cap = np.asarray(captures[0])
    # length NOT divisible by 8*align and with a ragged sub-align tail
    n = len(cap) - 3 * align - 17
    cap = cap[:n]
    n_valid = (n // align) * align
    audio_p = np.asarray(timesharded_mono(rx, cap, mesh))
    assert audio_p.shape == (n_valid // align * cfg.audio_interp,)
    serial, _ = rx.run(cap[:n_valid])  # run() trims to its own block grid
    m = np.asarray(serial["mono"]).shape[-1]
    np.testing.assert_allclose(audio_p[:m], np.asarray(serial["mono"]),
                               atol=2e-5)


@pytest.mark.slow
def test_timeshard_full_stereo_rds():
    """Time-sharding the COMPLETE chain (stereo + RDS): decoded RDS groups
    match the serial run and stereo quality holds — the reference's full
    single-station capability on >1 device."""
    from sdr_tpu.parallel.timeshard import timesharded_full
    from sdr_tpu.rds import decode_rds_soft
    from sdr_tpu.rds import tx as rds_tx
    from sdr_tpu.utils.compare import stereo_separation_db

    cfg = MODES[0]
    sec = 1.2
    n = int(sec * cfg.rf_fs)
    bits = rds_tx.standard_group_stream(pi=0x5A5A, ps_name="SHARDED!",
                                        n_groups=18)
    cap = tx.synthesize_capture(
        cfg, seconds=sec, left=tx.tone(cfg.rf_fs, 1000.0, n),
        right=tx.tone(cfg.rf_fs, 2500.0, n),
        rds_baseband=rds_tx.bits_to_baseband(bits, cfg.rf_fs)[:n], a_rds=0.1)
    rx = Receiver(0, stereo=True, rds=True, pll_impl="ff")
    mesh = make_mesh(8, "time")
    l_p, r_p, soft_p = timesharded_full(rx, cap, mesh)

    serial, _ = rx.run(cap)
    skip = cfg.audio_fs // 4
    sep = stereo_separation_db(np.asarray(l_p), np.asarray(r_p),
                               cfg.audio_fs, 1000.0, skip=skip)
    assert sep > 15.0, f"sharded separation {sep:.1f} dB"

    info_p = decode_rds_soft(np.asarray(soft_p), cfg.rds_sps)
    info_s = decode_rds_soft(np.asarray(serial["rds_soft"]), cfg.rds_sps)
    assert info_s.pi == 0x5A5A and info_s.groups_seen >= 6
    assert info_p.pi == info_s.pi
    assert info_p.ps_name == info_s.ps_name
    # every serially-decoded group also decodes from the sharded stream
    # (boundary transients may cost at most one group)
    assert info_p.groups_seen >= info_s.groups_seen - 1


def test_polarity_stitch_silent_seam_warns():
    """A seam whose warm-up overlap carries no RDS energy must WARN and keep
    the running sign instead of trusting a noise-level correlation (an
    unthresholded dot product silently picked an
    arbitrary sign for squelched/faded chunks)."""
    import warnings

    from sdr_tpu.parallel.timeshard import polarity_stitch

    rng = np.random.default_rng(7)
    warm, chunk = 64, 256
    t = np.arange(warm + chunk)
    wave = np.sin(2 * np.pi * t / 16.0)
    # device 0 and 2 carry signal; device 1's overlap region is silent
    d0 = wave.copy()
    d1 = wave.copy()
    d1[warm - warm // 2:warm] = 1e-9 * rng.standard_normal(warm // 2)
    d2 = -wave.copy()  # genuine 180-degree flip vs its neighbor
    soft_all = np.stack([d0, d1, d2])

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = polarity_stitch(soft_all, warm, confidence=0.5)
    msgs = [str(w.message) for w in caught]
    assert any("seam 0->1" in m for m in msgs), msgs
    # the silent seam keeps the running (+) sign; the confident seam 1->2
    # still flips device 2 back into alignment
    assert out.shape == (3 * chunk,)
    np.testing.assert_allclose(out[chunk:2 * chunk], d1[warm:], atol=1e-12)
    np.testing.assert_allclose(out[2 * chunk:], wave[warm:], atol=1e-12)


def test_polarity_stitch_confident_flip_no_warning():
    """Confident seams resolve signs exactly as before — no warnings."""
    import warnings

    from sdr_tpu.parallel.timeshard import polarity_stitch

    warm, chunk = 64, 256
    t = np.arange(warm + chunk)
    wave = np.sin(2 * np.pi * t / 16.0)
    soft_all = np.stack([wave, -wave, wave])
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = polarity_stitch(soft_all, warm, confidence=0.5)
    assert not caught, [str(w.message) for w in caught]
    expect = np.concatenate([wave[warm:]] * 3)
    np.testing.assert_allclose(out, expect, atol=1e-12)


def test_station_sharded_wideband_matches_serial():
    """One replicated antenna stream -> 8 stations sharded over 8 devices
    (parallel/wideband.py) == the serial WidebandReceiver composition, and
    the per-device program contains ZERO collectives (the wideband
    multi-device story, on the mfb engine's column-sliced filter bank)."""
    from sdr_tpu import tx
    from sdr_tpu.config import MODES
    from sdr_tpu.models.receiver import Receiver
    from sdr_tpu.models.wideband import WidebandReceiver
    from sdr_tpu.ops.channelizer import (WidebandChannelizer,
                                         synthesize_wideband)
    from sdr_tpu.parallel.wideband import sharded_wideband_run

    cfg = MODES[0]
    fs_wide = 4 * cfg.rf_fs
    k = 8
    n_st = int(0.05 * cfg.rf_fs)
    rng = np.random.default_rng(3)

    def station(c):
        cap = tx.synthesize_capture(
            cfg, seconds=0.05,
            mono=tx.tone(cfg.rf_fs, 600.0 + 150.0 * c, n_st), seed=c)
        f = (cap.astype(np.float32) - 128.0) / 128.0
        return f[0::2] + 1j * f[1::2]

    freqs = list(np.linspace(-3.4e6, 3.4e6, k))
    iw, qw = synthesize_wideband([station(c) for c in range(k)], freqs,
                                 cfg.rf_fs, fs_wide)
    wide = np.stack([iw, qw], axis=-1).reshape(-1)
    u8 = np.clip(np.round(wide * 32.0) + 128.0, 0, 255).astype(np.uint8)

    chan = WidebandChannelizer(fs_wide, cfg.rf_fs, freqs)
    serial_out, _ = WidebandReceiver(chan, Receiver(0)).run(
        u8, blocks_per_step=1)

    mesh = make_mesh(8, "stations")
    out, final = sharded_wideband_run(chan, Receiver(0), u8, mesh,
                                      blocks_per_step=1)
    got = np.asarray(out["mono"])
    want = np.asarray(serial_out["mono"])
    np.testing.assert_allclose(got, want, atol=2e-5)

    # per-device HLO: ZERO collective ops (pure replicate-in, shard-out)
    from jax.sharding import PartitionSpec as P
    assert out["mono"].sharding.spec == P("stations")
    hlo = sharded_wideband_run.last_hlo
    for coll in ("all-reduce", "all-gather", "collective-permute",
                 "all-to-all", "reduce-scatter"):
        assert coll not in hlo, f"unexpected {coll} in per-device HLO"
