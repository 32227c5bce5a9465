"""Tests for auxiliary subsystems: FFT overlap-save engine, checkpoint /
resume, PSD estimator, signal logger, and the CLI surface in-process."""

import os

import numpy as np
import pytest

import jax.numpy as jnp

from sdr_tpu.config import MODES
from sdr_tpu.models.receiver import Receiver
from sdr_tpu.ops import firdes
from sdr_tpu.ops.fft_conv import OverlapSaveFIR
from sdr_tpu.ops.fourier import dft, estimate_psd, fft, idft
from sdr_tpu.ops.resample import PolyphaseResampler
from sdr_tpu.utils.checkpoint import load_state, save_state
from sdr_tpu import tx


# ------------------------------------------------------------ fft overlap-save
@pytest.mark.parametrize("down", [1, 5, 10])
def test_overlap_save_matches_direct(down, rng):
    coeff = firdes.lowpass(2.4e6, 100e3, 51, 1)
    direct = PolyphaseResampler(coeff, 1, down)
    ols = OverlapSaveFIR(coeff, down)
    td, to = direct.init_state(), ols.init_state()
    for _ in range(3):
        x = rng.standard_normal(1000).astype(np.float32)
        yd, td = direct(x, td)
        yo, to = ols(x, to)
        np.testing.assert_allclose(np.asarray(yo), np.asarray(yd),
                                   rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("up,down,n", [
    (147, 800, 1600),   # mode 2 audio rational resampler
    (441, 2560, 5120),  # mode 3
    (19, 120, 1920),    # mode 0 RDS resampler
    (7, 3, 120),        # upsample-dominant
])
def test_overlap_save_up_matches_direct(up, down, n, rng):
    """U>1 overlap-save (spectral replication) == polyphase filter bank,
    including multi-block state carry."""
    taps = 51 * up
    coeff = firdes.lowpass(240e3 * up, 16e3, taps, up)
    direct = PolyphaseResampler(coeff, up, down)
    ols = OverlapSaveFIR(coeff, down, up)
    assert ols.state_len == direct.state_len
    td, to = direct.init_state(), ols.init_state()
    for _ in range(3):
        x = rng.standard_normal(n).astype(np.float32)
        yd, td = direct(x, td)
        yo, to = ols(x, to)
        assert yo.shape == yd.shape
        np.testing.assert_allclose(np.asarray(yo), np.asarray(yd),
                                   rtol=2e-4, atol=2e-5)


# ----------------------------------------------------------------- transforms
def test_dft_idft_roundtrip(rng):
    x = rng.standard_normal(64).astype(np.float32)
    np.testing.assert_allclose(np.asarray(idft(dft(x))).real, x,
                               atol=1e-4)


def test_dft_matches_fft(rng):
    x = rng.standard_normal(128).astype(np.float32)
    np.testing.assert_allclose(np.asarray(dft(x)), np.asarray(fft(x)),
                               rtol=1e-3, atol=1e-3)


def test_psd_peak_at_tone():
    fs = 48000.0
    t = np.arange(8192) / fs
    x = np.sin(2 * np.pi * 6000.0 * t).astype(np.float32)
    freq, psd = estimate_psd(jnp.asarray(x), nfft=512, fs=fs)
    peak_freq = freq[int(np.argmax(np.asarray(psd)))]
    assert abs(peak_freq - 6000.0) < fs / 512


# ----------------------------------------------------------------- checkpoint
def test_checkpoint_roundtrip(tmp_path):
    cfg = MODES[0]
    rx = Receiver(0, stereo=True)
    n = int(0.05 * cfg.rf_fs)
    cap = tx.synthesize_capture(cfg, seconds=0.05,
                                mono=tx.tone(cfg.rf_fs, 700.0, n))
    half = len(cap) // 2 // rx.block_size_u8() * rx.block_size_u8()

    # run first half, checkpoint, resume, run second half
    out1, st = rx.run(cap[:half])
    path = str(tmp_path / "state.npz")
    save_state(path, st)
    st2 = load_state(path, rx.init_state())
    out2, _ = rx.run(cap[half: 2 * half], state=st2)

    # equals the uninterrupted run
    full, _ = rx.run(cap[: 2 * half])
    joined = np.concatenate([np.asarray(out1["mono"]), np.asarray(out2["mono"])])
    np.testing.assert_allclose(joined, np.asarray(full["mono"]), atol=1e-6)


def test_checkpoint_shape_mismatch(tmp_path):
    rx = Receiver(0)
    path = str(tmp_path / "state.npz")
    save_state(path, rx.init_state())
    with pytest.raises(ValueError):
        load_state(path, rx.init_state((4,)))


def test_checkpoint_treedef_mismatch(tmp_path):
    """A structurally different pytree with identical leaf shapes must be
    rejected by the stored-treedef check, not loaded silently."""
    path = str(tmp_path / "state.npz")
    save_state(path, {"a": np.zeros(3), "b": np.ones(3)})
    with pytest.raises(ValueError, match="structure mismatch"):
        load_state(path, {"x": np.zeros(3), "y": np.ones(3)})


def test_checkpoint_same_structure_different_container(tmp_path):
    """Validation is structural (leaf key paths), NOT `str(treedef)` reprs:
    two containers whose treedef reprs differ but whose leaf key paths match
    (dict vs collections.OrderedDict) must interchange cleanly, while a tuple
    with the same leaves must be rejected (different key paths)."""
    import collections
    path = str(tmp_path / "state.npz")
    save_state(path, {"a": np.arange(3.0), "b": np.ones(2)})
    od = collections.OrderedDict([("a", np.zeros(3)), ("b", np.zeros(2))])
    got = load_state(path, od)
    np.testing.assert_array_equal(got["a"], np.arange(3.0))
    with pytest.raises(ValueError, match="structure mismatch"):
        load_state(path, (np.zeros(3), np.zeros(2)))


def test_checkpoint_extra_leaves_rejected(tmp_path):
    """A v1-style checkpoint (no path manifest) with MORE leaves than the
    expected state must not load silently truncated."""
    path = str(tmp_path / "state.npz")
    arrays = {f"leaf_{i}": np.zeros(3) for i in range(3)}
    with open(path, "wb") as f:
        np.savez(f, **arrays)
    with pytest.raises(ValueError, match="more than the expected"):
        load_state(path, {"a": np.zeros(3), "b": np.zeros(3)})


# ------------------------------------------------------------------ logger
def test_log_vector(tmp_path):
    from sdr_tpu.io.logger import gen_index_vector, log_vector
    y = np.array([1.0, 2.5, -3.0])
    base = str(tmp_path / "trace")
    log_vector(base, gen_index_vector(3), y)
    lines = open(base + ".dat").read().strip().splitlines()
    assert lines[0].startswith("#")
    assert len(lines) == 4
    assert "2.50000" in lines[2]


# ------------------------------------------------------------------ CLI
def test_cli_mono_end_to_end(tmp_path):
    from sdr_tpu.cli import main

    cfg = MODES[0]
    n = int(0.1 * cfg.rf_fs)
    cap = tx.synthesize_capture(cfg, seconds=0.1,
                                mono=tx.tone(cfg.rf_fs, 1000.0, n))
    inp = str(tmp_path / "cap.raw")
    outp = str(tmp_path / "audio.raw")
    wavp = str(tmp_path / "audio.wav")
    psdp = str(tmp_path / "psd")
    ckpt = str(tmp_path / "state.npz")
    cap.tofile(inp)
    rc = main(["0", "1", "--in", inp, "--out", outp, "--wav", wavp,
               "--psd-dump", psdp, "--save-state", ckpt, "--stats"])
    assert rc == 0
    audio = np.fromfile(outp, dtype="<i2")
    assert len(audio) > 1000 and np.abs(audio).max() > 1000
    assert os.path.exists(wavp)
    assert os.path.exists(psdp + ".dat")
    assert os.path.exists(ckpt)
    # resume from the checkpoint works
    rc = main(["0", "1", "--in", inp, "--out", outp, "--resume", ckpt])
    assert rc == 0


def test_cli_invalid_mode():
    from sdr_tpu.cli import main
    assert main(["9", "1"]) == 1


def test_cli_multi_station(tmp_path):
    from sdr_tpu.cli import main

    cfg = MODES[0]
    n = int(0.08 * cfg.rf_fs)
    paths = []
    for i, f in enumerate([900.0, 1800.0]):
        cap = tx.synthesize_capture(cfg, seconds=0.08,
                                    mono=tx.tone(cfg.rf_fs, f, n), seed=i)
        p = str(tmp_path / f"cap{i}.raw")
        cap.tofile(p)
        paths.append(p)
    wav_dir = str(tmp_path / "wavs")
    rc = main(["0", "1", "--stations", ",".join(paths), "--wav-dir", wav_dir,
               "--blocks-per-step", "2"])
    assert rc == 0
    from sdr_tpu.io.wav import read_wav
    from sdr_tpu.utils.compare import tone_snr_db
    for i, f in enumerate([900.0, 1800.0]):
        rate, data = read_wav(os.path.join(wav_dir, f"station{i}.wav"))
        assert rate == cfg.audio_fs
        assert tone_snr_db(data.astype(np.float64), rate, f,
                           skip=1000) > 20.0


def test_cli_fast_mode(tmp_path):
    """--fast engines through the CLI surface (on the CPU: feedforward
    carriers + bf16 FIRs; the front-end kernel is GPU-only)."""
    from sdr_tpu.cli import main
    cfg = MODES[0]
    n = int(0.08 * cfg.rf_fs)
    cap = tx.synthesize_capture(cfg, seconds=0.08,
                                mono=tx.tone(cfg.rf_fs, 1000.0, n))
    inp = str(tmp_path / "cap.raw")
    outp = str(tmp_path / "audio.raw")
    cap.tofile(inp)
    rc = main(["0", "1", "--in", inp, "--out", outp, "--fast",
               "--blocks-per-step", "2"])
    assert rc == 0
    audio = np.fromfile(outp, dtype="<i2")
    assert len(audio) > 1000 and np.abs(audio).max() > 1000


def test_custom_mode_config():
    """Users can register custom modes: a 1.92 MS/s mono mode."""
    from sdr_tpu.config import ModeConfig
    cfg = ModeConfig(mode=99, rf_fs=1_920_000, rf_decim=8, audio_interp=1,
                     audio_decim=5, audio_fs=48_000, rds_sps=None)
    cfg.validate()
    n = int(0.08 * cfg.rf_fs)
    cap = tx.synthesize_capture(cfg, seconds=0.08,
                                mono=tx.tone(cfg.rf_fs, 1000.0, n))
    rx = Receiver(cfg)
    out, _ = rx.run(cap)
    from sdr_tpu.utils.compare import tone_snr_db
    assert tone_snr_db(np.asarray(out["mono"]), cfg.audio_fs, 1000.0,
                       skip=1000) > 20.0


def test_distributed_single_process_helpers():
    from sdr_tpu.parallel.distributed import initialize, local_channel_slice
    initialize(num_processes=1)  # no-op
    start, stop = local_channel_slice(8)
    assert (start, stop) == (0, 8)


def test_cli_stereo_wav_channel_order(tmp_path):
    """The WAV written by the CLI has L in column 0 (the raw stream is
    interleaved R,L per the reference, the WAV must un-swap)."""
    from sdr_tpu.cli import main
    from sdr_tpu.io.wav import read_wav
    from sdr_tpu.utils.compare import band_power_db

    cfg = MODES[0]
    n = int(0.2 * cfg.rf_fs)
    cap = tx.synthesize_capture(cfg, seconds=0.2,
                                left=tx.tone(cfg.rf_fs, 1000.0, n),
                                right=tx.tone(cfg.rf_fs, 2500.0, n))
    inp = str(tmp_path / "cap.raw")
    wavp = str(tmp_path / "st.wav")
    cap.tofile(inp)
    rc = main(["0", "2", "--in", inp, "--out", str(tmp_path / "a.raw"),
               "--wav", wavp, "--blocks-per-step", "4"])
    assert rc == 0
    rate, data = read_wav(wavp)
    l, r = data[:, 0].astype(np.float64), data[:, 1].astype(np.float64)
    skip = 2000  # capture is only ~0.2 s of audio
    # 1 kHz was the LEFT tone: stronger in column 0 than column 1
    assert (band_power_db(l, rate, 1000.0, skip=skip)
            > band_power_db(r, rate, 1000.0, skip=skip) + 6)
    assert (band_power_db(r, rate, 2500.0, skip=skip)
            > band_power_db(l, rate, 2500.0, skip=skip) + 6)


def test_cli_psd_anim(tmp_path):
    """--psd-anim writes a gnuplot index-addressable multi-frame PSD series
    (P6 animated-PSD parity, reference model/fmMonoAnim.py) and the shipped
    script renders it when gnuplot is available."""
    import shutil
    import subprocess
    from sdr_tpu.cli import main
    cfg = MODES[0]
    n = int(0.2 * cfg.rf_fs)
    cap = tx.synthesize_capture(cfg, seconds=0.2,
                                mono=tx.tone(cfg.rf_fs, 1000.0, n))
    inp = str(tmp_path / "cap.raw")
    base = str(tmp_path / "anim")
    cap.tofile(inp)
    rc = main(["0", "1", "--in", inp, "--out", str(tmp_path / "a.raw"),
               "--psd-anim", base, "--psd-anim-every", "5",
               "--blocks-per-step", "5"])
    assert rc == 0
    text = open(base + ".dat").read()
    # frames are double-blank-line separated (gnuplot `index` convention)
    frames = [f for f in text.split("\n\n\n") if "# frame" in f]
    assert len(frames) >= 10, f"expected >=10 frames, got {len(frames)}"
    # every frame is a full (freq, psd) table at IF/2 bandwidth in kHz
    for fr in frames[:3]:
        rows = [ln for ln in fr.splitlines()
                if ln and not ln.startswith("#")]
        cols = np.array([ln.split("\t") for ln in rows], dtype=np.float64)
        assert cols.shape[1] == 2
        assert abs(cols[-1, 0] - cfg.if_fs / 2e3) < cfg.if_fs / 1e3 / 256
        assert np.all(np.isfinite(cols[:, 1]))
    # the 1 kHz mono tone must appear in the demod PSD of a later frame
    freqs, psd = cols[:, 0], cols[:, 1]
    tone_bin = np.argmin(np.abs(freqs - 1.0))
    assert psd[tone_bin] > np.median(psd) + 10
    # headless render via the shipped script (skipped if gnuplot absent)
    if shutil.which("gnuplot"):
        gif = str(tmp_path / "anim.gif")
        r = subprocess.run(
            ["gnuplot", "-e",
             f"datfile='{base}.dat'; outfile='{gif}'",
             "examples/psd_anim.gnuplot"],
            capture_output=True, cwd=os.path.dirname(os.path.dirname(
                os.path.abspath(__file__))))
        assert r.returncode == 0, r.stderr.decode()
        assert os.path.getsize(gif) > 1000


def test_cli_profile_trace(tmp_path):
    """--profile writes a jax.profiler trace directory."""
    from sdr_tpu.cli import main
    cfg = MODES[0]
    n = int(0.1 * cfg.rf_fs)
    cap = tx.synthesize_capture(cfg, seconds=0.1,
                                mono=tx.tone(cfg.rf_fs, 1000.0, n))
    inp = str(tmp_path / "cap.raw")
    prof = str(tmp_path / "trace")
    cap.tofile(inp)
    rc = main(["0", "1", "--in", inp, "--out", str(tmp_path / "a.raw"),
               "--profile", prof, "--blocks-per-step", "2"])
    assert rc == 0
    assert os.path.isdir(prof) and any(os.scandir(prof))


def test_cli_multi_station_live_rds(tmp_path):
    """--stations with --rds: streaming ingest (memmap, one step at a time)
    with LIVE per-station RDS — each station reports its own PI."""
    import io
    from contextlib import redirect_stderr
    from sdr_tpu.cli import main
    from sdr_tpu.rds import tx as rds_tx

    cfg = MODES[0]
    sec = 0.6
    n = int(sec * cfg.rf_fs)
    paths = []
    for i in range(2):
        bits = rds_tx.standard_group_stream(pi=0x4400 + i, n_groups=10)
        cap = tx.synthesize_capture(
            cfg, seconds=sec, mono=tx.tone(cfg.rf_fs, 900.0 + 600 * i, n),
            rds_baseband=rds_tx.bits_to_baseband(bits, cfg.rf_fs)[:n],
            a_rds=0.12, seed=i)
        p = str(tmp_path / f"cap{i}.raw")
        cap.tofile(p)
        paths.append(p)
    wav_dir = str(tmp_path / "wavs")
    err = io.StringIO()
    with redirect_stderr(err):
        rc = main(["0", "1", "--rds", "--stations", ",".join(paths),
                   "--wav-dir", wav_dir, "--blocks-per-step", "8"])
    assert rc == 0
    log = err.getvalue()
    assert "station 0 RDS: PI=0x4400" in log
    assert "station 1 RDS: PI=0x4401" in log
    # live lines appear before the final summary
    assert log.index("RDS: PI=0x4400") < log.index("RDS final")


def test_cli_trace_iq(tmp_path):
    """--trace-iq dumps 4 time-domain .dat stage traces of the first block
    (reference data/iq.gnuplot + iq_filt.gnuplot workflow) and the
    pre-filter trace matches the u8 decode."""
    from sdr_tpu.cli import main

    cfg = MODES[0]
    n = int(0.1 * cfg.rf_fs)
    cap = tx.synthesize_capture(cfg, seconds=0.1,
                                mono=tx.tone(cfg.rf_fs, 1000.0, n))
    inp = str(tmp_path / "cap.raw")
    outp = str(tmp_path / "audio.raw")
    base = str(tmp_path / "trace")
    cap.tofile(inp)
    rc = main(["0", "1", "--in", inp, "--out", outp, "--trace-iq", base])
    assert rc == 0
    for suffix in ("_i_time", "_q_time", "_i_filt_time", "_q_filt_time"):
        path = base + suffix + ".dat"
        assert os.path.exists(path), path
        dat = np.loadtxt(path, skiprows=1)
        assert dat.shape == (512, 2)
    i_trace = np.loadtxt(base + "_i_time.dat", skiprows=1)[:, 1]
    expect = (cap[0:1024:2].astype(np.float32) - 128.0) / 128.0
    np.testing.assert_allclose(i_trace, expect, atol=1e-5)


def test_checkpoint_roundtrip_fast_engines(tmp_path):
    """--save-state/--resume semantics for the fast engine set, whose
    state layout differs from the default engines (raw u8 front-end tail,
    bf16 FIR tails, ff phase track): run-half + checkpoint + resume == one
    uninterrupted run."""
    from sdr_tpu import tx
    from sdr_tpu.config import MODES
    from sdr_tpu.device import interpret_kernels
    from sdr_tpu.models.receiver import Receiver

    cfg = MODES[0]
    rx = Receiver(0, stereo=True, rds=True, fused_frontend=True,
                  pll_impl="ff", conv_dtype="bf16")
    bs = rx.block_size_u8()
    cap = tx.synthesize_capture(
        cfg, seconds=4 * bs / 2 / cfg.rf_fs,
        left=tx.tone(cfg.rf_fs, 1000.0, 2 * bs),
        right=tx.tone(cfg.rf_fs, 2500.0, 2 * bs))[: 4 * bs]
    with interpret_kernels():
        full, _ = rx.run(cap, blocks_per_step=1)
        out1, st = rx.run(cap[: 2 * bs], blocks_per_step=1)
    path = str(tmp_path / "fast_state.npz")
    save_state(path, st)
    st2 = load_state(path, rx.init_state())
    with interpret_kernels():
        out2, _ = rx.run(cap[2 * bs:], blocks_per_step=1, state=st2)
    for k in ("left", "rds_soft"):
        joined = np.concatenate([np.asarray(out1[k], np.float32),
                                 np.asarray(out2[k], np.float32)])
        ref = np.asarray(full[k], np.float32)
        scale = max(np.abs(ref).max(), 1e-6)
        np.testing.assert_allclose(joined, ref, atol=1e-5 * scale)
