"""Wideband channelizer: one wide capture -> N stations -> batched receivers.

Beyond-reference capability test: synthesize two FM stations at offsets in a
9.6 MS/s wideband stream, channelize on-accelerator, decode both through
`Receiver.step_iq`, and verify each station's program audio.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from sdr_tpu.config import MODES
from sdr_tpu.models.receiver import Receiver
from sdr_tpu.ops.channelizer import WidebandChannelizer, synthesize_wideband
from sdr_tpu import tx
from sdr_tpu.utils.compare import tone_snr_db


def test_two_station_wideband_decode():
    cfg = MODES[0]
    fs_st = float(cfg.rf_fs)
    fs_wide = 4 * fs_st
    freqs = [-1.5e6, +1.8e6]
    tones = [900.0, 1700.0]
    secs = 0.15
    n = int(secs * fs_st)

    stations = []
    for k, tone_f in enumerate(tones):
        mono = tx.tone(fs_st, tone_f, n)
        m = tx.make_multiplex(fs_st, n, mono=mono)
        i, q = tx.fm_modulate(m, fs_st)
        stations.append((i + 1j * q) * 0.5)
    iw, qw = synthesize_wideband(stations, freqs, fs_st, fs_wide)

    chan = WidebandChannelizer(fs_wide, fs_st, freqs)
    rx = Receiver(0)
    cstate = chan.init_state()
    rstate = rx.init_state((len(freqs),))
    step_iq = jax.jit(rx.step_iq)

    block_wide = cfg.block_size_u8 // 2 * chan.decim  # one rx block per step
    audio = []
    nblocks = len(iw) // block_wide
    for b in range(nblocks):
        sl = slice(b * block_wide, (b + 1) * block_wide)
        (i_st, q_st), cstate = chan(jnp.asarray(iw[sl]), jnp.asarray(qw[sl]),
                                    cstate)
        rstate, out = step_iq(rstate, i_st, q_st)
        audio.append(np.asarray(out["mono"]))
    audio = np.concatenate(audio, axis=-1)

    assert audio.shape[0] == 2
    for k, tone_f in enumerate(tones):
        snr = tone_snr_db(audio[k], cfg.audio_fs, tone_f,
                          skip=cfg.audio_fs // 10)
        assert snr > 20.0, f"station {k} ({tone_f} Hz): SNR {snr:.1f} dB"


def test_channelizer_block_continuity():
    """Oscillator phase and filter tails carry exactly across blocks."""
    fs_wide, fs_out = 9.6e6, 2.4e6
    chan = WidebandChannelizer(fs_wide, fs_out, [1.0e6])
    rng = np.random.default_rng(0)
    n = 40000
    iw = rng.standard_normal(n).astype(np.float32)
    qw = rng.standard_normal(n).astype(np.float32)
    (i_full, q_full), _ = chan(jnp.asarray(iw), jnp.asarray(qw),
                               chan.init_state())
    st = chan.init_state()
    (i1, q1), st = chan(jnp.asarray(iw[: n // 2]), jnp.asarray(qw[: n // 2]), st)
    (i2, q2), _ = chan(jnp.asarray(iw[n // 2:]), jnp.asarray(qw[n // 2:]), st)
    np.testing.assert_allclose(
        np.asarray(i_full), np.concatenate([np.asarray(i1), np.asarray(i2)],
                                           axis=-1), atol=2e-4)
    np.testing.assert_allclose(
        np.asarray(q_full), np.concatenate([np.asarray(q1), np.asarray(q2)],
                                           axis=-1), atol=2e-4)


def test_mfb_engine_matches_mix_oracle():
    """The modulated-filter-bank engine is mathematically identical to the
    v1 mix->LPF->decimate formulation (same outputs across blocks)."""
    fs_wide, fs_out = 9.6e6, 2.4e6
    freqs = [-2.1e6, -0.3e6, 1.0e6, 3.7e6]
    mfb = WidebandChannelizer(fs_wide, fs_out, freqs, engine="mfb")
    mix = WidebandChannelizer(fs_wide, fs_out, freqs, engine="mix")
    rng = np.random.default_rng(7)
    st_a, st_b = mfb.init_state(), mix.init_state()
    for _ in range(3):
        iw = rng.standard_normal(19200).astype(np.float32)
        qw = rng.standard_normal(19200).astype(np.float32)
        (ia, qa), st_a = mfb(jnp.asarray(iw), jnp.asarray(qw), st_a)
        (ib, qb), st_b = mix(jnp.asarray(iw), jnp.asarray(qw), st_b)
        np.testing.assert_allclose(np.asarray(ia), np.asarray(ib), atol=3e-4)
        np.testing.assert_allclose(np.asarray(qa), np.asarray(qb), atol=3e-4)


def test_channelizer_rejects_nonintegral_ratio():
    with pytest.raises(AssertionError):
        WidebandChannelizer(10e6, 2.4e6, [0.0])


def test_find_stations_detects_synthesized():
    """Spectrum survey finds exactly the synthesized stations, strongest
    first, on the 100 kHz raster."""
    from sdr_tpu.ops.spectrum import find_stations
    cfg = MODES[0]
    fs_st = float(cfg.rf_fs)
    fs_wide = 4 * fs_st
    freqs = [-2.0e6, 0.5e6, 3.1e6]
    amps = [0.5, 0.25, 0.4]
    secs = 0.08
    n = int(secs * fs_st)
    stations = []
    for a, f in zip(amps, freqs):
        m = tx.make_multiplex(fs_st, n, mono=tx.tone(fs_st, 1000.0, n))
        i, q = tx.fm_modulate(m, fs_st)
        stations.append((i + 1j * q) * a)
    iw, qw = synthesize_wideband(stations, freqs, fs_st, fs_wide)
    rng = np.random.default_rng(3)
    iw = iw + 0.01 * rng.standard_normal(len(iw)).astype(np.float32)
    qw = qw + 0.01 * rng.standard_normal(len(qw)).astype(np.float32)
    found = find_stations(iw, qw, fs_wide)
    assert sorted(found) == sorted(freqs), found
    assert found[0] == -2.0e6  # strongest first


def test_find_stations_empty_on_noise():
    from sdr_tpu.ops.spectrum import find_stations
    rng = np.random.default_rng(4)
    iw = rng.standard_normal(1 << 19).astype(np.float32)
    qw = rng.standard_normal(1 << 19).astype(np.float32)
    assert find_stations(iw, qw, 9.6e6) == []


def test_cli_wideband_scan(tmp_path):
    """--wideband --scan: detect stations from the spectrum, then decode."""
    import os
    from sdr_tpu.cli import main
    from sdr_tpu.io.wav import read_wav

    cfg = MODES[0]
    fs_st = float(cfg.rf_fs)
    fs_wide = 4 * fs_st
    freqs = [-1.2e6, 1.5e6]
    secs = 0.3
    n = int(secs * fs_st)
    stations = []
    for k in range(2):
        mono = tx.tone(fs_st, 800.0 + 500.0 * k, n)
        m = tx.make_multiplex(fs_st, n, mono=mono)
        i, q = tx.fm_modulate(m, fs_st)
        stations.append((i + 1j * q) * (0.5 - 0.15 * k))
    iw, qw = synthesize_wideband(stations, freqs, fs_st, fs_wide)
    wide = np.empty(2 * len(iw), np.float32)
    wide[0::2], wide[1::2] = iw, qw
    inp = str(tmp_path / "wide.cf32")
    wide.tofile(inp)
    wav_dir = str(tmp_path / "wavs")
    rc = main(["0", "1", "--wideband", str(fs_wide), "--scan",
               "--in", inp, "--wav-dir", wav_dir, "--blocks-per-step", "4"])
    assert rc == 0
    # strongest station (index 0 after scan ordering) is the -1.2 MHz one
    rate, data = read_wav(os.path.join(wav_dir, "station0.wav"))
    snr = tone_snr_db(data.astype(np.float64), rate, 800.0, skip=2000)
    assert snr > 18.0, f"{snr:.1f} dB"


def test_cli_wideband_mode(tmp_path):
    """End-to-end wideband CLI: f32 complex capture -> station WAVs + RDS."""
    import os
    from sdr_tpu.cli import main
    from sdr_tpu.io.wav import read_wav
    from sdr_tpu.rds import tx as rds_tx

    cfg = MODES[0]
    fs_st = float(cfg.rf_fs)
    fs_wide = 4 * fs_st
    freqs = [-1.2e6, 1.5e6]
    secs = 0.6
    n = int(secs * fs_st)
    stations = []
    for k in range(2):
        bits = rds_tx.standard_group_stream(pi=0x2000 + k, n_groups=8)
        rds_bb = rds_tx.bits_to_baseband(bits, fs_st)[:n]
        mono = tx.tone(fs_st, 800.0 + 500.0 * k, n)
        m = tx.make_multiplex(fs_st, n, mono=mono, rds_baseband=rds_bb,
                              a_rds=0.1)
        i, q = tx.fm_modulate(m, fs_st)
        stations.append((i + 1j * q) * 0.5)
    iw, qw = synthesize_wideband(stations, freqs, fs_st, fs_wide)
    wide = np.empty(2 * len(iw), np.float32)
    wide[0::2], wide[1::2] = iw, qw
    inp = str(tmp_path / "wide.cf32")
    wide.tofile(inp)
    wav_dir = str(tmp_path / "wavs")
    rc = main(["0", "1", "--rds", "--wideband", str(fs_wide),
               "--freqs=" + ",".join(str(f) for f in freqs),
               "--in", inp, "--wav-dir", wav_dir, "--blocks-per-step", "4"])
    assert rc == 0
    for k in range(2):
        rate, data = read_wav(os.path.join(wav_dir, f"station{k}.wav"))
        snr = tone_snr_db(data.astype(np.float64), rate, 800.0 + 500.0 * k,
                          skip=2000)
        assert snr > 18.0, f"station {k}: {snr:.1f} dB"


# ------------------------------------------------- fused streaming receiver
def _two_station_wide(secs=0.15, a_scale=0.5):
    cfg = MODES[0]
    fs_st = float(cfg.rf_fs)
    fs_wide = 4 * fs_st
    freqs = [-1.5e6, +1.8e6]
    tones = [900.0, 1700.0]
    n = int(secs * fs_st)
    stations = []
    for tone_f in tones:
        m = tx.make_multiplex(fs_st, n, mono=tx.tone(fs_st, tone_f, n))
        i, q = tx.fm_modulate(m, fs_st)
        stations.append((i + 1j * q) * a_scale)
    iw, qw = synthesize_wideband(stations, freqs, fs_st, fs_wide)
    wide = np.empty(2 * len(iw), np.float32)
    wide[0::2], wide[1::2] = iw, qw
    return cfg, fs_wide, freqs, tones, wide


def test_wideband_receiver_matches_composition():
    """One fused scanned program (models/wideband.py) == the separate
    channelize-then-step_iq composition, bit-for-bit."""
    from sdr_tpu.models.wideband import WidebandReceiver

    cfg, fs_wide, freqs, tones, wide = _two_station_wide()
    iw, qw = wide[0::2], wide[1::2]

    chan = WidebandChannelizer(fs_wide, float(cfg.rf_fs), freqs)
    rx = Receiver(0)
    wrx = WidebandReceiver(chan, rx)
    fused, _ = wrx.run(wide, blocks_per_step=2)

    chan2 = WidebandChannelizer(fs_wide, float(cfg.rf_fs), freqs)
    cstate = chan2.init_state()
    rstate = rx.init_state((len(freqs),))
    block_wide = wrx.block_pairs * 2
    audio = []
    for b in range(len(iw) // block_wide):
        sl = slice(b * block_wide, (b + 1) * block_wide)
        (i_st, q_st), cstate = chan2(jnp.asarray(iw[sl]),
                                     jnp.asarray(qw[sl]), cstate)
        rstate, out = jax.jit(rx.step_iq)(rstate, i_st, q_st)
        audio.append(np.asarray(out["mono"]))
    serial = np.concatenate(audio, axis=-1)
    np.testing.assert_allclose(np.asarray(fused["mono"])[:, :serial.shape[1]],
                               serial, atol=1e-6)


def test_wideband_stream_chunked_equals_run():
    """stream() re-framing arbitrary reader chunk sizes == whole-capture
    run(): captures larger than RAM decode identically block-wise."""
    from sdr_tpu.models.wideband import WidebandReceiver

    cfg, fs_wide, freqs, tones, wide = _two_station_wide()
    chan = WidebandChannelizer(fs_wide, float(cfg.rf_fs), freqs)
    wrx = WidebandReceiver(chan, Receiver(0))
    whole, _ = wrx.run(wide, blocks_per_step=1)

    def awkward_chunks():
        sizes = [100001, 37, 4 * wrx.block_wide(), 999999]
        i = 0
        k = 0
        while i < len(wide):
            sz = sizes[k % len(sizes)]
            yield wide[i:i + sz]
            i += sz
            k += 1

    parts = [np.asarray(out["mono"]) for out, _ in
             wrx.stream(awkward_chunks(), scan_steps=3)]
    streamed = np.concatenate(parts, axis=-1)
    m = streamed.shape[-1]
    np.testing.assert_allclose(streamed, np.asarray(whole["mono"])[:, :m],
                               atol=1e-6)
    assert m >= whole["mono"].shape[-1] - wrx.block_pairs // chan.decim


def test_wideband_u8_input():
    """u8 interleaved wideband ingest decodes on device ((x-128)/128) and
    yields the same stations as f32 within quantization noise."""
    from sdr_tpu.models.wideband import WidebandReceiver
    from sdr_tpu.utils.compare import tone_snr_db

    cfg, fs_wide, freqs, tones, wide = _two_station_wide(a_scale=0.35)
    u8 = np.clip(np.round(wide * 128.0 + 128.0), 0, 255).astype(np.uint8)

    chan = WidebandChannelizer(fs_wide, float(cfg.rf_fs), freqs)
    wrx = WidebandReceiver(chan, Receiver(0))
    out, _ = wrx.run(u8, blocks_per_step=2)
    audio = np.asarray(out["mono"])
    for k, tone_f in enumerate(tones):
        snr = tone_snr_db(audio[k], cfg.audio_fs, tone_f,
                          skip=cfg.audio_fs // 10)
        assert snr > 20.0, f"station {k} ({tone_f} Hz): SNR {snr:.1f} dB"


def test_cli_wideband_u8(tmp_path):
    """--wideband --wideband-u8 end-to-end."""
    import os
    from sdr_tpu.cli import main
    from sdr_tpu.io.wav import read_wav
    from sdr_tpu.utils.compare import tone_snr_db

    cfg, fs_wide, freqs, tones, wide = _two_station_wide(secs=0.3,
                                                         a_scale=0.35)
    u8 = np.clip(np.round(wide * 128.0 + 128.0), 0, 255).astype(np.uint8)
    inp = str(tmp_path / "wide.u8")
    u8.tofile(inp)
    wav_dir = str(tmp_path / "wavs")
    rc = main(["0", "1", "--wideband", str(fs_wide), "--wideband-u8",
               "--freqs=" + ",".join(str(f) for f in freqs),
               "--in", inp, "--wav-dir", wav_dir, "--blocks-per-step", "4"])
    assert rc == 0
    for k, tone_f in enumerate(tones):
        rate, data = read_wav(os.path.join(wav_dir, f"station{k}.wav"))
        snr = tone_snr_db(data.astype(np.float64), rate, tone_f, skip=2000)
        assert snr > 18.0, f"station {k}: {snr:.1f} dB"


def test_mfb_bf16_close_to_f32(rng):
    """bf16 MFB conv (compute_dtype='bf16') matches the exact f32 engine to
    coefficient-rounding level — ~40+ dB station SNR, transparent under FM
    demod's ~25 dB distortion floor."""
    fs_wide, fs_st = 9.6e6, 2.4e6
    freqs = [-1.5e6, 0.0, 1.8e6]
    n = 4 * 12800
    iw = rng.standard_normal(n).astype(np.float32) * 0.2
    qw = rng.standard_normal(n).astype(np.float32) * 0.2
    ref = WidebandChannelizer(fs_wide, fs_st, freqs)
    fast = WidebandChannelizer(fs_wide, fs_st, freqs, compute_dtype="bf16")
    sr, sf = ref.init_state(), fast.init_state()
    for _ in range(2):
        (ir, qr), sr = ref(jnp.asarray(iw), jnp.asarray(qw), sr)
        (i2, q2), sf = fast(jnp.asarray(iw), jnp.asarray(qw), sf)
        for a, b in ((ir, i2), (qr, q2)):
            a, b = np.asarray(a), np.asarray(b)
            snr = 10 * np.log10(np.mean(a * a)
                                / max(np.mean((a - b) ** 2), 1e-20))
            assert snr > 35.0, f"bf16 channelizer SNR {snr:.1f} dB"


def test_mfb_interleaved_u8_ingest(rng):
    """call_interleaved on a raw u8 stream == decode-then-channelize: the
    (x-128)/128 semantics (src/iofunc.cpp:62-69) hold exactly inside the
    compute cast, with no f32 wideband materialization."""
    fs_wide, fs_st = 9.6e6, 2.4e6
    freqs = [-1.5e6, 1.8e6]
    n = 2 * 12800
    u8 = rng.integers(0, 256, size=2 * n, dtype=np.uint8)
    f = (u8.astype(np.float32) - 128.0) / 128.0
    chan_a = WidebandChannelizer(fs_wide, fs_st, freqs)
    chan_b = WidebandChannelizer(fs_wide, fs_st, freqs)
    sa, sb = chan_a.init_state(), chan_b.init_state()
    for _ in range(2):
        (ia, qa), sa = chan_a(jnp.asarray(np.ascontiguousarray(f[0::2])),
                              jnp.asarray(np.ascontiguousarray(f[1::2])), sa)
        (ib, qb), sb = chan_b.call_interleaved(jnp.asarray(u8), sb)
        np.testing.assert_allclose(np.asarray(ib), np.asarray(ia),
                                   atol=2e-6)
        np.testing.assert_allclose(np.asarray(qb), np.asarray(qa),
                                   atol=2e-6)
