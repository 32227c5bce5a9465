"""Command-line receiver: the JAX equivalent of `./project <mode> <channels>`.

Reference usage (src/project.cpp:392-393):
    rtl_sdr -f 102.9M -s 2.4M - | ./project 0 2 | aplay -c 2 -f S16_LE -r 48000
Here:
    rtl_sdr ... - | python -m sdr_tpu 0 2 | aplay -c 2 -f S16_LE -r 48000

Reads u8 IQ blocks from stdin (or --in FILE), streams S16LE audio to stdout
(or --out FILE / --wav FILE), mono (1) or interleaved R,L stereo (2) exactly
like the reference packing (src/project.cpp:179-195).  `--rds` prints
decoded station info to stderr.  The per-block jitted step keeps device
residency; host I/O is double-buffered by the native stream runtime when
available (sdr_tpu/native).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="sdr_tpu",
        description="FM broadcast receiver (mono/stereo/RDS) in JAX")
    p.add_argument("mode", type=int, nargs="?", default=0,
                   help="operating mode 0-3 (default 0)")
    p.add_argument("channels", type=int, nargs="?", default=1,
                   choices=(1, 2), help="1=mono, 2=stereo (default 1)")
    p.add_argument("--rds", action="store_true",
                   help="decode RDS and print station info to stderr")
    p.add_argument("--in", dest="infile", default="-",
                   help="input u8 IQ file ('-' = stdin)")
    p.add_argument("--out", dest="outfile", default="-",
                   help="output S16LE stream ('-' = stdout)")
    p.add_argument("--wav", default=None, help="also write a WAV file")
    p.add_argument("--blocks-per-step", type=int, default=25,
                   help="reference blocks fused per jit step")
    p.add_argument("--psd-dump", default=None,
                   help="write a Bartlett PSD .dat of the demodulated IF "
                        "for gnuplot inspection (basename, .dat appended)")
    p.add_argument("--psd-anim", default=None,
                   help="write a per-block PSD .dat SERIES of the "
                        "demodulated IF (basename; frames = gnuplot "
                        "indices, rendered by examples/psd_anim.gnuplot)")
    p.add_argument("--psd-anim-every", type=int, default=10,
                   help="emit one PSD frame per N reference blocks "
                        "(default 10)")
    p.add_argument("--trace-iq", default=None, metavar="BASE",
                   help="dump time-domain I/Q .dat traces of the FIRST "
                        "block, pre- and post-channelizer (BASE_i_time, "
                        "BASE_q_time, BASE_i_filt_time, BASE_q_filt_time; "
                        "render with examples/iq.gnuplot) — the reference's "
                        "data/iq.gnuplot / iq_filt.gnuplot stage-trace "
                        "workflow (src/logfunc.cpp:23-43)")
    p.add_argument("--stats", action="store_true",
                   help="print throughput stats to stderr")
    p.add_argument("--save-state", default=None,
                   help="checkpoint the streaming state pytree on exit")
    p.add_argument("--resume", default=None,
                   help="resume the streaming state from a checkpoint")
    p.add_argument("--fast", action="store_true",
                   help="fast engines: the fused u8 front-end kernel (on a "
                        "GPU) + feedforward carriers + bf16 FIR stages "
                        "(transparent for FM audio)")
    p.add_argument("--profile", default=None,
                   help="write a jax.profiler trace to this directory "
                        "(per-stage named scopes included)")
    p.add_argument("--stations", default=None,
                   help="comma-separated u8 IQ capture files: batch-decode "
                        "N independent stations in one jitted program "
                        "(channel data parallelism); requires --wav-dir")
    p.add_argument("--wav-dir", default=None,
                   help="output directory for per-station WAVs "
                        "(station<i>.wav)")
    p.add_argument("--wideband", type=float, default=None, metavar="FS",
                   help="treat --in as a float32 interleaved complex "
                        "wideband capture at FS samples/s; channelize the "
                        "stations given by --freqs on-accelerator")
    p.add_argument("--freqs", default=None,
                   help="comma-separated station offsets in Hz for "
                        "--wideband (e.g. -1500000,0,1800000)")
    p.add_argument("--wideband-u8", action="store_true",
                   help="the --wideband capture is interleaved u8 IQ "
                        "((x-128)/128 decode on device) instead of f32")
    p.add_argument("--scan", action="store_true",
                   help="with --wideband: auto-detect station offsets from "
                        "the capture's spectrum instead of --freqs")
    p.add_argument("--scan-snr", type=float, default=10.0,
                   help="detection threshold above the noise floor (dB)")
    p.add_argument("--max-stations", type=int, default=None,
                   help="with --scan: keep only the N strongest stations")
    return p


def fast_engines() -> dict:
    """The --fast engine set: the fused front-end kernel where it compiles
    (a GPU), feedforward carrier recovery, bf16 FIR stages."""
    from sdr_tpu import device
    return dict(fused_frontend=device.backend() == "gpu", pll_impl="ff",
                conv_dtype="bf16")


def describe_engines(rx) -> str:
    """One line naming the engines a Receiver runs."""
    fe = "fused kernel" if rx.fused_frontend else "xla"
    return (f"engines: front end {fe}, pll {rx.pll_impl}, "
            f"fir {rx.filter_engine}/{rx.conv_engine}/{rx.conv_dtype}")


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if not 0 <= args.mode <= 3:
        print(f"Invalid mode: {args.mode}!", file=sys.stderr)
        return 1

    import jax
    from sdr_tpu import device
    device.init_compile_cache()
    from sdr_tpu.config import get_mode
    from sdr_tpu.models.receiver import Receiver
    from sdr_tpu.io.stream import interleave_stereo_s16, pack_s16, read_u8_blocks
    from sdr_tpu.io import wav as wavio

    cfg = get_mode(args.mode)
    stereo = args.channels == 2
    rds = args.rds and cfg.rds_sps is not None

    if args.wideband:
        return _run_wideband(args, cfg, stereo, rds)
    if args.stations:
        return _run_stations(args, cfg, stereo, rds)
    fast = fast_engines() if args.fast else {}
    want_if = args.psd_dump is not None or args.psd_anim is not None
    rx = Receiver(args.mode, stereo=stereo, rds=rds, emit_if=want_if, **fast)
    print(f"Operating in mode {args.mode}, "
          f"{'stereo' if stereo else 'mono'}{' + RDS' if rds else ''} "
          f"({describe_engines(rx)})", file=sys.stderr)
    state = rx.init_state()
    if args.resume:
        from sdr_tpu.utils.checkpoint import load_state
        state = load_state(args.resume, state)
        print(f"Resumed state from {args.resume}", file=sys.stderr)
    step = jax.jit(rx.step)
    block_size = rx.block_size_u8(args.blocks_per_step)

    fin = sys.stdin.buffer if args.infile == "-" else open(args.infile, "rb")
    fout = sys.stdout.buffer if args.outfile == "-" else open(args.outfile, "wb")
    sink = _audio_sink(fout)

    wav_chunks: list[np.ndarray] = []
    rds_decoder = None
    if rds:
        from sdr_tpu.rds.streaming import StreamingRdsDecoder
        rds_decoder = StreamingRdsDecoder(cfg.rds_sps)
    if_chunks = [] if args.psd_dump else None
    psd_anim = (_PsdAnim(args.psd_anim, cfg, args.psd_anim_every)
                if args.psd_anim else None)
    n_in = 0
    t0 = time.perf_counter()
    pending = None  # double buffering: overlap host read with device compute
    step_times: list[float] = []

    if args.profile:
        jax.profiler.start_trace(args.profile)
    src = _block_source(fin, block_size)
    for raw in src:
        if args.trace_iq is not None and n_in == 0:
            _trace_iq(args.trace_iq, raw, rx)
        if pending is not None:
            _drain(pending, stereo, sink, wav_chunks, rds_decoder, if_chunks,
                   psd_anim)
        ts = time.perf_counter()
        state, out = step(state, jax.numpy.asarray(raw))
        step_times.append(time.perf_counter() - ts)
        pending = out
        n_in += len(raw)
    # EOF flush: run the partial final block at the finest aligned size so
    # large --blocks-per-step values don't drop up to a step's worth of
    # signal at stream end (split-invariance makes the outputs identical;
    # one extra jit compile at EOF)
    tail = src.tail() if hasattr(src, "tail") else np.zeros(0, np.uint8)
    tail_n = (len(tail) // rx.block_align_u8()) * rx.block_align_u8()
    if tail_n:
        if pending is not None:
            _drain(pending, stereo, sink, wav_chunks, rds_decoder, if_chunks,
                   psd_anim)
        state, pending = step(state, jax.numpy.asarray(tail[:tail_n]))
        n_in += tail_n
    if pending is not None:
        _drain(pending, stereo, sink, wav_chunks, rds_decoder, if_chunks,
               psd_anim)
    sink.close()  # joins the native writer thread after draining its ring

    if args.profile:
        jax.profiler.stop_trace()
        print(f"Wrote profiler trace to {args.profile}", file=sys.stderr)
    elapsed = time.perf_counter() - t0
    if args.stats:
        ms = n_in / 2 / elapsed / 1e6
        print(f"processed {n_in/2:.0f} IQ samples in {elapsed:.2f}s "
              f"= {ms:.2f} MS/s ({ms*1e6/cfg.rf_fs:.1f}x real time)",
              file=sys.stderr)
        if len(step_times) > 1:
            # skip the first step (jit compile); dispatch latency per step
            # bounds the live pipeline lag on top of block accumulation
            # (reference bound: capacity-3 queue ~ 8 ms, project.cpp:17)
            st = sorted(step_times[1:])
            p50 = st[len(st) // 2] * 1e3
            p95 = st[int(len(st) * 0.95)] * 1e3
            blk_ms = block_size / 2 / cfg.rf_fs * 1e3
            print(f"step latency: p50 {p50:.1f} ms / p95 {p95:.1f} ms per "
                  f"{blk_ms:.1f} ms RF block step "
                  f"(lower --blocks-per-step for lower latency)",
                  file=sys.stderr)
    print("End of input stream reached!", file=sys.stderr)

    if args.wav and wav_chunks:
        audio = np.concatenate(wav_chunks)
        if stereo:
            # stored interleaved (R, L); WAV convention is (L, R)
            frames = audio.reshape(-1, 2)[:, ::-1]
        else:
            frames = audio
        wavio.write_wav(args.wav, cfg.audio_fs, frames)
        print(f"Wrote {args.wav}", file=sys.stderr)

    if psd_anim is not None:
        nframes = psd_anim.close()
        print(f"Wrote {args.psd_anim}.dat ({nframes} PSD frames; render "
              "with examples/psd_anim.gnuplot)", file=sys.stderr)

    if args.psd_dump and if_chunks:
        from sdr_tpu.ops.fourier import estimate_psd
        from sdr_tpu.io.logger import log_vector
        demod = np.concatenate(if_chunks)
        freq, psd = estimate_psd(jax.numpy.asarray(demod), fs=float(cfg.if_fs))
        log_vector(args.psd_dump, freq / 1e3, np.asarray(psd))
        print(f"Wrote {args.psd_dump}.dat (Bartlett PSD of demodulated IF)",
              file=sys.stderr)

    if args.save_state:
        from sdr_tpu.utils.checkpoint import save_state
        save_state(args.save_state, state)
        print(f"Saved state to {args.save_state}", file=sys.stderr)

    if rds_decoder is not None:
        info = rds_decoder.info
        print(f"RDS final: PI={info.pi:#06x} PTY={info.pty_name!r} "
              f"PS={info.ps_name!r} RT={info.radio_text.rstrip()!r} "
              f"({info.groups_seen} groups)"
              if info.pi is not None else "RDS: no sync", file=sys.stderr)
    return 0


def _run_wideband(args, cfg, stereo, rds):
    """Channelize a wideband complex capture into N stations and decode them
    all in ONE fused scanned program (models/wideband.py WidebandReceiver),
    streaming the file block-wise so captures larger than RAM work."""
    import os
    import sys as _sys
    import numpy as np
    from sdr_tpu.models.receiver import Receiver
    from sdr_tpu.models.wideband import WidebandReceiver
    from sdr_tpu.ops.channelizer import WidebandChannelizer
    from sdr_tpu.io import wav as wavio

    if not (args.freqs or args.scan) or not args.wav_dir:
        print("--wideband requires --freqs (or --scan) and --wav-dir",
              file=_sys.stderr)
        return 1
    fs_wide = args.wideband
    dtype = np.dtype(np.uint8) if args.wideband_u8 else np.dtype("<f4")
    fin = open(args.infile, "rb")

    def read_scalars(count):
        buf = fin.read(count * dtype.itemsize)
        return np.frombuffer(buf, dtype=dtype)

    if args.scan:
        from sdr_tpu.ops.spectrum import find_stations
        # survey a ~0.1 s prefix (plenty for energy detection), then rewind
        # so the decode stream includes it
        n_scan = max(1 << 18, int(0.1 * fs_wide))
        prefix = read_scalars(2 * n_scan)
        fin.seek(0)
        if args.wideband_u8:
            pf = (prefix.astype(np.float32) - 128.0) / 128.0
        else:
            pf = prefix
        freqs = find_stations(np.ascontiguousarray(pf[0::2]),
                              np.ascontiguousarray(pf[1::2]), fs_wide,
                              min_snr_db=args.scan_snr,
                              max_stations=args.max_stations)
        if not freqs:
            print("scan found no stations", file=_sys.stderr)
            return 1
        print("scan found stations at "
              + ", ".join(f"{f/1e6:+.2f} MHz" for f in freqs),
              file=_sys.stderr)
    else:
        freqs = [float(f) for f in args.freqs.split(",") if f]
    chan = WidebandChannelizer(fs_wide, cfg.rf_fs, freqs,
                               compute_dtype="bf16" if args.fast else "f32")
    fast = dict(fused_frontend=False,
                pll_impl="ff" if args.fast else "auto")
    rx = Receiver(args.mode, stereo=stereo, rds=rds, **fast)
    wrx = WidebandReceiver(chan, rx)
    print(f"Channelizing {len(freqs)} stations from {fs_wide/1e6:.1f} MS/s "
          f"wideband ({dtype.name} stream)", file=_sys.stderr)

    def file_chunks():
        # stream the capture: bounded read-ahead, never the whole file
        chunk = wrx.block_wide(args.blocks_per_step)
        while True:
            data = read_scalars(chunk)
            if len(data) == 0:
                return
            yield data

    mrds = None
    if rds:
        from sdr_tpu.rds.streaming import MultiStreamingRds
        mrds = MultiStreamingRds(cfg.rds_sps, len(freqs))
    audio = []
    for out, _state in wrx.stream(file_chunks(),
                                  blocks_per_step=args.blocks_per_step,
                                  scan_steps=4):
        if stereo:
            audio.append(np.stack([np.asarray(out["left"]),
                                   np.asarray(out["right"])], axis=-1))
        else:
            audio.append(np.asarray(out["mono"]))
        if mrds is not None and "rds_soft" in out:
            # LIVE per-station decode as the wideband capture streams
            for i, _groups in mrds.push(np.asarray(out["rds_soft"])):
                info = mrds.info(i)
                print(f"  {freqs[i]/1e6:+.2f} MHz RDS: PI={info.pi:#06x} "
                      f"PS={info.ps_name!r} ({info.groups_seen} groups)",
                      file=_sys.stderr)
    fin.close()
    if not audio:
        print("capture shorter than one block", file=_sys.stderr)
        return 1
    full = np.concatenate(audio, axis=1)
    os.makedirs(args.wav_dir, exist_ok=True)
    for i, f in enumerate(freqs):
        pcm = np.clip(np.nan_to_num(full[i]) * 16384.0, -32768, 32767
                      ).astype(np.int16)
        dst = os.path.join(args.wav_dir, f"station{i}.wav")
        wavio.write_wav(dst, cfg.audio_fs, pcm)
        print(f"  {f/1e6:+.2f} MHz -> {dst}", file=_sys.stderr)
    if mrds is not None:
        for i, f in enumerate(freqs):
            info = mrds.info(i)
            msg = (f"PI={info.pi:#06x} PS={info.ps_name!r} "
                   f"({info.groups_seen} groups)"
                   if info.pi is not None else "no sync")
            print(f"  {f/1e6:+.2f} MHz RDS final: {msg}", file=_sys.stderr)
    return 0


def _run_stations(args, cfg, stereo, rds):
    """Stream-decode N station captures in one jitted program (channel DP).

    Ingest is streaming: captures are memory-mapped and fed one jit step at
    a time (bounded by blocks_per_step — captures larger than RAM work),
    with per-station RDS decoded LIVE as groups arrive
    (rds/streaming.py MultiStreamingRds) — the reference's live model
    (src/project.cpp:392-393) at fleet scale.  Files are truncated to the
    shortest capture so the batch is rectangular; on a multi-device mesh
    the same entry point shards stations across devices
    (sdr_tpu.parallel.channels).
    """
    import os
    import sys as _sys
    import jax
    import numpy as np
    from sdr_tpu.models.receiver import Receiver
    from sdr_tpu.io import wav as wavio

    paths = [p for p in args.stations.split(",") if p]
    if not args.wav_dir:
        print("--stations requires --wav-dir", file=_sys.stderr)
        return 1
    os.makedirs(args.wav_dir, exist_ok=True)
    maps = [np.memmap(p, dtype=np.uint8, mode="r") for p in paths]
    k = len(paths)
    n = min(m.shape[0] for m in maps)
    print(f"Decoding {k} stations x {n//2} IQ samples (streaming, batched)",
          file=_sys.stderr)

    fast = fast_engines() if args.fast else {}
    rx = Receiver(args.mode, stereo=stereo, rds=rds, **fast)
    print(describe_engines(rx), file=_sys.stderr)
    bs = rx.block_size_u8(args.blocks_per_step)
    if bs > n:
        bs = (n // rx.block_align_u8()) * rx.block_align_u8()
        if bs == 0:
            print("captures shorter than one block", file=_sys.stderr)
            return 1
    step = jax.jit(rx.step)
    state = rx.init_state((k,))
    mrds = None
    if rds:
        from sdr_tpu.rds.streaming import MultiStreamingRds
        mrds = MultiStreamingRds(cfg.rds_sps, k)
    audio_chunks: list[np.ndarray] = []

    def drain(out):
        if stereo:
            audio_chunks.append(np.stack([np.asarray(out["left"]),
                                          np.asarray(out["right"])], axis=-1))
        else:
            audio_chunks.append(np.asarray(out["mono"]))
        if mrds is not None:
            # LIVE per-station decode: groups print as they arrive
            for i, _groups in mrds.push(np.asarray(out["rds_soft"])):
                info = mrds.info(i)
                print(f"  station {i} RDS: PI={info.pi:#06x} "
                      f"PS={info.ps_name!r} RT={info.radio_text.rstrip()!r} "
                      f"({info.groups_seen} groups)", file=_sys.stderr)

    pending = None  # overlap host slicing with device compute
    for off in range(0, n - bs + 1, bs):
        batch = np.stack([m[off:off + bs] for m in maps])
        if pending is not None:
            drain(pending)
        state, out = step(state, jax.numpy.asarray(batch))
        pending = out
    if pending is not None:
        drain(pending)

    full = np.concatenate(audio_chunks, axis=1)
    for i, path in enumerate(paths):
        pcm = np.where(np.isnan(full[i]), 0.0, full[i] * 16384.0
                       ).astype(np.int16)
        dst = os.path.join(args.wav_dir, f"station{i}.wav")
        wavio.write_wav(dst, cfg.audio_fs, pcm)
        print(f"  station {i} ({os.path.basename(path)}) -> {dst}",
              file=_sys.stderr)
    if mrds is not None:
        for i in range(k):
            info = mrds.info(i)
            msg = (f"PI={info.pi:#06x} PS={info.ps_name!r} "
                   f"({info.groups_seen} groups)"
                   if info.pi is not None else "no sync")
            print(f"  station {i} RDS final: {msg}", file=_sys.stderr)
    return 0


def _trace_iq(base: str, raw: np.ndarray, rx) -> None:
    """Write 4 time-domain .dat traces of one u8 block: decoded I/Q before
    the channelizer and decimated I/Q after it (reference stage-trace
    workflow: logVector src/logfunc.cpp:23-43 feeding data/iq.gnuplot +
    data/iq_filt.gnuplot with i/q_block_time.dat, i/q_filt_time.dat).

    The filtered trace is computed with the exact f32 resampler from a
    zero tail (first-block semantics) regardless of the engine configured
    for the stream — a debug tap, not part of the audio path.
    """
    from sdr_tpu.io.logger import log_vector

    n_show = 512  # samples per trace, like the reference's 512-pt window
    i_raw = (raw[0::2].astype(np.float32) - 128.0) / 128.0
    q_raw = (raw[1::2].astype(np.float32) - 128.0) / 128.0
    idx = np.arange(min(n_show, len(i_raw)))
    log_vector(f"{base}_i_time", idx, i_raw[: len(idx)])
    log_vector(f"{base}_q_time", idx, q_raw[: len(idx)])

    from sdr_tpu.ops.resample import PolyphaseResampler
    from sdr_tpu.ops import firdes

    cfg = rx.cfg
    rf = PolyphaseResampler(
        firdes.lowpass(cfg.rf_fs, cfg.rf_fc, cfg.rf_taps, 1), 1, cfg.rf_decim)
    i_ds, _ = rf(np.asarray(i_raw), np.asarray(rf.init_state()))
    q_ds, _ = rf(np.asarray(q_raw), np.asarray(rf.init_state()))
    idx_f = np.arange(min(n_show, i_ds.shape[-1]))
    log_vector(f"{base}_i_filt_time", idx_f, np.asarray(i_ds)[: len(idx_f)])
    log_vector(f"{base}_q_filt_time", idx_f, np.asarray(q_ds)[: len(idx_f)])
    print(f"Wrote {base}_{{i,q}}_time.dat + {base}_{{i,q}}_filt_time.dat "
          "(render with examples/iq.gnuplot)", file=sys.stderr)


def _block_source(fin, block_size):
    """Prefer the native bounded-ring reader thread (backpressure + I/O
    overlap, sdr_tpu/native); fall back to synchronous reads."""
    from sdr_tpu.io.stream import SyncBlockReader
    try:
        from sdr_tpu import native
        if native.available() and hasattr(fin, "fileno"):
            return native.BlockReader(fin.fileno(), block_size)
    except Exception:
        pass
    return SyncBlockReader(fin, block_size)


class _SyncSink:
    """Fallback synchronous audio sink when the native runtime is absent."""

    def __init__(self, fout):
        self._fout = fout

    def write(self, data: bytes):
        self._fout.write(data)

    def close(self):
        try:
            self._fout.flush()
        except Exception:
            pass


def _audio_sink(fout):
    """Prefer the native off-thread writer (bounded ring, drained by a C++
    thread so fwrite latency never stalls the device-feed loop — the
    reference's consumer-side decoupling, src/project.cpp:195)."""
    try:
        from sdr_tpu import native
        if native.available() and hasattr(fout, "fileno"):
            fout.flush()  # anything buffered goes out before raw-fd writes
            return native.BlockWriter(fout.fileno())
    except Exception:
        pass
    return _SyncSink(fout)


def _drain(out, stereo, sink, wav_chunks, rds_decoder, if_chunks,
           psd_anim=None):
    from sdr_tpu.io.stream import interleave_stereo_s16, pack_s16
    if stereo:
        pcm = np.asarray(interleave_stereo_s16(out["left"], out["right"]))
    else:
        pcm = np.asarray(pack_s16(out["mono"]))
    sink.write(pcm.astype("<i2").tobytes())
    wav_chunks.append(pcm)
    if rds_decoder is not None and "rds_soft" in out:
        # streaming decode: O(1) carried state, PI/PS/RT updates as groups
        # arrive (rds/streaming.py) instead of an end-of-capture batch
        if rds_decoder.push(np.asarray(out["rds_soft"])):
            info = rds_decoder.info
            print(f"RDS: PI={info.pi:#06x} PTY={info.pty_name!r} "
                  f"PS={info.ps_name!r} RT={info.radio_text.rstrip()!r} "
                  f"({info.groups_seen} groups"
                  + (f", {rds_decoder.bits_corrected} bits corrected)"
                     if rds_decoder.bits_corrected else ")"),
                  file=sys.stderr)
    if "fm_demod" in out:
        if if_chunks is not None:
            if_chunks.append(np.asarray(out["fm_demod"]))
        if psd_anim is not None:
            psd_anim.push(np.asarray(out["fm_demod"]))


class _PsdAnim:
    """Per-block PSD frame emitter (P6 animated-PSD parity,
    model/fmMonoAnim.py): one Bartlett PSD of the demodulated IF every
    `every` reference blocks, appended to a gnuplot index-addressable .dat
    series (io/logger.py PsdAnimWriter)."""

    def __init__(self, base: str, cfg, every: int):
        self.base = base
        self.every = max(1, every)
        self.block_if = cfg.block_size_u8 // (2 * cfg.rf_decim)
        self.fs = float(cfg.if_fs)
        self.count = 0
        self.writer = None

    def push(self, fm_demod: np.ndarray) -> None:
        import jax.numpy as jnp
        from sdr_tpu.ops.fourier import estimate_psd
        from sdr_tpu.io.logger import PsdAnimWriter
        nb = len(fm_demod) // self.block_if
        for b in range(nb):
            idx = self.count + b
            if idx % self.every:
                continue
            seg = fm_demod[b * self.block_if:(b + 1) * self.block_if]
            freq, psd = estimate_psd(jnp.asarray(seg), fs=self.fs)
            if self.writer is None:
                self.writer = PsdAnimWriter(self.base, freq / 1e3)
            self.writer.append(np.asarray(psd), label=f"block {idx}")
        self.count += nb

    def close(self) -> int:
        if self.writer is None:
            return 0
        self.writer.close()
        return self.writer.frames


if __name__ == "__main__":
    raise SystemExit(main())
