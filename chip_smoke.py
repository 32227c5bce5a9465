"""Smoke test of the receiver on one NVIDIA GPU (or four, with --four).

    python chip_smoke.py          # one card: every phase below
    python chip_smoke.py --four   # four cards: the sharded paths only

One JAX process drives the card(s); nothing here spawns a second one (the
CLI phase calls sdr_tpu.cli.main in-process).  Every phase prints one line
of its own numbers; any failed gate makes the script exit non-zero without
the final result line.  The last line of a passing run is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

Phases (one card):
  device          the card, its power limit, JAX, XLA_FLAGS, compile cache
  fleet-reference mode 0 stereo+RDS, 128 stations x 1.2 s (8 distinct
                  transmitter captures tiled to 128), exact engines, 50
                  blocks per step; tone SNR / separation / RDS gates; the 8
                  distinct captures also run on the host CPU device and must
                  agree with the card (>= 60 dB, identical RDS groups)
  fleet-fast      the same batch on the --fast engine set (fused front-end
                  kernel); same gates, RDS yield >= the reference's
  frontend-kernel the kernel's fm_demod against the plain f32 path on real
                  captures at 128 stations (<= 1e-4 x peak), then step
                  timings of the receiver with the kernel and with XLA's
                  plain front end (mono and stereo+RDS, 50 and 1 blocks)
  cli             python -m sdr_tpu 0 2 --rds --fast on one capture
  wideband        --wideband --wideband-u8 (mfb channelizer), 4 stations

Phases (--four): channel DP over 4 cards against one card, time-sharded
stereo+RDS against a serial run, station-sharded wideband against the
unsharded WidebandReceiver.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import tempfile
import time
import traceback

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
STATIONS = 128
SECONDS = 1.2
DISTINCT = 8


# ----------------------------------------------------------------- helpers
def _captures(n_distinct: int, seconds: float):
    """n_distinct mode-0 transmitter captures, each with its own L/R tones
    and its own PI/PS; returns (u8 (n, bytes), [(left_hz, right_hz, pi,
    ps)])."""
    from sdr_tpu import tx
    from sdr_tpu.config import MODES
    from sdr_tpu.rds import tx as rds_tx
    cfg = MODES[0]
    n = int(seconds * cfg.rf_fs)
    caps, meta = [], []
    for c in range(n_distinct):
        f_l, f_r = 800.0 + 100.0 * c, 2000.0 + 150.0 * c
        pi, ps = 0x3D40 + c, f"SMOKE {c:02d}"
        bits = rds_tx.standard_group_stream(pi=pi, ps_name=ps, n_groups=16)
        caps.append(tx.synthesize_capture(
            cfg, seconds=seconds, left=tx.tone(cfg.rf_fs, f_l, n),
            right=tx.tone(cfg.rf_fs, f_r, n), seed=c,
            rds_baseband=rds_tx.bits_to_baseband(bits, cfg.rf_fs)[:n],
            a_rds=0.1))
        meta.append((f_l, f_r, pi, ps))
    return np.stack(caps), meta


def _rds_groups(soft, sps):
    from sdr_tpu.rds import (biphase_decode, differential_decode,
                             extract_groups, recover_symbols)
    symbols, _ = recover_symbols(np.asarray(soft, np.float64), sps)
    bits_diff, _ = biphase_decode(np.asarray(symbols))
    groups, _ = extract_groups(differential_decode(bits_diff))
    return groups


def _snr_db(x, ref):
    x = np.asarray(x, np.float64)
    ref = np.asarray(ref, np.float64)
    err = np.mean((x - ref) ** 2)
    return float("inf") if err == 0 else float(
        10 * np.log10(np.mean(ref ** 2) / err))


def _quality(out, meta):
    """Per-station gates: L/R tone SNR > 20 dB, separation > 20 dB, RDS
    PI/PS decoded.  Returns (numbers, failures, rds yields)."""
    from sdr_tpu.config import MODES
    from sdr_tpu.rds import decode_groups
    from sdr_tpu.utils.compare import stereo_separation_db, tone_snr_db
    cfg = MODES[0]
    fs = cfg.audio_fs
    skip = fs // 4
    left = np.asarray(out["left"], np.float64)
    right = np.asarray(out["right"], np.float64)
    soft = np.asarray(out["rds_soft"], np.float32)
    snr_l, snr_r, seps, yields, fails = [], [], [], [], []
    for s in range(left.shape[0]):
        f_l, f_r, pi, ps = meta[s % len(meta)]
        snr_l.append(tone_snr_db(left[s], fs, f_l, skip=skip))
        snr_r.append(tone_snr_db(right[s], fs, f_r, skip=skip))
        seps.append(min(
            stereo_separation_db(left[s], right[s], fs, f_l, skip=skip),
            stereo_separation_db(right[s], left[s], fs, f_r, skip=skip)))
        info = decode_groups(_rds_groups(soft[s], cfg.rds_sps))
        yields.append(info.groups_seen)
        if not (snr_l[-1] > 20 and snr_r[-1] > 20 and seps[-1] > 20):
            fails.append(f"station {s}: L {snr_l[-1]:.1f} dB, R "
                         f"{snr_r[-1]:.1f} dB, sep {seps[-1]:.1f} dB")
        if info.pi != pi or info.ps_name != ps:
            fails.append(f"station {s}: RDS PI={info.pi} PS={info.ps_name!r}")
    nums = (f"min_L_snr_db={min(snr_l):.2f} min_R_snr_db={min(snr_r):.2f} "
            f"min_sep_db={min(seps):.2f} rds_groups_min={min(yields)} "
            f"rds_ok={len(yields) - sum('RDS' in f for f in fails)}"
            f"/{len(yields)}")
    return nums, fails, yields


def _fetch(out):
    import jax
    return {k: np.asarray(jax.device_get(v)) for k, v in out.items()}


def _time_steps(rx, n_ch, bps, reps=5):
    """Median and spread of the receiver's jitted step at (n_ch, bps)
    blocks, device-resident input, ended by block_until_ready."""
    import jax
    bs = rx.block_size_u8(bps)
    block = jax.device_put(np.random.default_rng(0).integers(
        0, 256, size=(n_ch, bs), dtype=np.uint8))
    step = jax.jit(rx.step)
    state = rx.init_state((n_ch,))
    t0 = time.perf_counter()
    state, out = step(state, block)
    jax.block_until_ready((state, out))
    compile_s = time.perf_counter() - t0
    inner = max(1, 50 // bps)          # ~50 blocks of signal per timed rep
    dts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(inner):
            state, out = step(state, block)
        jax.block_until_ready((state, out))
        dts.append((time.perf_counter() - t0) / inner)
    dts.sort()
    return dts[len(dts) // 2], dts[0], dts[-1], compile_s


# ------------------------------------------------------------------ phases
def phase_device(ctx):
    import jax
    from sdr_tpu import device
    device.require_gpu()
    cache = device.init_compile_cache()
    dev = jax.devices()[0]
    ctx["gpu_info"] = device.gpu_info()
    return (f"kind={dev.device_kind!r} count={len(jax.devices())} "
            f"nvidia_smi={ctx['gpu_info']!r} jax={jax.__version__} "
            f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r} "
            f"compile_cache={cache}")


def phase_fleet_reference(ctx):
    import jax
    from sdr_tpu.models.receiver import Receiver
    caps, meta = _captures(DISTINCT, SECONDS)
    ctx["caps"], ctx["meta"] = caps, meta
    batch = np.tile(caps, (STATIONS // DISTINCT, 1))
    ctx["batch"] = batch
    rx = Receiver(0, stereo=True, rds=True)
    t0 = time.perf_counter()
    out = _fetch(rx.run(batch, blocks_per_step=50)[0])
    run_s = time.perf_counter() - t0
    nums, fails, yields = _quality(out, meta)
    ctx["ref_yields"] = yields
    # the same 8 distinct captures on the host CPU device: TF32 or any
    # other precision leak on the card's reference path shows up here
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        out_cpu = _fetch(Receiver(0, stereo=True, rds=True).run(
            jax.device_put(caps, cpu), blocks_per_step=50)[0])
    agree = min(_snr_db(out[k][:DISTINCT], out_cpu[k])
                for k in ("mono", "left", "right", "rds_soft"))
    if agree < 60.0:
        fails.append(f"GPU vs CPU agreement {agree:.2f} dB < 60 dB")
    from sdr_tpu.config import MODES
    sps = MODES[0].rds_sps
    same = sum(
        [g.blocks for g in _rds_groups(out["rds_soft"][s], sps)]
        == [g.blocks for g in _rds_groups(out_cpu["rds_soft"][s], sps)]
        for s in range(DISTINCT))
    if same != DISTINCT:
        fails.append(f"RDS groups differ GPU vs CPU on "
                     f"{DISTINCT - same}/{DISTINCT} stations")
    ctx["agreement_db"] = agree
    return (f"stations={STATIONS} seconds={SECONDS} {nums} "
            f"gpu_vs_cpu_min_snr_db={agree:.2f} rds_groups_identical="
            f"{same}/{DISTINCT} run_s={run_s:.2f}"), fails


def phase_fleet_fast(ctx):
    import jax
    from sdr_tpu.cli import describe_engines, fast_engines
    from sdr_tpu.models.receiver import Receiver
    rx = Receiver(0, stereo=True, rds=True, **fast_engines())
    fails = []
    if not rx.fused_frontend:
        fails.append("fast engine set lacks the front-end kernel")
    # the kernel, not XLA's path, is in the compiled step
    bs = rx.block_size_u8(50)
    hlo = jax.jit(rx.step).lower(
        rx.init_state((STATIONS,)),
        jax.ShapeDtypeStruct((STATIONS, bs), np.uint8)).compile().as_text()
    ran = "fm_frontend" in hlo
    if not ran:
        fails.append("fm_frontend kernel not in the compiled step")
    t0 = time.perf_counter()
    out = _fetch(rx.run(ctx["batch"], blocks_per_step=50)[0])
    run_s = time.perf_counter() - t0
    nums, qfails, yields = _quality(out, ctx["meta"])
    fails += qfails
    short = [s for s, (a, b) in enumerate(zip(yields, ctx["ref_yields"]))
             if a < b]
    if short:
        fails.append(f"RDS yield below the reference on stations {short}")
    return (f"{describe_engines(rx)} kernel_in_hlo={ran} {nums} "
            f"run_s={run_s:.2f}"), fails


def phase_frontend_kernel(ctx):
    import jax
    import jax.numpy as jnp
    from sdr_tpu.config import MODES
    from sdr_tpu.io.stream import decode_u8_iq
    from sdr_tpu.models.receiver import Receiver
    from sdr_tpu.ops import firdes
    from sdr_tpu.ops.demod import fm_discriminator
    from sdr_tpu.ops.pallas.frontend_kernel import FusedFrontend
    from sdr_tpu.ops.resample import PolyphaseResampler
    cfg = MODES[0]
    coeff = firdes.lowpass(cfg.rf_fs, cfg.rf_fc, cfg.rf_taps, 1)
    fe = FusedFrontend(coeff, cfg.rf_decim)
    rs = PolyphaseResampler(coeff, 1, cfg.rf_decim)
    u8 = jnp.asarray(ctx["batch"][:, : 50 * cfg.block_size_u8])
    z = jnp.zeros((STATIONS,), jnp.float32)
    fm_k = np.asarray(fe(u8, fe.init_state((STATIONS,)), z, z)[0])

    @jax.jit
    def plain(u8):
        i, q = decode_u8_iq(u8)
        i_ds, _ = rs(i, rs.init_state((STATIONS,)))
        q_ds, _ = rs(q, rs.init_state((STATIONS,)))
        return fm_discriminator(i_ds, q_ds, z, z)[0]

    fm_p = np.asarray(plain(u8))
    peak = float(np.abs(fm_p).max())
    err = float(np.abs(fm_k - fm_p).max())
    fails = [] if err <= 1e-4 * peak else [
        f"kernel max abs err {err:.3e} > 1e-4 x peak {peak:.3e}"]
    lines = [f"fm_demod max_abs_err={err:.3e} peak={peak:.4f} "
             f"ratio={err / peak:.3e} (gate 1e-4)"]
    timings = {}
    for chain, kw in (("mono", {}), ("stereo+rds",
                                     dict(stereo=True, rds=True))):
        for bps in (50, 1):
            for fused in (True, False):
                rx = Receiver(0, fused_frontend=fused, pll_impl="ff",
                              conv_dtype="bf16", **kw)
                med, lo, hi, comp = _time_steps(rx, STATIONS, bps)
                key = (chain, bps, "kernel" if fused else "xla")
                timings[key] = med
                lines.append(
                    f"step {chain} bps={bps} frontend={key[2]}: "
                    f"median_ms={med * 1e3:.4f} spread_ms="
                    f"{lo * 1e3:.4f}..{hi * 1e3:.4f} compile_s={comp:.1f}")
    for chain in ("mono", "stereo+rds"):
        for bps in (50, 1):
            k, x = timings[(chain, bps, "kernel")], timings[(chain, bps,
                                                              "xla")]
            lines.append(f"speedup {chain} bps={bps}: xla/kernel="
                         f"{x / k:.3f}")
    ctx["timings"] = timings
    return "\n  ".join(lines), fails


def phase_cli(ctx):
    from sdr_tpu.cli import main
    from sdr_tpu.config import MODES
    from sdr_tpu.io.wav import read_wav
    from sdr_tpu.utils.compare import stereo_separation_db, tone_snr_db
    cfg = MODES[0]
    f_l, f_r, pi, ps = ctx["meta"][0]
    with tempfile.TemporaryDirectory(dir=HERE) as tmp:
        cap = os.path.join(tmp, "cap.raw")
        ctx["caps"][0].tofile(cap)
        raw, wav = os.path.join(tmp, "audio.raw"), os.path.join(tmp, "o.wav")
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            rc = main(["0", "2", "--rds", "--fast", "--stats", "--in", cap,
                       "--out", raw, "--wav", wav])
        rate, frames = read_wav(wav)
    text = err.getvalue()
    x = frames.astype(np.float64)
    left, right = x[:, 0], x[:, 1]
    skip = rate // 4
    snr_l = tone_snr_db(left, rate, f_l, skip=skip)
    snr_r = tone_snr_db(right, rate, f_r, skip=skip)
    sep = stereo_separation_db(left, right, rate, f_l, skip=skip)
    fails = []
    if rc != 0:
        fails.append(f"cli exit code {rc}")
    if rate != cfg.audio_fs or not (snr_l > 20 and snr_r > 20 and sep > 20):
        fails.append(f"wav rate {rate} L {snr_l:.1f} R {snr_r:.1f} "
                     f"sep {sep:.1f} dB")
    if f"PS={ps!r}" not in text:
        fails.append(f"stderr lacks RDS PS {ps!r}")
    banner = text.splitlines()[0] if text else ""
    stats = [ln for ln in text.splitlines() if "MS/s" in ln or "latency" in
             ln]
    return (f"rc={rc} L_snr_db={snr_l:.2f} R_snr_db={snr_r:.2f} "
            f"sep_db={sep:.2f} ps_reported={f'PS={ps!r}' in text} "
            f"banner={banner!r} stats={stats!r}"), fails


def phase_wideband(ctx):
    from sdr_tpu import tx
    from sdr_tpu.cli import main
    from sdr_tpu.config import MODES
    from sdr_tpu.io.wav import read_wav
    from sdr_tpu.ops.channelizer import synthesize_wideband
    from sdr_tpu.utils.compare import tone_snr_db
    cfg = MODES[0]
    fs_wide = 4 * cfg.rf_fs                                  # 9.6 MS/s
    sec = 0.6
    n = int(sec * cfg.rf_fs)
    freqs = [-3.0e6, -1.0e6, 1.1e6, 3.2e6]
    tones = [600.0, 1100.0, 1700.0, 2900.0]
    sts = []
    for c, f in enumerate(tones):
        cap = tx.synthesize_capture(cfg, seconds=sec,
                                    mono=tx.tone(cfg.rf_fs, f, n), seed=c)
        v = (cap.astype(np.float32) - 128.0) / 128.0
        sts.append(v[0::2] + 1j * v[1::2])
    iw, qw = synthesize_wideband(sts, freqs, cfg.rf_fs, fs_wide)
    wide = np.stack([iw, qw], axis=-1).reshape(-1)
    u8 = np.clip(np.round(wide * 48.0) + 128.0, 0, 255).astype(np.uint8)
    with tempfile.TemporaryDirectory(dir=HERE) as tmp:
        path = os.path.join(tmp, "wide.u8")
        u8.tofile(path)
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            rc = main(["0", "1", "--wideband", str(fs_wide), "--wideband-u8",
                       "--freqs=" + ",".join(str(f) for f in freqs),
                       "--blocks-per-step", "4", "--in", path,
                       "--wav-dir", tmp])
        snrs = []
        for i, f in enumerate(tones):
            rate, data = read_wav(os.path.join(tmp, f"station{i}.wav"))
            snrs.append(tone_snr_db(data.astype(np.float64), rate, f,
                                    skip=rate // 10))
    fails = [] if rc == 0 and min(snrs) > 20 else [
        f"wideband rc={rc} tone SNRs {snrs}"]
    return (f"fs_wide={fs_wide:.0f} stations={len(freqs)} rc={rc} "
            f"tone_snr_db={[round(float(s), 2) for s in snrs]}"), fails


# ------------------------------------------------------------ four cards
def phase_four_channels(ctx):
    import jax
    from sdr_tpu.models.receiver import Receiver
    from sdr_tpu.parallel.channels import sharded_run
    from sdr_tpu.parallel.mesh import make_mesh
    caps, meta = _captures(DISTINCT, SECONDS)
    ctx["caps"], ctx["meta"] = caps, meta
    batch = np.tile(caps, (4 * STATIONS // DISTINCT, 1))    # 512 stations
    rx = Receiver(0, stereo=True, rds=True)
    mesh = make_mesh(4, "channels")
    outs, _ = sharded_run(rx, batch, mesh, blocks_per_step=50)
    devsets = {k: sorted(d.id for d in v.sharding.device_set)
               for k, v in outs.items()}
    sh = _fetch(outs)
    with jax.default_device(jax.devices()[0]):
        one = _fetch(rx.run(batch[:STATIONS], blocks_per_step=50)[0])
    worst = max(float(np.abs(sh[k][:STATIONS] - one[k]).max()
                      / max(np.abs(one[k]).max(), 1e-30)) for k in one)
    fails = [] if worst <= 1e-6 else [
        f"sharded vs one card: max relative error {worst:.3e} > 1e-6"]
    if any(len(v) != 4 for v in devsets.values()):
        fails.append(f"outputs not on 4 cards: {devsets}")
    nums, qfails, _ = _quality({k: sh[k] for k in ("left", "right",
                                                   "rds_soft")}, meta)
    return (f"stations={batch.shape[0]} per_card={batch.shape[0] // 4} "
            f"max_rel_err_vs_one_card={worst:.3e} device_sets={devsets} "
            f"{nums}"), fails + qfails


def phase_four_timeshard(ctx):
    from sdr_tpu.config import MODES
    from sdr_tpu.models.receiver import Receiver
    from sdr_tpu.parallel.mesh import make_mesh
    from sdr_tpu.parallel.timeshard import timesharded_full
    from sdr_tpu.rds import decode_groups
    from sdr_tpu.utils.compare import stereo_separation_db, stream_snr_db
    cfg = MODES[0]
    cap = ctx["caps"][0]
    f_l = ctx["meta"][0][0]
    rx = Receiver(0, stereo=True, rds=True, pll_impl="ff")
    left, right, soft = timesharded_full(rx, cap, make_mesh(4, "time"))
    left, right = np.asarray(left), np.asarray(right)
    serial = _fetch(rx.run(cap)[0])
    skip = cfg.audio_fs // 4
    sep_sh = stereo_separation_db(left, right, cfg.audio_fs, f_l, skip=skip)
    sep_se = stereo_separation_db(serial["left"], serial["right"],
                                  cfg.audio_fs, f_l, skip=skip)
    vs = stream_snr_db(left, serial["left"][:len(left)], skip=skip)
    y_sh = decode_groups(_rds_groups(np.asarray(soft), cfg.rds_sps))
    y_se = decode_groups(_rds_groups(serial["rds_soft"], cfg.rds_sps))
    fails = []
    if not vs > 30.0:
        fails.append(f"time-sharded vs serial {vs:.1f} dB <= 30 dB")
    if y_sh.groups_seen < y_se.groups_seen or y_sh.pi != y_se.pi:
        fails.append(f"RDS: sharded {y_sh.groups_seen} groups PI={y_sh.pi}"
                     f" vs serial {y_se.groups_seen} PI={y_se.pi}")
    return (f"left_vs_serial_snr_db={vs:.2f} sep_sharded_db={sep_sh:.2f} "
            f"sep_serial_db={sep_se:.2f} rds_groups sharded="
            f"{y_sh.groups_seen} serial={y_se.groups_seen}"), fails


def phase_four_wideband(ctx):
    from sdr_tpu import tx
    from sdr_tpu.config import MODES
    from sdr_tpu.models.receiver import Receiver
    from sdr_tpu.models.wideband import WidebandReceiver
    from sdr_tpu.ops.channelizer import (WidebandChannelizer,
                                         synthesize_wideband)
    from sdr_tpu.parallel.mesh import make_mesh
    from sdr_tpu.parallel.wideband import sharded_wideband_run
    cfg = MODES[0]
    fs_wide = 4 * cfg.rf_fs
    k, sec = 8, 0.3
    n = int(sec * cfg.rf_fs)
    sts = []
    for c in range(k):
        cap = tx.synthesize_capture(
            cfg, seconds=sec, mono=tx.tone(cfg.rf_fs, 600.0 + 150.0 * c, n),
            seed=c)
        v = (cap.astype(np.float32) - 128.0) / 128.0
        sts.append(v[0::2] + 1j * v[1::2])
    freqs = list(np.linspace(-3.4e6, 3.4e6, k))
    iw, qw = synthesize_wideband(sts, freqs, cfg.rf_fs, fs_wide)
    u8 = np.clip(np.round(np.stack([iw, qw], -1).reshape(-1) * 32.0)
                 + 128.0, 0, 255).astype(np.uint8)
    chan = WidebandChannelizer(fs_wide, cfg.rf_fs, freqs)
    want = _fetch(WidebandReceiver(chan, Receiver(0)).run(
        u8, blocks_per_step=4)[0])["mono"]
    out, _ = sharded_wideband_run(chan, Receiver(0), u8,
                                  make_mesh(4, "stations"),
                                  blocks_per_step=4)
    cards = len(out["mono"].sharding.device_set)
    got = np.asarray(out["mono"])
    err = float(np.abs(got - want).max() / np.abs(want).max())
    hlo = sharded_wideband_run.last_hlo
    colls = [c for c in ("all-reduce", "all-gather", "collective-permute",
                         "all-to-all", "reduce-scatter") if c in hlo]
    fails = [] if err <= 1e-5 and cards == 4 and not colls else [
        f"wideband sharded rel err {err:.3e}, cards {cards}, {colls}"]
    return (f"stations={k} cards={cards} max_rel_err={err:.3e} "
            f"collectives={colls}"), fails


# ------------------------------------------------------------------- main
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="four cards: run only the sharded paths")
    args = ap.parse_args(argv)
    import jax
    from sdr_tpu import device
    device.require_gpu()        # no accelerator: fail before any result
    want = 4 if args.four else 1
    if len(jax.devices()) < want:
        raise SystemExit(f"need {want} GPUs, JAX sees {jax.devices()}")
    phases = [phase_device]
    if args.four:
        phases += [phase_four_channels, phase_four_timeshard,
                   phase_four_wideband]
    else:
        phases += [phase_fleet_reference, phase_fleet_fast,
                   phase_frontend_kernel, phase_cli, phase_wideband]
    ctx: dict = {}
    failed = []
    for fn in phases:
        name = fn.__name__[len("phase_"):].replace("_", "-")
        t0 = time.perf_counter()
        try:
            res = fn(ctx)
            line, fails = res if isinstance(res, tuple) else (res, [])
        except (Exception, SystemExit):
            line, fails = "raised", [traceback.format_exc()]
        dt = time.perf_counter() - t0
        status = "FAIL" if fails else "ok"
        print(f"[{name}] {status} ({dt:.1f} s) {line}", flush=True)
        for f in fails:
            print(f"  FAIL: {f}", flush=True)
        if fails:
            failed.append(name)
        if name == "device" and fails:
            break
    if failed:
        print(f"failed phases: {failed}", file=sys.stderr)
        return 1
    print(ctx.get("gpu_info", device.gpu_info()), flush=True)
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
