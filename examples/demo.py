"""End-to-end demo: synthesize a multi-station FM band, decode everything.

Synthesizes N simultaneous FM stations (each with distinct stereo program
and RDS metadata), batch-decodes them in one jitted program (channel data
parallelism), and prints recovered audio quality + RDS station info.

    python examples/demo.py [--stations 4] [--seconds 1.2] [--cpu]

This is the framework's "listen test" analogue of the reference's
`cat samples_u8.raw | ./project | aplay` smoke test (src/project.cpp:392),
with the transmit side synthesized because the reference's captures are not
redistributable.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--stations", type=int, default=4)
    ap.add_argument("--seconds", type=float, default=1.2)
    ap.add_argument("--cpu", action="store_true", help="force CPU backend")
    ap.add_argument("--wav-dir", default=None)
    args = ap.parse_args()

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from sdr_tpu.config import MODES
    from sdr_tpu.models.receiver import Receiver
    from sdr_tpu import tx
    from sdr_tpu.rds import decode_rds_soft
    from sdr_tpu.rds import tx as rds_tx
    from sdr_tpu.utils.compare import stereo_separation_db, tone_snr_db

    cfg = MODES[0]
    n = int(args.seconds * cfg.rf_fs)
    names = ["JAZZ FM ", "ROCK 101", "NEWS 24 ", "CLASSICA",
             "JAX SDR ", "PODS FM ", "WAVE 88 ", "METAL X "]

    print(f"Synthesizing {args.stations} stations "
          f"({args.seconds:.1f} s @ {cfg.rf_fs/1e6:.1f} MS/s each)...")
    caps, truths = [], []
    for s in range(args.stations):
        f_l = 600.0 + 300.0 * s
        f_r = 900.0 + 400.0 * s
        pi = 0x1000 + s
        bits = rds_tx.standard_group_stream(
            pi=pi, pty=(s % 31), ps_name=names[s % len(names)],
            radio_text=f"STATION {s} ON A GPU",
            n_groups=int(args.seconds * 1187.5 / 104) + 2)
        rds_bb = rds_tx.bits_to_baseband(bits, cfg.rf_fs)
        cap = tx.synthesize_capture(
            cfg, seconds=args.seconds,
            left=tx.tone(cfg.rf_fs, f_l, n), right=tx.tone(cfg.rf_fs, f_r, n),
            rds_baseband=rds_bb[:n], a_rds=0.1, seed=s)
        caps.append(cap)
        truths.append((f_l, f_r, pi))
    batch = np.stack(caps)

    rx = Receiver(0, stereo=True, rds=True)
    print(f"Decoding on {jax.devices()[0].device_kind} "
          f"(one jitted program, {args.stations}-station batch)...")
    t0 = time.perf_counter()
    out, _ = rx.run(batch, blocks_per_step=4)
    audio = {k: np.asarray(v) for k, v in out.items()}
    dt = time.perf_counter() - t0
    ms = args.stations * (len(caps[0]) // 2) / dt / 1e6
    print(f"  {dt:.2f} s wall = {ms:.1f} IQ MS/s aggregate "
          f"(incl. compile on first run)\n")

    skip = cfg.audio_fs // 4
    ok = True
    for s, (f_l, f_r, pi) in enumerate(truths):
        l, r = audio["left"][s], audio["right"][s]
        snr_l = tone_snr_db(l, cfg.audio_fs, f_l, skip=skip)
        sep = stereo_separation_db(l, r, cfg.audio_fs, f_l, skip=skip)
        info = decode_rds_soft(audio["rds_soft"][s], cfg.rds_sps)
        rds_ok = info.pi == pi
        ok &= rds_ok and snr_l > 15
        print(f"station {s}: L-tone {f_l:6.0f} Hz SNR {snr_l:5.1f} dB | "
              f"separation {sep:5.1f} dB | RDS PI={info.pi:#06x} "
              f"PS={info.ps_name!r} RT={info.radio_text.rstrip()!r} "
              f"[{'OK' if rds_ok else 'MISMATCH'}]")
        if args.wav_dir:
            import os
            from sdr_tpu.io import wav as wavio
            os.makedirs(args.wav_dir, exist_ok=True)
            frames = np.stack([l, r], axis=1)
            pcm = np.clip(frames * 16384.0, -32768, 32767).astype(np.int16)
            wavio.write_wav(f"{args.wav_dir}/station{s}.wav", cfg.audio_fs,
                            pcm)

    print("\nDEMO", "PASSED" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
