"""Reproduce BASELINE.md's operating-envelope table (impairment matrix).

Runs the full stereo+RDS chain (mode 0) over synthesized 1.2 s captures with
each impairment, for BOTH the default (exact) and `--fast` engine sets, and
prints the stereo separation / 1 kHz L SNR / RDS group yield per row.

CPU is fine (exactness, not speed): there the fast set's front-end kernel
runs in the Pallas interpreter.  Pass --gpu to run on the card.

    python tools/bench_envelope.py [--gpu]
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

ON_GPU = "--gpu" in sys.argv
if not ON_GPU:
    import jax
    jax.config.update("jax_platforms", "cpu")

# the --fast engine set as it runs on a GPU (front-end kernel included)
FAST = dict(fused_frontend=True, pll_impl="ff", conv_dtype="bf16")

ROWS = [
    ("none", {}),
    ("cfo +3 kHz", dict(cfo_hz=3000.0)),
    ("cfo +20 kHz", dict(cfo_hz=20000.0)),
    ("clock -100 ppm", dict(clock_ppm=-100.0)),
    ("clock +500 ppm", dict(clock_ppm=500.0)),
    ("phase noise 2 Hz", dict(pilot_linewidth_hz=2.0)),
    ("phase noise 10 Hz", dict(pilot_linewidth_hz=10.0)),
    ("phase noise 50 Hz", dict(pilot_linewidth_hz=50.0)),
    ("noise -10 dB", dict(noise_db=-10.0)),
    ("noise -6 dB", dict(noise_db=-6.0)),
    ("noise -4 dB", dict(noise_db=-4.0)),
    ("combo", dict(cfo_hz=2000.0, clock_ppm=-100.0,
                   pilot_linewidth_hz=0.5, noise_db=-14.0)),
]


def main():
    import contextlib
    from sdr_tpu import tx
    from sdr_tpu.config import MODES
    from sdr_tpu.device import interpret_kernels
    from sdr_tpu.models.receiver import Receiver
    from sdr_tpu.rds import tx as rds_tx
    from sdr_tpu.rds.streaming import StreamingRdsDecoder
    from sdr_tpu.utils.compare import stereo_separation_db, tone_snr_db

    cfg = MODES[0]
    sec = 1.2
    n = int(sec * cfg.rf_fs)
    bits = rds_tx.standard_group_stream(pi=0x3D44, ps_name="ENVELOPE",
                                        n_groups=16)
    base = dict(seconds=sec, left=tx.tone(cfg.rf_fs, 1000.0, n),
                right=tx.tone(cfg.rf_fs, 2500.0, n),
                rds_baseband=rds_tx.bits_to_baseband(bits, cfg.rf_fs)[:n],
                a_rds=0.1)
    skip = cfg.audio_fs // 4

    print(f"{'impairment':<20} {'default':<24} {'--fast':<24}")
    for name, kw in ROWS:
        cap = tx.synthesize_capture(cfg, **base, **kw)
        cells = []
        for engines in ({}, FAST):
            rx = Receiver(0, stereo=True, rds=True, **engines)
            with (contextlib.nullcontext() if ON_GPU
                  else interpret_kernels()):
                out, _ = rx.run(cap, blocks_per_step=8)
            left = np.asarray(out["left"])
            right = np.asarray(out["right"])
            sep = stereo_separation_db(left, right, cfg.audio_fs, 1000.0,
                                       skip=skip)
            snr = tone_snr_db(left[skip:], cfg.audio_fs, 1000.0)
            dec = StreamingRdsDecoder(cfg.rds_sps)
            soft = np.asarray(out["rds_soft"])
            for i in range(0, len(soft), 2048):
                dec.push(soft[i:i + 2048])
            cells.append(f"{sep:5.1f} / {snr:5.1f} / {dec.info.groups_seen:2d}")
        print(f"{name:<20} {cells[0]:<24} {cells[1]:<24}", flush=True)


if __name__ == "__main__":
    main()
