"""Quality-vs-chunk probe for the chunk-vectorized PLL.

The frozen-feedback chunk size trades sequential steps (throughput) against
open-loop prediction error (stereo separation, RDS sync).  This sweeps
chunk sizes on CPU and reports the behavioral metrics the test suite gates
on, so the --fast default can be chosen from data.

    JAX_PLATFORMS=cpu python tools/sweep_pll_quality.py
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402


def main() -> int:
    from sdr_tpu import tx
    from sdr_tpu.config import MODES
    from sdr_tpu.models.receiver import Receiver
    from sdr_tpu.rds import tx as rds_tx
    from sdr_tpu.rds import decode_rds_soft
    from sdr_tpu.utils.compare import stereo_separation_db, tone_snr_db

    cfg = MODES[0]
    # stereo capture: L-only 1 kHz + R-only 2.5 kHz
    sec_st = 0.6
    n = int(sec_st * cfg.rf_fs)
    cap_st = tx.synthesize_capture(cfg, seconds=sec_st,
                                   left=tx.tone(cfg.rf_fs, 1000.0, n),
                                   right=tx.tone(cfg.rf_fs, 2500.0, n))
    # RDS capture
    sec_rds = 1.2
    bits = rds_tx.standard_group_stream(
        pi=0x3D44, ps_name="SDR FM  ",
        n_groups=int(sec_rds * 1187.5 / 104) + 2)
    rds_bb = rds_tx.bits_to_baseband(bits, cfg.rf_fs)
    n2 = int(sec_rds * cfg.rf_fs)
    cap_rds = tx.synthesize_capture(cfg, seconds=sec_rds,
                                    mono=tx.tone(cfg.rf_fs, 1000.0, n2),
                                    rds_baseband=rds_bb[:n2], a_rds=0.1)
    skip = cfg.audio_fs // 4

    print(f"{'chunk':>6} {'sep_L dB':>9} {'sep_R dB':>9} {'snr_L dB':>9} "
          f"{'rds_groups':>10} {'pi_ok':>6}")
    # chunk must divide the per-block IF length (640 at blocks_per_step=1)
    for chunk in [64, 128, 160]:
        rx = Receiver(0, stereo=True, pll_impl="chunked", pll_chunk=chunk)
        out, _ = rx.run(cap_st)
        l, r = np.asarray(out["left"]), np.asarray(out["right"])
        sep_l = stereo_separation_db(l, r, cfg.audio_fs, 1000.0, skip=skip)
        sep_r = stereo_separation_db(r, l, cfg.audio_fs, 2500.0, skip=skip)
        snr_l = tone_snr_db(l, cfg.audio_fs, 1000.0, skip=skip)

        rxr = Receiver(0, rds=True, pll_impl="chunked", pll_chunk=chunk)
        outr, _ = rxr.run(cap_rds, blocks_per_step=4)
        info = decode_rds_soft(np.asarray(outr["rds_soft"]), cfg.rds_sps)
        print(f"{chunk:>6} {sep_l:>9.1f} {sep_r:>9.1f} {snr_l:>9.1f} "
              f"{info.groups_seen:>10} {str(info.pi == 0x3D44):>6}",
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
