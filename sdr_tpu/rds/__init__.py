"""RDS (Radio Data System) decode stack.

On-device: carrier recovery / resampling / RRC (in models/receiver.py) and
clock-data recovery (rds/timing.py).  Host-side: bit decode, frame sync and
application layer (kbit/s rates).  `decode_rds_soft` chains the full
post-RRC path.
"""

from __future__ import annotations

import numpy as np

from sdr_tpu.rds.app import StationInfo, decode_groups, update_info
from sdr_tpu.rds.decode import biphase_decode, differential_decode
from sdr_tpu.rds.framing import extract_groups
from sdr_tpu.rds.streaming import StreamingRdsDecoder
from sdr_tpu.rds.timing import recover_symbols


def decode_rds_soft(soft: np.ndarray, sps: int) -> StationInfo:
    """RRC-filtered soft waveform (at SPS*2375) -> decoded station info."""
    symbols, _ = recover_symbols(np.asarray(soft), sps)
    bits_diff, _ = biphase_decode(np.asarray(symbols))
    bits = differential_decode(bits_diff)
    groups, _ = extract_groups(bits)
    return decode_groups(groups)


__all__ = ["StationInfo", "decode_groups", "update_info", "biphase_decode",
           "differential_decode", "extract_groups", "recover_symbols",
           "decode_rds_soft", "StreamingRdsDecoder"]
