"""Least work of the RF front end, from shapes alone.

Per station and step: read the u8 I/Q batch once (2 bytes per complex
sample) and write `fm_demod` once at the precision the later stages read it
in (bfloat16 in the configurations that state bfloat16 FIR stages: 2
bytes).  Operations: the taps-long FIR at the decimated rate on I and on Q
(a multiply and an add per tap), and the discriminator (8 per output: two
differences, four products, a subtraction and a division).  The count is
the same whatever implements the front end.
"""

from __future__ import annotations


def counts(stations: int, iq_samples: int, taps: int, decim: int,
           out_bytes: int = 2) -> dict:
    outputs = stations * (iq_samples // decim)
    return {"bytes": stations * 2 * iq_samples + outputs * out_bytes,
            "flops": outputs * (2 * 2 * taps + 8)}


def least_time(work: dict, peak: dict) -> tuple[float, str]:
    """(seconds, bound): the larger of bytes over HBM bandwidth and float32
    operations over the CUDA cores' float32 rate (the front end runs in
    float32, outside the tensor cores)."""
    t_bytes = work["bytes"] / peak["hbm_bytes_per_s"]
    t_ops = work["flops"] / peak["f32_flops_per_s"]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "flops")
