"""How `correct` is decided: the served outputs against the reference.

For each sampled station and each output (`mono`, `left`, `right`,
`rds_soft`), every block of the window is compared with the reference's
output for the same stream: the block's RMS difference over the station's
RMS level of that output across the whole window.  The number compared for
an output is the largest of these over all sampled stations and blocks, so
one wrong block anywhere fails it.  A non-finite output reads infinite.
"""

from __future__ import annotations

import numpy as np


def block_errors(served: dict[str, np.ndarray],
                 ref: dict[str, np.ndarray]) -> dict[str, float]:
    """served[k]: (stations, blocks, per_block); ref[k]: (stations,
    blocks * per_block).  Returns {'<k>_err': worst block error}."""
    out = {}
    for key, r in ref.items():
        s = served.get(key)
        r = np.asarray(r, np.float64)
        if s is None or s.shape[0] * s.shape[1] * s.shape[2] != r.size:
            out[f"{key}_err"] = float("inf")
            continue
        r = r.reshape(s.shape)
        level = np.sqrt(np.mean(r ** 2, axis=(1, 2)))
        err = np.sqrt(np.mean((s.astype(np.float64) - r) ** 2, axis=2))
        err = err / np.maximum(level, 1e-30)[:, None]
        worst = float(np.max(err))
        out[f"{key}_err"] = worst if np.isfinite(worst) else float("inf")
    return out


def decide(checks: dict[str, float], limits: dict[str, float]) -> bool:
    """Every limited number present and within its limit."""
    return all(k in checks and checks[k] <= lim for k, lim in limits.items())
