"""Tiled banded-GEMM FIR/resampler: a matmul-shaped XLA alternative to conv.

The receiver's FIR stages are 1-input-channel convolutions (audio resample
N=1 out-channel stride-D, RDS resample N=U out-channels, RRC N=1).  This
module restructures the same math as dense matmuls: group G consecutive
output super-blocks into one tile, materialize each tile's input window by
a reshape + two slices (duplication = window-overlap only), and compute
all G·U outputs of a tile as ONE dense (span x G·U) matmul whose matrix
holds the polyphase filter bank on strided diagonals.  Channels ride M;
XLA can fuse the window assembly into the matmul's operand read.  Which of
the two engines ('conv' or 'tiled') is faster on a given device is a
measurement (ROADMAP Speed 2).

Exactly the reference resampler semantics (src/filter.cpp:67-103) — the
filter-bank matrix B and the carried-tail geometry are reused verbatim
from ops/resample.py; only the compute schedule differs (identical terms,
different reduction order: equivalence to float tolerance is gated in
tests/test_resample.py).

State-compatible drop-in for PolyphaseResampler: same state_len, same
(y, new_tail) contract, so checkpoints and halo-exchange geometry carry
over unchanged.
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from sdr_tpu.ops.resample import _build_filter_bank, _precision


def _tile_band_matrix(B: np.ndarray, down: int, group: int) -> np.ndarray:
    """Stack G super-blocks of the (L, U) polyphase bank on strided
    diagonals: A[l, g*U + v] = B[l - g*down, v] (zero outside).

    A tile's window w[l] = window_src[j*G*down + l] then yields all G*U
    outputs of tile j as w @ A — the same terms conv-with-stride computes,
    batched into one matmul.
    """
    L, up = B.shape
    span = (group - 1) * down + L
    a = np.zeros((span, group * up), np.float32)
    for g in range(group):
        a[g * down: g * down + L, g * up: (g + 1) * up] = B
    return a


class TiledBandedFIR:
    """Stateful U/D resampler computed as tiled banded GEMMs.

    Interface-identical to ops.resample.PolyphaseResampler (same carried
    tail).  `group` = output super-blocks per tile; the matmul is
    (C, span) @ (span, group*U) with span = (group-1)*D + L — pick group
    so group*U lands on a multiple of ~128 lanes.  Requires the window
    overlap (L - D) <= group*D so a tile window spans at most two
    consecutive reshape rows.
    """

    def __init__(self, coeff: np.ndarray, up: int = 1, down: int = 1,
                 group: int | None = None, compute_dtype=None):
        assert math.gcd(up, down) == 1 or up == 1, (up, down)
        self.up = int(up)
        self.down = int(down)
        self.taps = int(len(coeff))
        B, L, M, s_eff = _build_filter_bank(
            np.asarray(coeff, np.float64), up, down)
        self.L = L
        self.state_len = s_eff
        self.M = M
        if group is None:
            # fill >= 128 output lanes per tile, and enough that the
            # window overlap L-D fits within one tile advance
            group = max(1, -(-128 // up), -(-(L - down) // down))
        self.group = int(group)
        self.compute_dtype = compute_dtype or jnp.float32
        # bf16 compute: inputs/tails are stored at bf16 too — numerically
        # identical to f32 storage + per-use bf16 cast (the cast is the
        # first thing the einsum does), at half the HBM traffic
        self._store_dtype = (jnp.bfloat16
                             if self.compute_dtype == jnp.bfloat16
                             else jnp.float32)
        assert L - down <= self.group * down, (
            f"window overlap {L - down} exceeds tile advance "
            f"{self.group * down}: raise group")
        self._a = jnp.asarray(_tile_band_matrix(B, down, self.group))

    def init_state(self, batch_shape: tuple[int, ...] = ()) -> jax.Array:
        return jnp.zeros(batch_shape + (self.state_len,),
                         dtype=self._store_dtype)

    def __call__(self, x: jax.Array, tail: jax.Array):
        return _tiled_apply(self._a, self.up, self.down, self.state_len,
                            self.L, self.group, self.compute_dtype,
                            x.astype(self._store_dtype),
                            tail.astype(self._store_dtype))


@partial(jax.jit, static_argnums=(1, 2, 3, 4, 5, 6))
def _tiled_apply(a, up, down, state_len, L, group, compute_dtype, x, tail):
    *lead, n = x.shape
    assert n % down == 0, f"block length {n} % D={down} != 0"
    assert n >= state_len, f"block length {n} < state {state_len}"
    nsuper = n // down
    n_tiles = -(-nsuper // group)
    adv = group * down                       # window advance per tile
    span = a.shape[0]                        # (group-1)*down + L

    xp = jnp.concatenate([tail, x], axis=-1)
    # same window origin as ops/resample._resample_apply: the first
    # output's window starts M-1 samples into the carried tail
    M = L - (((up - 1) * down) // up if up > 1 else 0)
    start = state_len - (M - 1)
    # row r of the reshape holds xp[start + r*adv : start + (r+1)*adv];
    # tile j's window = rows j and j+1 truncated to span (overlap
    # span - adv = L - down <= adv by construction)
    need = start + (n_tiles + 1) * adv
    pad = need - xp.shape[-1]
    if pad > 0:
        xp = jnp.concatenate(
            [xp, jnp.zeros((*lead, pad), xp.dtype)], axis=-1)
    rows = jax.lax.dynamic_slice_in_dim(
        xp, start, (n_tiles + 1) * adv, axis=-1
    ).reshape(*lead, n_tiles + 1, adv)
    windows = jnp.concatenate(
        [rows[..., :-1, :], rows[..., 1:, : span - adv]], axis=-1)
    out = jnp.einsum(
        "...ts,su->...tu",
        windows.astype(compute_dtype), a.astype(compute_dtype),
        precision=_precision(compute_dtype),
        preferred_element_type=jnp.float32)
    y = out.reshape(*lead, n_tiles * group * up)[..., : nsuper * up]
    new_tail = x[..., n - state_len:]
    return y, new_tail
