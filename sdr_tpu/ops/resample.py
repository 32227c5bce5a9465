"""Stateful polyphase rational resampler (upsample-U / FIR / downsample-D).

This is the single convolution engine of the receiver, the device
equivalent of the reference's `resample` (src/filter.cpp:67-103).  The
reference computes, per kept output n (Nout = N*U/D):

    out[n] = sum_{k ≡ (nD) mod U, k < taps} coeff[k] * x[(nD - k)/U]

with negative input indices resolved into a carried tail of the previous
block's last taps-1 input samples (src/filter.cpp:85-91), and the tail
refreshed from the current block (src/filter.cpp:95-102).

Design
------
Instead of the reference's scalar double loop, we factor the computation into
a *filter bank*: outputs are grouped into super-blocks of U consecutive
outputs, each consuming a window of L input samples advancing by exactly D
samples per super-block.  The per-phase coefficient walk becomes a constant
(L x U) matrix B, and the whole resampler is one strided 1-D convolution with
U output channels.  The math is exact
(identical index arithmetic; see derivation in `_build_filter_bank`).

The carried state is the last ceil((taps-1)/U) input samples — the only
reachable portion of the reference's taps-1 tail (for U>1 the reference
carries taps-1 samples but only ever indexes the last ceil((taps-1)/U),
since j = (nD-k)/U >= -(taps-1)/U).

Supports arbitrary leading batch dims (channels), mapped to the conv batch.
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def _build_filter_bank(coeff: np.ndarray, up: int, down: int):
    """Build the (L, U) filter-bank matrix B and window geometry.

    Derivation: write output index n = u*U + v (u = super-block, v in [0,U)).
    The reference phase walk gives
        out[uU+v] = sum_m coeff[r_v + mU] * xp[S + uD + d_v - m]
    with r_v = (vD) mod U, d_v = floor(vD/U), xp = tail ++ x, S = len(tail).
    Taking the window w_u[l] = xp[S + uD - (M-1) + l], l in [0, L):
        out[uU+v] = sum_l B[l, v] * w_u[l],
        B[l, v]  = coeff[r_v + (d_v + M - 1 - l) * U]   (0 where out of range)
    with M = ceil(taps/U), d_max = floor((U-1)D/U), L = M + d_max.
    """
    taps = len(coeff)
    M = -(-taps // up)                       # ceil(taps/U)
    d = [(v * down) // up for v in range(up)]
    r = [(v * down) % up for v in range(up)]
    d_max = d[-1] if up > 1 else 0
    L = M + d_max
    B = np.zeros((L, up), dtype=np.float32)
    for v in range(up):
        for l in range(L):
            m = d[v] + M - 1 - l
            k = r[v] + m * up
            if 0 <= m and k < taps:
                B[l, v] = coeff[k]
    s_eff = -(-(taps - 1) // up)             # ceil((taps-1)/U): carried tail
    return B, L, M, s_eff


class PolyphaseResampler:
    """Stateful U/D resampler; create once, apply per block.

    Exactly reproduces reference src/filter.cpp:67-103 output for blocks whose
    length N satisfies D | N and N >= state length.
    """

    def __init__(self, coeff: np.ndarray, up: int = 1, down: int = 1,
                 compute_dtype=None):
        assert math.gcd(up, down) == 1 or (up == 1), (
            "U and D should be coprime (reference modes are)")
        self.up = int(up)
        self.down = int(down)
        self.taps = int(len(coeff))
        B, L, M, s_eff = _build_filter_bank(np.asarray(coeff, np.float64), up, down)
        self.L = L
        self.state_len = s_eff
        # bf16 option: coefficient + signal rounding only, f32 accumulation
        # (~45-50 dB conv SNR — the fast profile for behavioral chains).
        # Inputs and the carried tail are stored in the compute dtype: the
        # cast is the first thing the conv does, so this is numerically
        # identical to f32 storage, and the tail dtype no longer depends on
        # the dtype of the stream fed in
        self.compute_dtype = compute_dtype or jnp.float32
        # conv rhs layout: (out_channels=U, in_channels=1, width=L)
        self._rhs = jnp.asarray(B.T[:, None, :], dtype=jnp.float32)

    def init_state(self, batch_shape: tuple[int, ...] = ()) -> jax.Array:
        return jnp.zeros(batch_shape + (self.state_len,),
                         dtype=self.compute_dtype)

    def __call__(self, x: jax.Array, tail: jax.Array):
        """Apply to block x (..., N) with carried tail (..., state_len).

        Returns (y, new_tail) with y shape (..., N*U/D).
        """
        return _resample_apply(self._rhs, self.up, self.down, self.state_len,
                               self.L, self.compute_dtype,
                               x.astype(self.compute_dtype),
                               tail.astype(self.compute_dtype))


def _precision(compute_dtype):
    """f32 products run at full f32 precision (a GPU would otherwise be free
    to use TF32, ~3 decimal digits); bf16 products keep the default."""
    if jnp.dtype(compute_dtype) == jnp.float32:
        return jax.lax.Precision.HIGHEST
    return None


@partial(jax.jit, static_argnums=(1, 2, 3, 4, 5))
def _resample_apply(rhs, up, down, state_len, L, compute_dtype, x, tail):
    *lead, n = x.shape
    assert n % down == 0, f"block length {n} must be divisible by D={down}"
    assert n >= state_len, f"block length {n} < state length {state_len}"
    nsuper = n // down
    M = L - (((up - 1) * down) // up if up > 1 else 0)
    xp = jnp.concatenate([tail, x], axis=-1)          # (..., S + N)
    start = state_len - (M - 1)
    span = (nsuper - 1) * down + L
    window_src = jax.lax.dynamic_slice_in_dim(xp, start, span, axis=-1)
    batch = int(np.prod(lead)) if lead else 1
    lhs = window_src.reshape(batch, 1, span)
    out = jax.lax.conv_general_dilated(
        lhs.astype(compute_dtype), rhs.astype(compute_dtype),
        window_strides=(down,),
        padding="VALID",
        dimension_numbers=("NCH", "OIH", "NCH"),
        precision=_precision(compute_dtype),
        preferred_element_type=jnp.float32,
    )                                                  # (batch, U, nsuper)
    y = jnp.moveaxis(out, 1, 2).reshape(*lead, nsuper * up)
    new_tail = x[..., n - state_len:]
    return y, new_tail


def fir_filter(coeff: np.ndarray) -> PolyphaseResampler:
    """Plain stateful FIR (U=1, D=1) — reference `resample(..., 1, 1)` usage
    for the band-pass stages (src/project.cpp:162,165,245,255)."""
    return PolyphaseResampler(coeff, 1, 1)


def resample_reference(x, state, coeff, up, down):
    """Scalar NumPy oracle with the reference's exact loop structure
    (src/filter.cpp:67-103) — used by the unit tests as ground truth."""
    x = np.asarray(x, np.float64)
    coeff = np.asarray(coeff, np.float64)
    state = np.asarray(state, np.float64)
    taps = len(coeff)
    n_in = len(x)
    out = np.zeros((n_in * up) // down, dtype=np.float64)
    ssize = len(state)
    for n in range(len(out)):
        k = (n * down) % up
        while k < taps:
            j = (n * down - k) // up
            if j >= 0:
                out[n] += coeff[k] * x[j]
            else:
                out[n] += coeff[k] * state[ssize + j]
            k += up
    new_state = x[n_in - (taps - 1):] if taps > 1 else x[:0]
    return out, new_state


class MultiFIR:
    """k parallel plain FIRs over the SAME input in one conv (U=1, D=1).

    The stereo path runs two 51-tap BPFs (channel 22-54 kHz, pilot
    18.5-19.5 kHz) over the same demodulated IF stream with identical tail
    semantics (reference src/project.cpp:162-165) — as separate convs the
    input is read twice.  Stacking the filters as conv output channels
    halves the reads; the carried tail (last max_taps-1 inputs) is shared.
    Filters with fewer taps are zero-padded to the longest (appending
    zeros at high k leaves y[n] = sum_k c[k] x[n-k] unchanged), so
    per-stage tap tuning never forfeits the fusion.
    """

    def __init__(self, coeffs: list[np.ndarray], compute_dtype=None):
        self.taps = max(len(c) for c in coeffs)
        self.k = len(coeffs)
        self.state_len = self.taps - 1
        self.compute_dtype = compute_dtype or jnp.float32  # storage too
        rhs = np.stack([
            np.pad(np.asarray(c, np.float32),
                   (0, self.taps - len(c)))[::-1] for c in coeffs])
        self._rhs = jnp.asarray(rhs[:, None, :])  # (k, 1, max_taps)

    def init_state(self, batch_shape: tuple[int, ...] = ()) -> jax.Array:
        return jnp.zeros(batch_shape + (self.state_len,),
                         dtype=self.compute_dtype)

    def __call__(self, x: jax.Array, tail: jax.Array):
        """x (..., N), tail (..., taps-1) -> (list of k outputs, new_tail)."""
        return _multi_fir_apply(self._rhs, self.state_len,
                                self.compute_dtype,
                                x.astype(self.compute_dtype),
                                tail.astype(self.compute_dtype))


@partial(jax.jit, static_argnums=(1, 2))
def _multi_fir_apply(rhs, state_len, compute_dtype, x, tail):
    *lead, n = x.shape
    xp = jnp.concatenate([tail, x], axis=-1)
    batch = int(np.prod(lead)) if lead else 1
    lhs = xp.reshape(batch, 1, xp.shape[-1])
    out = jax.lax.conv_general_dilated(
        lhs.astype(compute_dtype), rhs.astype(compute_dtype),
        window_strides=(1,), padding="VALID",
        dimension_numbers=("NCH", "OIH", "NCH"),
        precision=_precision(compute_dtype),
        preferred_element_type=jnp.float32,
    )  # (batch, k, n)
    outs = [out[:, i, :].reshape(*lead, n) for i in range(rhs.shape[0])]
    new_tail = x[..., n - state_len:]
    return outs, new_tail
