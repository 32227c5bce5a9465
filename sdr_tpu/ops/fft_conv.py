"""FFT overlap-save block convolution — the frequency-domain filter engine.

The reference's fourier.cpp FFT family is groundwork for FFT convolution it
never built (SURVEY §2.1 C9); the north star requires both a direct
polyphase FIR and an FFT overlap-save variant.  For U=1 resampling (plain
FIR + decimate) overlap-save is:

  per block: y_full = irfft(rfft([tail, x]) * rfft(h, padded))  then drop
  the first taps-1 warm-up samples and decimate.

For U>1 (the rational resamplers of modes 2/3, reference
src/filter.cpp:67-103 at the factors of src/project.cpp:344-362) the
zero-stuffed input's spectrum is the input spectrum replicated U times, so
overlap-save at the upsampled rate costs only one tiled pointwise multiply
and one length-U*nfft inverse FFT — the stuffed stream itself never
materializes in time domain:

  y[n] = (stuff_U([tail, x]) conv h)[U*S + n*D],   S = ceil((taps-1)/U)
       = ifft(tile(fft([tail, x], nfft), U) * fft(h, U*nfft))[U*S + n*D]

Exact to the direct form up to FFT rounding (tested vs PolyphaseResampler,
all mode (U, D) pairs).  Most efficient when taps is large; at the
reference's 51 taps the direct filter bank is the usual choice, but the engine is
selectable per stage (the "two interchangeable convolution engines" north
star).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


class OverlapSaveFIR:
    """Stateful FFT-domain rational resampler, drop-in for
    PolyphaseResampler (state layout matches: carried tail = the last
    ceil((taps-1)/U) input samples)."""

    def __init__(self, coeff: np.ndarray, down: int = 1, up: int = 1):
        self.taps = int(len(coeff))
        self.down = int(down)
        self.up = int(up)
        self.state_len = -(-(self.taps - 1) // self.up)
        self._coeff = np.asarray(coeff, np.float32)
        self._h_freq_cache: dict[int, jax.Array] = {}

    def init_state(self, batch_shape: tuple[int, ...] = ()) -> jax.Array:
        return jnp.zeros(batch_shape + (self.state_len,), dtype=jnp.float32)

    def _h_freq(self, nfft: int) -> jax.Array:
        """fft(h, up*nfft): rfft for up==1, full complex fft otherwise."""
        if nfft not in self._h_freq_cache:
            h = np.zeros(self.up * nfft, np.float64)
            h[: self.taps] = self._coeff
            f = np.fft.rfft(h) if self.up == 1 else np.fft.fft(h)
            self._h_freq_cache[nfft] = jnp.asarray(f.astype(np.complex64))
        return self._h_freq_cache[nfft]

    def __call__(self, x: jax.Array, tail: jax.Array):
        n = x.shape[-1]
        assert (n * self.up) % self.down == 0
        nfft = int(2 ** np.ceil(np.log2(n + self.state_len)))
        hf = self._h_freq(nfft)
        if self.up == 1:
            y = _overlap_save(x, tail, hf, nfft, self.state_len, self.down)
        else:
            y = _overlap_save_up(x, tail, hf, nfft, self.state_len,
                                 self.down, self.up)
        new_tail = x[..., n - self.state_len:]
        return y, new_tail


@partial(jax.jit, static_argnums=(3, 4, 5))
def _overlap_save(x, tail, h_freq, nfft, state_len, down):
    n = x.shape[-1]
    xp = jnp.concatenate([tail, x], axis=-1)
    xf = jnp.fft.rfft(xp, n=nfft, axis=-1)
    y_full = jnp.fft.irfft(xf * h_freq, n=nfft, axis=-1)
    # output sample m of the streaming FIR = y_full[state_len + m]
    y = jax.lax.dynamic_slice_in_dim(y_full, state_len, n, axis=-1)
    if down > 1:
        y = y[..., ::down]
    return y.astype(jnp.float32)


@partial(jax.jit, static_argnums=(3, 4, 5, 6))
def _overlap_save_up(x, tail, h_freq, nfft, state_len, down, up):
    """U>1 overlap-save: spectral replication stands in for zero-stuffing.

    In the upsampled domain the carried tail occupies positions
    [0, U*S) with input samples at multiples of U, so the streaming output
    n lives at linear-convolution index U*S + n*D — past the taps-1
    circularly-contaminated prefix (U*S >= taps-1 by construction).
    """
    n = x.shape[-1]
    n_out = (n * up) // down
    xp = jnp.concatenate([tail, x], axis=-1)
    xf = jnp.fft.fft(xp, n=nfft, axis=-1)
    xu = jnp.tile(xf, (1,) * (xf.ndim - 1) + (up,))      # fft of stuffed
    y_full = jnp.fft.ifft(xu * h_freq, axis=-1).real
    start = up * state_len
    span = (n_out - 1) * down + 1
    y = jax.lax.dynamic_slice_in_dim(y_full, start, span, axis=-1)
    if down > 1:
        y = y[..., ::down]
    return y.astype(jnp.float32)
