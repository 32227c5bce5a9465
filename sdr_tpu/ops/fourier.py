"""Fourier transforms and Bartlett PSD estimation.

Reference: src/fourier.cpp (DFT/IDFT src/fourier.cpp:14-22,120-129; three
FFT variants src/fourier.cpp:167-260; Bartlett PSD src/fourier.cpp:35-117)
and model/fmSupportLib.py:66-161.  In the reference these are offline
analysis / unit-test tools, not in the audio path (SURVEY §1 L2); here they
also back the FFT overlap-save convolution variant (ops/fft_conv.py).

The transform *is* jnp.fft (XLA's native FFT); the explicit DFT-as-matmul
variant is provided as the O(N^2) reference oracle (at full f32 precision)
and as a dense-matmul alternative for small N.
Bartlett PSD is a batched reshape + window + rfft — no loops.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

NFFT = 512  # reference include/dy4.h:18


@jax.jit
def dft(x: jax.Array) -> jax.Array:
    """O(N^2) DFT as a dense matmul (reference src/fourier.cpp:14-22).

    Note the reference uses exp(+1j*2*pi*(-k)*m/N) == standard forward DFT.
    """
    n = x.shape[-1]
    k = np.arange(n)
    w = np.exp(-2j * np.pi * np.outer(k, k) / n).astype(np.complex64)
    return jnp.matmul(jnp.asarray(x, jnp.complex64), w,
                      precision=jax.lax.Precision.HIGHEST)


@jax.jit
def idft(xf: jax.Array) -> jax.Array:
    """Inverse DFT with 1/N normalization (reference src/fourier.cpp:120-129)."""
    n = xf.shape[-1]
    k = np.arange(n)
    w = np.exp(2j * np.pi * np.outer(k, k) / n).astype(np.complex64) / n
    return jnp.matmul(xf, w, precision=jax.lax.Precision.HIGHEST)


@jax.jit
def fft(x: jax.Array) -> jax.Array:
    """Radix-2 FFT — XLA-native (stands in for the reference's recursive /
    twiddle-cached / iterative variants, src/fourier.cpp:167-260, which are
    implementation details of the same transform)."""
    return jnp.fft.fft(x)


@jax.jit
def ifft(x: jax.Array) -> jax.Array:
    return jnp.fft.ifft(x)


@jax.jit
def vector_magnitude(xf: jax.Array) -> jax.Array:
    """|Xf| (reference src/fourier.cpp:25-32 `computeVectorMagnitude`)."""
    return jnp.abs(xf)


@partial(jax.jit, static_argnames=("nfft", "fs"))
def estimate_psd(samples: jax.Array, nfft: int = NFFT, fs: float = 1.0):
    """Bartlett PSD estimate in dB (reference src/fourier.cpp:35-117,
    model/fmSupportLib.py:86-161).

    Hann-windowed non-overlapping segments -> |FFT|^2 -> power -> dB ->
    per-bin mean over segments.  Returns (freq (nfft/2,), psd_db (nfft/2,)).
    Trailing samples beyond a whole segment are dropped, like the reference.
    """
    n = samples.shape[-1]
    nseg = n // nfft
    segs = samples[..., : nseg * nfft].reshape(*samples.shape[:-1], nseg, nfft)
    i = np.arange(nfft)
    hann = np.sin(i * np.pi / nfft) ** 2  # reference window (src/fourier.cpp:50-53)
    xf = jnp.fft.fft(segs * hann, axis=-1)[..., : nfft // 2]
    psd_seg = (1.0 / (fs * nfft / 2.0)) * jnp.abs(xf) ** 2
    psd_seg = 2.0 * psd_seg  # fold negative-frequency energy
    psd_db = 10.0 * jnp.log10(psd_seg)
    psd = jnp.mean(psd_db, axis=-2)
    freq = np.arange(nfft // 2) * (fs / nfft)
    return freq, psd
