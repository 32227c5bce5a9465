"""Wideband channelizer: one wide IQ capture -> N FM station basebands.

Beyond-reference capability: the reference consumes one tuned 2.4 MS/s
station; a production deployment captures a whole band segment at a
wideband rate and derives every station from it.  BASELINE's "64+
simultaneous FM channels" then needs only ONE front-end stream per antenna.

Two engines, mathematically identical (selected via ``engine=``):

``"mfb"`` (default) — *modulated filter bank*.  Fold the per-station mix
into the filter: with oscillator theta(n) = phi0 + dphi*(n+1) and LPF h,

    y[u] = sum_k h[k] * x[uD-k] * e^{j theta(uD-k)}
         = e^{j theta(uD)} * sum_k (h[k] e^{-j dphi k}) * x[uD-k]

so each station becomes a *complex band-pass* filter h~[k] = h[k]e^{-j dphi k}
applied directly to the raw wideband stream, decimated in the same pass.
The whole bank is ONE strided convolution with 2 input rails (I, Q) and 2K
output channels — a (2*taps x 2K) constant matrix, i.e. a GEMM — and the
only remaining oscillator work is a residual rotation at the *output* rate
(1/D of the wideband rate).  No K x N wideband intermediates exist at all;
the input block is read exactly once.

``"mix"`` — the v1 reference formulation: batched per-station wideband
complex rotate (K, N) followed by the framework's polyphase decimating LPF
on each rail.  Kept as the cross-check oracle for the mfb engine.

Both carry oscillator phase and a filter tail across blocks, so block
streaming is exact.  All rates integer; fs_wide must be an integer multiple
of fs_out.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from sdr_tpu import device
from sdr_tpu.ops.firdes import lowpass
from sdr_tpu.ops.resample import PolyphaseResampler


class WidebandChannelizer:
    """Mix + LPF + decimate K stations out of one wideband complex stream.

    Args:
      fs_wide: wideband sample rate (e.g. 9.6e6).
      fs_out: per-station output rate (e.g. 2.4e6, the mode-0 RF rate).
      station_freqs: center-frequency offsets (Hz, relative to the wideband
        capture center) for each station.
      cutoff: anti-alias LPF cutoff (default 100 kHz, the FM channel).
      taps: LPF taps at the wideband rate.
      engine: "mfb" (modulated filter bank, default) or "mix" (v1
        oracle).
      compute_dtype: "f32" (exact) or "bf16" — run the MFB GEMM with bf16
        inputs/filters (f32 accumulation).  The u8-ingest semantics stay
        exact ((x-128)/128 is representable in bf16); only the filter
        coefficients and wideband samples round, ~50 dB channelizer SNR —
        transparent under FM demod's ~25 dB distortion floor, at half the
        GEMM input traffic.
    """

    def __init__(self, fs_wide: float, fs_out: float,
                 station_freqs: list[float], *, cutoff: float = 100e3,
                 taps: int = 101, engine: str = "mfb",
                 compute_dtype: str = "f32"):
        decim = fs_wide / fs_out
        assert abs(decim - round(decim)) < 1e-9, (
            f"fs_wide/fs_out = {decim} must be integral")
        assert engine in ("mfb", "mix"), engine
        self.decim = int(round(decim))
        self.fs_wide = float(fs_wide)
        self.fs_out = float(fs_out)
        self.freqs = np.asarray(station_freqs, np.float64)
        self.k = len(station_freqs)
        self.engine = engine
        self.taps = int(taps)
        coeff = lowpass(fs_wide, cutoff, taps, 1)
        # per-station phase increment per wideband sample (float64 host-side;
        # per-block ramps are reduced mod 2*pi in f64 before casting, so long
        # blocks don't hit f32's ~0.008 rad resolution at 1e5 rad)
        self._dphi = (-2.0 * np.pi * self.freqs / fs_wide) % (2.0 * np.pi)
        self._ramp_cache: dict = {}
        assert compute_dtype in ("f32", "bf16"), compute_dtype
        self.compute_dtype = (jnp.bfloat16 if compute_dtype == "bf16"
                              else jnp.float32)
        if engine == "mix":
            self._lpf_i = PolyphaseResampler(coeff, 1, self.decim)
            self._lpf_q = PolyphaseResampler(coeff, 1, self.decim)
        else:
            rhs = _modulated_bank(np.asarray(coeff, np.float64), self._dphi)
            self.state_len = self.taps - 1
            # im2col GEMM formulation: B[2l+r, c] = rhs[c, r, l] maps the
            # bank onto interleaved window rows; rows padded to a multiple
            # of the 2D phase stride (extra rows are never-read zeros)
            two_t = 2 * self.taps
            self._n_shift = -(-two_t // (2 * self.decim))
            rows = 2 * self.decim * self._n_shift
            b = np.zeros((rows, 2 * self.k), np.float32)
            for l in range(self.taps):
                b[2 * l, :] = rhs[:, 0, l]
                b[2 * l + 1, :] = rhs[:, 1, l]
            self._bmat = jnp.asarray(b)

    def _phase_tables(self, n: int, stride: int, c: int | None = None):
        """Factored oscillator ramp for n samples taken every `stride`
        wideband samples: theta[k, i] = dphi_k*(i*stride + 1) mod 2pi.

        A flat (K, n) table would be embedded as an HLO constant whenever a
        caller wraps the channelizer in its own jit/scan (tens of MB for
        production block sizes), so the ramp is factored as an outer sum of
        two small host-f64-exact tables with i = a*C + b:
            row[k, a]  = dphi_k * (C*stride*a)   mod 2pi      (K, n/C)
            base[k, b] = dphi_k * (b*stride + 1) mod 2pi      (K, C)
        composed on device (sum of three in-[0,2pi) f32 terms, one mod).
        Also returns the (K,) per-block phase advance dphi_k*n*stride mod 2pi.
        """
        if c is None:
            c = min(n, 4096)
        key = (n, stride, c)
        if key not in self._ramp_cache:
            # c need not divide n: a is padded to ceil(n/c) and the composed
            # phasor is sliced back to n on device (so prime / awkward block
            # lengths never degrade to a full (K, n) table)
            a = -(-n // c)
            row = (self._dphi[:, None]
                   * (np.arange(a, dtype=np.float64) * (c * stride))[None, :]
                   ) % (2.0 * np.pi)
            base = (self._dphi[:, None]
                    * (np.arange(c, dtype=np.float64) * stride + 1.0)[None, :]
                    ) % (2.0 * np.pi)
            adv = (self._dphi * (n * stride)) % (2.0 * np.pi)
            # cache HOST arrays: a jnp.asarray here would produce a tracer
            # when the first call happens inside an enclosing jit trace
            # (e.g. models/wideband.py's scanned step) and poison the cache
            j = lambda x: np.asarray(x, np.float32)
            self._ramp_cache[key] = (
                (j(np.cos(row)), j(np.sin(row))),
                (j(np.cos(base)), j(np.sin(base))),
                j(adv))
        return self._ramp_cache[key]

    def init_state(self):
        if self.engine == "mix":
            return {
                "phase": jnp.zeros((self.k,), jnp.float32),
                "i_tail": self._lpf_i.init_state((self.k,)),
                "q_tail": self._lpf_q.init_state((self.k,)),
            }
        # mfb: one carried INTERLEAVED f32 tail (last 2*(taps-1) scalars)
        return {
            "phase": jnp.zeros((self.k,), jnp.float32),
            "tail": jnp.zeros((2 * self.state_len,), jnp.float32),
        }

    def __call__(self, i_wide: jax.Array, q_wide: jax.Array, state):
        """Channelize one wideband block (N,) -> per-station I/Q (K, N/D).

        Returns ((i_out, q_out), new_state).
        """
        if self.engine == "mix":
            row, base, adv = self._phase_tables(i_wide.shape[-1], 1)
            return _channelize(row, base, adv, self._lpf_i._rhs,
                               self._lpf_q._rhs, self.decim,
                               self._lpf_i.state_len, self._lpf_i.L,
                               i_wide, q_wide, state)
        body = jnp.stack([i_wide, q_wide], axis=-1).reshape(-1)
        return self._mfb_interleaved(body, state)

    def call_interleaved(self, wide: jax.Array, state):
        """Channelize directly from the RAW interleaved stream (2N,) —
        float32 or u8 (reference ingest semantics (x-128)/128,
        src/iofunc.cpp:62-69, decoded exactly inside the compute cast: the
        8x-larger f32 wideband stream never materializes in HBM)."""
        assert self.engine == "mfb", "interleaved ingest is an mfb feature"
        return self._mfb_interleaved(wide, state)

    def _mfb_interleaved(self, body: jax.Array, state):
        n = body.shape[-1] // 2
        n_out = n // self.decim
        # the GEMM time-tile doubles as the phasor factor c, so each tile's
        # residual rotation is one scalar-vector complex product per station.
        # Bigger tiles = fewer lax.map iterations (a sequential loop with
        # per-iteration overhead); 16384 keeps the per-tile im2col a few MB
        # and the factored base table bounded
        tile = _largest_divisor_at_most(n_out, 16384)
        row, base, adv = self._phase_tables(n_out, self.decim, c=tile)
        return _channelize_mfb(self._bmat, row, base, adv, self.decim,
                               self.state_len, self._n_shift, tile,
                               self.compute_dtype, body, state)


def _modulated_bank(coeff: np.ndarray, dphi: np.ndarray) -> np.ndarray:
    """(2K, 2, taps) conv rhs of complex band-pass filters, f64 -> f32.

    Station k's filter is h~[t] = h[t] * e^{-j dphi_k t}.  Conv channel
    layout (OIH, correlation over xp = tail ++ x so rhs index l maps to
    filter tap taps-1-l):
      out 2k   (real): in0 (I) = Re h~ reversed, in1 (Q) = -Im h~ reversed
      out 2k+1 (imag): in0 (I) = Im h~ reversed, in1 (Q) =  Re h~ reversed
    """
    taps = len(coeff)
    k = len(dphi)
    t = np.arange(taps, dtype=np.float64)
    ang = (dphi[:, None] * t[None, :]) % (2.0 * np.pi)    # (K, taps)
    hr = coeff[None, :] * np.cos(ang)
    hi = coeff[None, :] * -np.sin(ang)
    rhs = np.empty((2 * k, 2, taps), np.float32)
    rhs[0::2, 0, :] = hr[:, ::-1]
    rhs[0::2, 1, :] = -hi[:, ::-1]
    rhs[1::2, 0, :] = hi[:, ::-1]
    rhs[1::2, 1, :] = hr[:, ::-1]
    return rhs


def _compose_phasor(phase, row, base, n):
    """(cos, sin) of theta[k, i] = phase_k + row_[k,a] + base_[k,b] with
    i = a*C + b, WITHOUT per-element trig: the phasor e^{j theta} is the
    complex product of e^{j phase} (K on-device trig calls) with two small
    host-f64-exact phasor tables (K, A) x (K, C) — a pure mul/add outer
    product, which is what the VPU is fast at (per-element cos/sin on
    K*A*C elements dominated the whole channelizer otherwise).  A*C may
    exceed n (padded factoring); the result is sliced to the first n."""
    (rr, ri), (br, bi) = row, base
    k, a = rr.shape
    c = br.shape[1]
    er = (rr[:, :, None] * br[:, None, :]
          - ri[:, :, None] * bi[:, None, :]).reshape(k, a * c)[:, :n]
    ei = (rr[:, :, None] * bi[:, None, :]
          + ri[:, :, None] * br[:, None, :]).reshape(k, a * c)[:, :n]
    pr, pi = jnp.cos(phase)[:, None], jnp.sin(phase)[:, None]
    return pr * er - pi * ei, pr * ei + pi * er


def _largest_divisor_at_most(n: int, cap: int) -> int:
    for d in range(min(cap, n), 0, -1):
        if n % d == 0:
            return d
    return n


@partial(jax.jit, static_argnums=(4, 5, 6, 7, 8))
def _channelize_mfb(bmat, row, base, adv, decim, state_len, n_shift, tile,
                    compute_dtype, body, state):
    """MFB channelizer as an explicit im2col GEMM with in-tile rotation.

    The equivalent 2-input-channel strided conv is written as a GEMM so it
    runs as a dense matmul.  With window row j = 2*D*a + b the im2col
    matrix is A static shifted slices of the phase-reshaped stream —
    out[u, c] = sum_j B[j, c] * xb[2*D*u + j] — tiled by lax.map so the
    materialized im2col stays a few MB.  The residual per-station rotation
    happens inside the same tile: the factored oscillator's inner table
    spans exactly one tile, so tile t's phasor is base * (one complex
    scalar per station), and no (K, n_out) phasor/pre-rotation
    intermediate ever exists in HBM (that traffic, not the conv FLOPs,
    dominated the round-2 engine).  u8 input decodes exactly inside the
    compute-dtype cast ((x-128)/128 is representable in bf16), so the 8x
    f32 wideband stream never exists in HBM either.
    """
    n2 = body.shape[-1]
    n = n2 // 2
    assert n % decim == 0, f"block length {n} must be divisible by D={decim}"
    assert n >= state_len, f"block length {n} < state length {state_len}"
    n_out = n // decim
    two_d = 2 * decim
    two_k = bmat.shape[1]

    if body.dtype == jnp.uint8:
        body_c = ((body.astype(compute_dtype) - compute_dtype(128.0))
                  * compute_dtype(1.0 / 128.0))
        tail_new = ((body[n2 - 2 * state_len:].astype(jnp.float32) - 128.0)
                    / 128.0)
    else:
        body_c = body.astype(compute_dtype)
        tail_new = body[n2 - 2 * state_len:].astype(jnp.float32)
    xb = jnp.concatenate([state["tail"].astype(compute_dtype), body_c])

    rows = n_out + n_shift
    need = two_d * rows
    xb = (jnp.pad(xb, (0, need - xb.shape[-1])) if need > xb.shape[-1]
          else xb[:need])
    xr = xb.reshape(rows, two_d)
    bm = bmat.astype(compute_dtype)
    precision = None
    if compute_dtype == jnp.bfloat16 and device.bf16_dot_needs_upcast():
        # CPU's dot thunk lacks bf16 x bf16 -> f32; keep the bf16 rounding
        # (numerics identical to storage-level bf16) but dot in f32
        xr = xr.astype(jnp.float32)
        bm = bm.astype(jnp.float32)
    elif compute_dtype == jnp.float32:
        precision = jax.lax.Precision.HIGHEST  # no TF32 on the exact path

    # per-block phase offset phasor (K, 1)
    pr = jnp.cos(state["phase"])[:, None]
    pi_ = jnp.sin(state["phase"])[:, None]
    (rr, ri), (br, bi) = row, base                      # (K, A), (K, tile)
    bmt = bm.T                                          # (2K, 2D*n_shift)
    xrt = xr.T                                          # (2D, rows)

    def tile_fn(a):
        # station-major GEMM: bm.T @ xim.T gives (2K, tile) directly, so
        # the per-tile (tile, 2K) -> (2K, tile) strided transpose of the
        # round-3 formulation never happens; only the tiny (rows, 2D)
        # input transpose is paid, once, outside the loop
        xt = jax.lax.dynamic_slice(xrt, (jnp.int32(0), a * tile),
                                   (two_d, tile + n_shift))
        xim_t = jnp.concatenate([xt[:, s:s + tile] for s in range(n_shift)],
                                axis=0)                # (2D*n_shift, tile)
        out = jnp.dot(bmt, xim_t, precision=precision,
                      preferred_element_type=jnp.float32)
        c_r, c_i = out[0::2], out[1::2]                # (K, tile)
        # tile phasor: (phase ⊕ row[a]) ⊗ base — one complex scalar/station
        ra = jax.lax.dynamic_slice_in_dim(rr, a, 1, axis=1)  # (K, 1)
        ia = jax.lax.dynamic_slice_in_dim(ri, a, 1, axis=1)
        sr = pr * ra - pi_ * ia
        si = pr * ia + pi_ * ra
        cos_t = sr * br - si * bi
        sin_t = sr * bi + si * br
        return c_r * cos_t - c_i * sin_t, c_r * sin_t + c_i * cos_t

    i_t, q_t = jax.lax.map(tile_fn, jnp.arange(n_out // tile,
                                               dtype=jnp.int32))
    k = two_k // 2
    i_out = jnp.moveaxis(i_t, 0, 1).reshape(k, n_out)
    q_out = jnp.moveaxis(q_t, 0, 1).reshape(k, n_out)
    new_state = {
        "phase": jnp.mod(state["phase"] + adv, jnp.float32(2.0 * np.pi)),
        "tail": tail_new,
    }
    return (i_out, q_out), new_state


@partial(jax.jit, static_argnums=(5, 6, 7))
def _channelize(row, base, adv, rhs_i, rhs_q, decim, state_len, L,
                i_wide, q_wide, state):
    # batched oscillator: theta[k, t] = phase_k + dphi_k*(t+1), as phasors
    cos_t, sin_t = _compose_phasor(state["phase"], row, base,
                                   i_wide.shape[-1])
    x_i = i_wide[None, :]
    x_q = q_wide[None, :]
    # complex multiply (x_i + j x_q) * (cos + j sin)  [sin already signed
    # via the negative dphi]
    mix_i = x_i * cos_t - x_q * sin_t
    mix_q = x_i * sin_t + x_q * cos_t
    from sdr_tpu.ops.resample import _resample_apply
    i_out, i_tail = _resample_apply(rhs_i, 1, decim, state_len, L,
                                    jnp.float32, mix_i, state["i_tail"])
    q_out, q_tail = _resample_apply(rhs_q, 1, decim, state_len, L,
                                    jnp.float32, mix_q, state["q_tail"])
    new_state = {"phase": jnp.mod(state["phase"] + adv,
                                  jnp.float32(2.0 * np.pi)),
                 "i_tail": i_tail, "q_tail": q_tail}
    return (i_out, q_out), new_state


def synthesize_wideband(station_captures_iq: list[np.ndarray],
                        station_freqs: list[float], fs_station: float,
                        fs_wide: float) -> tuple[np.ndarray, np.ndarray]:
    """TX-side helper: place per-station complex basebands (I+jQ float
    arrays at fs_station) at offsets in one wideband stream (for tests)."""
    import scipy.signal as sps
    from fractions import Fraction
    up = Fraction(int(fs_wide), int(fs_station))
    outs = []
    for x, f in zip(station_captures_iq, station_freqs):
        xw = sps.resample_poly(x, up.numerator, up.denominator)
        t = np.arange(len(xw)) / fs_wide
        outs.append(xw * np.exp(2j * np.pi * f * t))
    wide = np.sum(outs, axis=0)
    return wide.real.astype(np.float32), wide.imag.astype(np.float32)
