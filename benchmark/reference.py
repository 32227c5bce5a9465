"""Plain reference FM receiver, written from the published signal chain.

It follows the 3DY4 reference receiver (`src/project.cpp`, `src/filter.cpp`:
windowed-sinc Hann FIRs, the upsample/filter/downsample resampler, the
arctan-free discriminator, the mixer and the L/R matrix) and, for what the
C++ leaves out, the FM/RDS specification the program's configuration names:
the RDS chain (54-60 kHz channel, squaring, 114 kHz band-pass, carrier at
half phase, 3 kHz low-pass resampler to SPS x 2375, root-raised-cosine
matched filter) and feedforward carrier recovery (a coherent average over
each `window` of samples against the nominal carrier, one phase per window,
the phases unwrapped into a track, a linear phase ramp per window).

Everything is computed in float32 element by element (a gather, a product
and a sum per filter output), so no matrix unit and no TF32 can take part.
`precision` rounds the filter operands before the product: 'f32' is the
reference itself; 'control' puts each FIR one precision below what the
configuration states (the front end's float32 to bfloat16, the bfloat16
stages after the discriminator to fp8 e4m3 with a per-tensor scale).

It imports nothing of the program: the configuration file gives the rates
and sizes, and the filters are designed here.
"""

from __future__ import annotations

import math
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np

F8_MAX = 240.0      # largest normal of a 4-bit exponent, 3-bit mantissa float


# ------------------------------------------------------------ filter design
def lowpass(fs, fc, taps, gain=1.0):
    """Hann-windowed sinc (src/filter.cpp impulseResponseLPF)."""
    nfc = fc / (fs / 2.0)
    i = np.arange(taps, dtype=np.float64)
    arg = np.pi * nfc * (i - (taps - 1) / 2.0)
    safe = np.where(arg == 0.0, 1.0, arg)
    h = np.where(arg == 0.0, nfc, nfc * np.sin(arg) / safe)
    return (h * np.sin(i * np.pi / taps) ** 2 * gain).astype(np.float32)


def bandpass(fs, fb, fe, taps):
    """Cosine-shifted Hann sinc (src/filter.cpp impulseResponseBPF)."""
    cent = (fe + fb) / fs
    width = 2.0 * (fe - fb) / fs
    i = np.arange(taps, dtype=np.float64)
    arg = np.pi * (width / 2.0) * (i - (taps - 1) / 2.0)
    safe = np.where(arg == 0.0, 1.0, arg)
    h = np.where(arg == 0.0, width, width * np.sin(arg) / safe)
    h = h * np.cos(i * np.pi * cent) * np.sin(i * np.pi / taps) ** 2
    return h.astype(np.float32)


def root_raised_cosine(fs, taps, symbol_rate, beta=0.9):
    """RRC matched filter, unit energy per symbol period of samples."""
    ts = fs / symbol_rate
    x = (np.arange(taps, dtype=np.float64) - (taps - 1) / 2.0) / ts
    with np.errstate(divide="ignore", invalid="ignore"):
        h = ((np.sin(np.pi * x * (1 - beta))
              + 4 * beta * x * np.cos(np.pi * x * (1 + beta)))
             / (np.pi * x * (1 - (4 * beta * x) ** 2)))
    h = np.where(x == 0.0, 1 - beta + 4 * beta / np.pi, h)
    sing = np.isclose(np.abs(x), 1.0 / (4 * beta))
    hs = (beta / np.sqrt(2.0)) * ((1 + 2 / np.pi) * np.sin(np.pi / (4 * beta))
                                  + (1 - 2 / np.pi) * np.cos(np.pi / (4 * beta)))
    h = np.where(sing, hs, h) / np.sqrt(ts)
    return h.astype(np.float32)


# ------------------------------------------------------------- rounding
def _round(v, kind):
    """Operand rounding: None keeps float32.  reduce_precision is an
    explicit rounding XLA keeps (a float32 -> float8 -> float32 round trip
    may be dropped as excess precision on the GPU)."""
    if kind is None:
        return v
    if kind == "bf16":
        return jax.lax.reduce_precision(v, exponent_bits=8, mantissa_bits=7)
    if kind == "fp8":
        # e4m3 with a per-tensor scale that maps the largest magnitude to
        # the format's largest normal number
        scale = jnp.maximum(jnp.max(jnp.abs(v)), 1e-30) / F8_MAX
        return jax.lax.reduce_precision(v / scale, exponent_bits=4,
                                        mantissa_bits=3) * scale
    raise ValueError(kind)


class Fir:
    """y[m] = sum_k h[k] x_up[mD - k], x_up = x zero-stuffed by U, with the
    last ceil((taps-1)/U) inputs of the previous segment as history."""

    def __init__(self, h, up=1, down=1, rounding=None):
        self.h = np.asarray(h, np.float32)
        self.up, self.down = int(up), int(down)
        self.hist = -(-(len(h) - 1) // self.up)
        self.rounding = rounding
        j_max = -(-len(h) // self.up)
        padded = np.zeros(j_max * self.up + self.up, np.float32)
        padded[:len(h)] = self.h
        # table[r, j] = h[r + j U]
        self.table = padded[:j_max * self.up].reshape(j_max, self.up).T.copy()

    def __call__(self, x, hist):
        n = x.shape[-1]
        assert n % self.down == 0
        n_out = n * self.up // self.down
        pos = jnp.arange(n_out, dtype=jnp.int32) * self.down
        base = self.hist + pos // self.up
        idx = base[:, None] - jnp.arange(self.table.shape[1],
                                         dtype=jnp.int32)[None, :]
        xp = _round(jnp.concatenate([hist, x], axis=-1), self.rounding)
        taps = _round(jnp.asarray(self.table), self.rounding)[pos % self.up]
        y = jnp.sum(xp[..., idx] * taps, axis=-1)
        return y, x[..., n - self.hist:]


def carrier_recovery(x, phi_prev, ramp, scale, adj, wmod, window):
    """Feedforward carrier recovery on (S, n) with n a multiple of window.
    ramp: (n,) nominal carrier phase of each sample, modulo wmod."""
    s, n = x.shape
    nc = n // window
    xw = x.reshape(s, nc, window)
    rw = ramp.reshape(nc, window)
    zr = jnp.mean(xw * jnp.cos(rw), axis=-1)
    zi = jnp.mean(-xw * jnp.sin(rw), axis=-1)
    phi_hat = jnp.arctan2(zi, zr)
    prev = jnp.concatenate([phi_prev[:, None], phi_hat[:, :-1]], axis=-1)
    d = phi_hat - prev
    d = d - 2 * np.pi * jnp.round(d / (2 * np.pi))
    phi = phi_prev[:, None] + jnp.cumsum(d, axis=-1)
    rel = jnp.arange(window, dtype=jnp.float32) - (window - 1) / 2.0
    theta = (rw[None] + phi[..., None]
             + (d / window)[..., None] * rel[None, None, :])
    nco = jnp.cos(theta * scale + adj).reshape(s, n)
    return nco, jnp.mod(phi[:, -1], wmod)


def delay(x, hist):
    d = hist.shape[-1]
    return (jnp.concatenate([hist, x[..., :x.shape[-1] - d]], axis=-1),
            x[..., x.shape[-1] - d:])


class ReferenceReceiver:
    """The chain for one configuration file (`config["mode"]` and
    `config["chain"]`), streaming over segments with explicit state."""

    def __init__(self, config, precision="f32"):
        m = config["mode"]
        ch = config["chain"]
        self.stereo, self.rds = bool(ch["stereo"]), bool(ch["rds"])
        self.m = m
        self.window = int(ch["carrier_window"])
        fe_r, post_r = {"f32": (None, None),
                        "control": ("bf16", "fp8")}[precision]
        if_fs = m["rf_fs"] // m["rf_decim"]
        self.if_fs = if_fs
        up, down = m["audio_interp"], m["audio_decim"]
        bp = m["bp_taps"]
        self.front = Fir(lowpass(m["rf_fs"], m["rf_fc"], m["rf_taps"]), 1,
                         m["rf_decim"], fe_r)
        audio = lowpass(if_fs * up, m["audio_fc"], m["base_audio_taps"] * up,
                        up)
        self.audio = Fir(audio, up, down, post_r)
        if self.stereo:
            self.chan = Fir(bandpass(if_fs, *m["stereo_band"], bp), 1, 1,
                            post_r)
            self.pilot = Fir(bandpass(if_fs, *m["pilot_band"], bp), 1, 1,
                             post_r)
        if self.rds:
            frac = Fraction(m["rds_sps"] * m["rds_symbol_rate"], if_fs)
            u, d = frac.numerator, frac.denominator
            self.rds_chan = Fir(bandpass(if_fs, *m["rds_band"], bp), 1, 1,
                                post_r)
            self.rds_carr = Fir(bandpass(if_fs, *m["rds_carrier_band"], bp),
                                1, 1, post_r)
            self.rds_lpf = Fir(lowpass(if_fs * u, m["rds_fc"], bp * u, u), u,
                               d, post_r)
            self.rrc = Fir(root_raised_cosine(
                m["rds_sps"] * m["rds_symbol_rate"], m["rds_rrc_taps"],
                m["rds_symbol_rate"]), 1, 1, post_r)
            self.rds_delay = (bp - 1) // 2
        self._seg = jax.jit(self._segment)

    def init_state(self, stations):
        z = lambda k: jnp.zeros((stations, k), jnp.float32)  # noqa: E731
        st = dict(i=z(self.front.hist), q=z(self.front.hist),
                  prev_i=jnp.zeros(stations), prev_q=jnp.zeros(stations),
                  mono=z(self.audio.hist))
        if self.stereo:
            st.update(chan=z(self.chan.hist), pilot=z(self.pilot.hist),
                      phi_s=jnp.zeros(stations), stereo=z(self.audio.hist),
                      mono_delay=z(self.m["mono_delay"]))
        if self.rds:
            st.update(rds_chan=z(self.rds_chan.hist),
                      rds_carr=z(self.rds_carr.hist),
                      phi_r=jnp.zeros(stations),
                      rds_delay=z(self.rds_delay),
                      rds_lpf=z(self.rds_lpf.hist), rrc=z(self.rrc.hist))
        return st

    def _ramp(self, freq, scale, start, n):
        """Nominal carrier phase of IF samples start..start+n, exactly
        modulo the period at which cos(theta * scale) repeats."""
        k = Fraction(scale).limit_denominator(64).denominator
        i = start + np.arange(n, dtype=np.int64)
        f = int(freq)
        return jnp.asarray(2 * np.pi * ((f * i) % (k * self.if_fs))
                           / self.if_fs, jnp.float32), 2 * np.pi * k

    def _segment(self, st, u8, ramps):
        st = dict(st)
        out = {}
        v = (u8.astype(jnp.float32) - 128.0) / 128.0
        i_ds, st["i"] = self.front(v[:, 0::2], st["i"])
        q_ds, st["q"] = self.front(v[:, 1::2], st["q"])
        ip = jnp.concatenate([st["prev_i"][:, None], i_ds[:, :-1]], axis=-1)
        qp = jnp.concatenate([st["prev_q"][:, None], q_ds[:, :-1]], axis=-1)
        num = i_ds * (q_ds - qp) - q_ds * (i_ds - ip)
        den = i_ds * i_ds + q_ds * q_ds
        fm = jnp.where(den == 0.0, 0.0, num / jnp.where(den == 0.0, 1.0, den))
        st["prev_i"], st["prev_q"] = i_ds[:, -1], q_ds[:, -1]
        mono, st["mono"] = self.audio(fm, st["mono"])
        if not self.stereo:
            out["mono"] = mono
        if self.stereo:
            chan, st["chan"] = self.chan(fm, st["chan"])
            pilot, st["pilot"] = self.pilot(fm, st["pilot"])
            (ramp_s, wmod_s) = ramps["pilot"]
            nco_s, st["phi_s"] = carrier_recovery(pilot, st["phi_s"], ramp_s,
                                                  2.0, 0.0, wmod_s,
                                                  self.window)
            stereo, st["stereo"] = self.audio(2.0 * chan * nco_s,
                                              st["stereo"])
            shifted, st["mono_delay"] = delay(mono, st["mono_delay"])
            out["mono"] = mono
            out["left"] = (shifted + stereo) * 0.5
            out["right"] = (shifted - stereo) * 0.5
        if self.rds:
            rchan, st["rds_chan"] = self.rds_chan(fm, st["rds_chan"])
            carr, st["rds_carr"] = self.rds_carr(rchan * rchan, st["rds_carr"])
            (ramp_r, wmod_r) = ramps["rds"]
            nco_r, st["phi_r"] = carrier_recovery(carr, st["phi_r"], ramp_r,
                                                  0.5, 0.0, wmod_r,
                                                  self.window)
            delayed, st["rds_delay"] = delay(rchan, st["rds_delay"])
            base, st["rds_lpf"] = self.rds_lpf(2.0 * nco_r * delayed,
                                               st["rds_lpf"])
            out["rds_soft"], st["rrc"] = self.rrc(base, st["rrc"])
        return st, out

    def run(self, segments, stations):
        """segments: iterable of (stations, bytes) u8 host arrays, in stream
        order.  Returns {output: (stations, samples) float64 numpy}."""
        st = self.init_state(stations)
        outs: dict[str, list] = {}
        if_pos = 0
        for seg in segments:
            n_if = seg.shape[-1] // 2 // self.m["rf_decim"]
            if n_if % self.window:
                raise ValueError(f"segment of {n_if} IF samples is not a "
                                 f"multiple of the {self.window}-sample "
                                 f"carrier window")
            ramps = {}
            if self.stereo:
                r, w = self._ramp(self.m["pilot_freq"], 2.0, if_pos, n_if)
                ramps["pilot"] = (r, w)
            if self.rds:
                r, w = self._ramp(self.m["rds_carrier_freq"], 0.5, if_pos,
                                  n_if)
                ramps["rds"] = (r, w)
            st, out = self._seg(st, jnp.asarray(seg), ramps)
            for k, v in out.items():
                outs.setdefault(k, []).append(np.asarray(v, np.float64))
            if_pos += n_if
        return {k: np.concatenate(v, axis=-1) for k, v in outs.items()}


def segment_blocks(total_blocks: int, block_seconds: float,
                   max_seconds: float = 1.3) -> int:
    """Blocks per reference segment: the largest divisor of total_blocks
    whose signal fits in max_seconds (at least 1)."""
    cap = max(1, int(math.floor(max_seconds / block_seconds + 1e-9)))
    for b in range(min(cap, total_blocks), 0, -1):
        if total_blocks % b == 0:
            return b
    return 1
