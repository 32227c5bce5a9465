"""Type-2 phase-locked loop + NCO, block-streaming.

Reproduces the reference PLL recurrence (src/filter.cpp:136-174): per sample,
phase detect atan2(-in*fbQ, in*fbI), PI loop filter with Cp=2.666 / Ci=3.555
(Kp = bw*Cp, Ki = bw^2*Ci, src/filter.cpp:139-143), NCO output
cos(trigArg*ncoScale + phaseAdjust).  Streaming state is carried across
blocks (the reference carries six scalars, src/filter.cpp:137; its
ncoOut_state write at src/filter.cpp:150 is dead — overwritten at i=0).

The recurrence is strictly sequential, so it runs as one `lax.scan` per
block; batching across RF channels is done by `vmap`, which turns the
scalar recurrence into element-parallel ops (SURVEY §7 hard-part 1).

Two numerically different but behaviorally equivalent formulations:

 - `wrap_phase=False`: bit-faithful to the reference — carries
   (integrator, phaseEst, trigOffset) with trigArg = 2*pi*(f/Fs)*trigOffset
   + phaseEst.  trigOffset grows unboundedly (reference defect,
   src/filter.cpp:166) — float32 precision collapses on long streams.
 - `wrap_phase=True` (default): carries the *combined* NCO argument
   theta = 2*pi*(f/Fs)*trigOffset + phaseEst directly, which updates
   additively per sample (theta += w0 + Kp*e + integ), wrapped modulo a
   period W chosen so every downstream use (cos/sin of theta and of
   theta*ncoScale) is W-periodic.  This is the documented improvement over
   the reference (SURVEY §7 hard-part 6).
"""

from __future__ import annotations

from fractions import Fraction
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

PLL_CP = 2.666
PLL_CI = 3.555


class PLLState(NamedTuple):
    """Carried PLL state.  In wrap_phase mode `phase_acc` holds the wrapped
    combined NCO argument theta; otherwise it holds the reference's phaseEst
    and `trig_offset` the reference's sample counter."""
    integrator: jax.Array
    phase_acc: jax.Array
    feedback_i: jax.Array
    feedback_q: jax.Array
    trig_offset: jax.Array


def pll_init(batch_shape: tuple[int, ...] = ()) -> PLLState:
    """Initial state matching reference src/project.cpp:106-111
    (integrator=0, phaseEst=0, feedbackI=1, feedbackQ=0, trigOffset=0)."""
    z = jnp.zeros(batch_shape, jnp.float32)
    o = jnp.ones(batch_shape, jnp.float32)
    return PLLState(integrator=z, phase_acc=z, feedback_i=o, feedback_q=z,
                    trig_offset=z)


def _wrap_modulus(nco_scale: float) -> float:
    """Smallest W = 2*pi*k such that W*nco_scale is also a multiple of 2*pi."""
    frac = Fraction(nco_scale).limit_denominator(64)
    return 2.0 * np.pi * frac.denominator


@partial(jax.jit, static_argnames=("freq", "fs", "nco_scale", "phase_adjust",
                                   "norm_bandwidth", "wrap_phase",
                                   "lag_correction", "unroll"))
def pll(x: jax.Array, state: PLLState, *, freq: float, fs: float,
        nco_scale: float = 1.0, phase_adjust: float = 0.0,
        norm_bandwidth: float = 0.01, wrap_phase: bool = True,
        lag_correction: bool = True, unroll: int = 8):
    """Run the PLL over block x (..., N); returns (nco_out, new_state).

    Leading batch dims are vmapped over.

    lag_correction (deviation from reference, on by default): the reference
    emits ncoOut[i] = cos(trigArg_i * scale) (src/filter.cpp:170) but its
    loop aligns trigArg_{i-1} with pllin[i] (the error at i uses the
    feedback of i-1, src/filter.cpp:159-160) — so the reference NCO *leads*
    the input by one sample (57 deg at 38 kHz / 240 kS/s), costing
    ~cos(57deg) of coherent stereo gain and capping L/R separation near
    9 dB.  The corrected output uses trigArg_i - w0, the loop's phase
    estimate *for sample i*.  Set False for bit-parity with the oracle.
    """
    kp = jnp.float32(norm_bandwidth * PLL_CP)
    ki = jnp.float32(norm_bandwidth * norm_bandwidth * PLL_CI)
    w0 = jnp.float32(2.0 * np.pi * (freq / fs))
    wmod = jnp.float32(_wrap_modulus(nco_scale))
    scale = jnp.float32(nco_scale)
    adj = jnp.float32(phase_adjust)

    def step(carry, xi):
        integ, acc, fbi, fbq, trig = carry
        error_d = jnp.arctan2(xi * (-fbq), xi * fbi)
        integ = integ + ki * error_d
        if wrap_phase:
            acc = jnp.mod(acc + w0 + kp * error_d + integ, wmod)
            trig_arg = acc
        else:
            acc = acc + kp * error_d + integ
            trig = trig + 1.0
            trig_arg = w0 * trig + acc
        fbi = jnp.cos(trig_arg)
        fbq = jnp.sin(trig_arg)
        out_arg = trig_arg - w0 if lag_correction else trig_arg
        nco = jnp.cos(out_arg * scale + adj)
        return (integ, acc, fbi, fbq, trig), nco

    def scan_1d(x1, st):
        carry = (st.integrator, st.phase_acc, st.feedback_i, st.feedback_q,
                 st.trig_offset)
        carry, nco_out = jax.lax.scan(step, carry, x1, unroll=unroll)
        return nco_out, PLLState(*carry)

    fn = scan_1d
    for _ in range(x.ndim - 1):
        fn = jax.vmap(fn)
    return fn(x, state)


def _largest_divisor_at_most(n: int, cap: int) -> int:
    for d in range(min(cap, n), 0, -1):
        if n % d == 0:
            return d
    return n


@partial(jax.jit, static_argnames=("freq", "fs", "nco_scale", "phase_adjust",
                                   "norm_bandwidth", "window", "out_dtype"))
def pll_feedforward(x: jax.Array, state: PLLState, *, freq: float, fs: float,
                    nco_scale: float = 1.0, phase_adjust: float = 0.0,
                    norm_bandwidth: float = 0.01, window: int = 256,
                    out_dtype=jnp.float32):
    """Feedforward carrier recovery — the fast production engine.

    The reference loop (src/filter.cpp:136-174) spends 240k strictly
    sequential atan2+sincos iterations per second tracking a tone whose
    phase moves at kHz rates; that feedback recurrence is a long serial
    chain on any parallel device, and its per-sample feedback cannot be
    chunked past ~32 samples without destabilizing acquisition (the
    frozen-feedback stability product chunk*bw*Cp).  This engine removes
    the feedback entirely — classic feedforward (block ML / Viterbi-style)
    carrier estimation, restructured as whole-block array ops:

      1. MIX: rotate the real input by the nominal carrier ramp e^{-j w0 i}
         to complex baseband.  The ramp's cos/sin are trace-time f64-exact
         host tables (block length is static under jit) — no runtime trig,
         no f32 phase-accumulator drift; the block's carried start phase r0
         enters as one complex rotation.
      2. ESTIMATE: coherent average over `window` samples (the ML phase
         estimator for a tone in white noise) and one atan2 per window —
         phase at each window center, *already locked* (no pull-in
         transient at all).
      3. UNWRAP: wrapped first differences + cumsum stitch the per-window
         phases into a continuous track — an associative scan, not a
         recurrence.
      4. SYNTHESIZE: piecewise-linear phase (backward slope per window),
         one cos per output sample: nco[i] = cos((ramp+r0+phi(i))*scale
         + phase_adjust).

    Nothing here is sequential — the whole engine is reshape/mean/atan2/
    cumsum/cos on full blocks.  Equivalent-noise-bandwidth fs/(2*window)
    (469 Hz at 240 kS/s, window 256) is *narrower* than the reference
    loop's bw*fs = 2.4 kHz, so phase noise on a locked tone is strictly
    better; trackable frequency offset is fs/(2*window) (the FM pilot's
    offset is Hz-scale: receiver LO error becomes a DC shift after FM
    demod, not a pilot shift).  Behavioral drop-in for pll() on tones (the
    gates: lock, phase error, stereo separation, RDS yield —
    tests/test_ops.py, test_receiver.py); use `pll` for bit-level parity.
    `norm_bandwidth` is accepted for signature compatibility and sets
    nothing — the estimator has no loop filter.

    State mapping: phase_acc = continuous phase track (mod wrap modulus),
    integrator = last per-sample slope, trig_offset = carrier ramp phase.
    """
    n = x.shape[-1]
    window = _largest_divisor_at_most(n, window)
    tabs = _ff_tables(n, window, freq, fs, nco_scale, phase_adjust)

    fn = partial(_ff_run_1d, n=n, window=window, out_dtype=out_dtype)
    for _ in range(x.ndim - 1):
        fn = jax.vmap(fn, in_axes=(0, 0, None))
    return fn(x, state, tabs)


def _ff_tables(n: int, window: int, freq: float, fs: float,
               nco_scale: float, phase_adjust: float):
    """Trace-time f64-exact carrier ramp tables (n static under jit).

    Shaped (nc, window) so every synthesis step stays 2-D: the round-3
    flat-(n,) formulation forced a reshape between the per-window
    broadcasts and the final cosine, which broke XLA's fusion and
    materialized two full-block (nc, window)-broadcast temporaries plus
    layout copies (measured ~25% of the stereo step in the round-4
    profile)."""
    wmod_f = _wrap_modulus(nco_scale)
    w0_f64 = 2.0 * np.pi * (float(freq) / float(fs))
    ramp = ((w0_f64 * np.arange(n, dtype=np.float64)) % wmod_f
            ).reshape(n // window, window)
    return dict(
        cos_ramp=jnp.asarray(np.cos(ramp), jnp.float32),
        sin_ramp=jnp.asarray(np.sin(ramp), jnp.float32),
        ramp_mod=jnp.asarray(ramp, jnp.float32),
        r_adv=jnp.float32((w0_f64 * n) % wmod_f),
        wmod=jnp.float32(wmod_f),
        scale=jnp.float32(nco_scale),
        adj=jnp.float32(phase_adjust))


def _ff_estimate_1d(zr, zi, st, wmod, r_adv, window: int):
    """ESTIMATE + UNWRAP from per-window coherent sums: returns the
    per-window synthesis parameters (off = r0 + phi_c, slope) and the new
    PLLState — WITHOUT synthesizing the NCO (_ff_finish_1d does)."""
    two_pi = jnp.float32(2.0 * np.pi)
    r0 = st.trig_offset
    cr0, sr0 = jnp.cos(r0), jnp.sin(r0)
    # z' = e^{-j r0} (zr + j zi)
    zr_r = zr * cr0 + zi * sr0
    zi_r = zi * cr0 - zr * sr0
    phi_hat = jnp.arctan2(zi_r, zr_r)                    # (nc,)
    prev = jnp.concatenate([st.phase_acc[None], phi_hat[:-1]])
    d = phi_hat - prev
    d = d - two_pi * jnp.round(d / two_pi)               # (-pi, pi]
    phi_c = st.phase_acc + jnp.cumsum(d)                 # continuous
    slope = d / jnp.float32(window)
    phi_last = jnp.mod(phi_c[-1], wmod)
    new = PLLState(integrator=slope[-1], phase_acc=phi_last,
                   feedback_i=jnp.cos(phi_last),
                   feedback_q=jnp.sin(phi_last),
                   trig_offset=jnp.mod(r0 + r_adv, wmod))
    return r0 + phi_c, slope, new


def _ff_finish_1d(zr, zi, st, tabs, *, n: int, window: int,
                 out_dtype=jnp.float32):
    """ESTIMATE + UNWRAP + SYNTHESIZE from per-window coherent sums.

    zr/zi are Z_c = sum_{i in window c} x_i e^{-j ramp_i} (any positive
    scale — atan2 is scale-invariant, so sums and means are equivalent),
    WITHOUT the block's carried start rotation r0: it is applied here as
    one complex rotation per window.  Shared tail of _ff_run_1d.
    """
    rel = jnp.arange(window, dtype=jnp.float32) - (window - 1) / 2.0
    off, slope, new = _ff_estimate_1d(zr, zi, st, tabs["wmod"],
                                      tabs["r_adv"], window)
    theta = (tabs["ramp_mod"] + off[:, None]
             + slope[:, None] * rel[None, :])            # (nc, window)
    nco = jnp.cos(theta * tabs["scale"] + tabs["adj"]
                  ).astype(out_dtype).reshape(n)
    return nco, new


def _ff_run_1d(x1, st, tabs, *, n: int, window: int,
               out_dtype=jnp.float32):
    """Feedforward engine body on one 1-D block (see pll_feedforward).

    Every full-rate tensor stays (nc, window): the broadcasts of the
    per-window phase/slope fold into the final cosine fusion, and only the
    finished nco is reshaped back to (n,) (free, row-major)."""
    nc = n // window
    x2 = x1.reshape(nc, window).astype(jnp.float32)
    # MIX against the raw ramp only — the carried start rotation r0 is one
    # complex rotation of the per-window sums, applied in _ff_finish_1d
    # (linearity of the sum); the ramp tables are channel-shared
    zr = (x2 * tabs["cos_ramp"]).mean(axis=-1)
    zi = (-x2 * tabs["sin_ramp"]).mean(axis=-1)
    return _ff_finish_1d(zr, zi, st, tabs, n=n, window=window,
                         out_dtype=out_dtype)


def pll_feedforward_multi(xs, states, *, params, window: int = 256,
                          out_dtype=jnp.float32):
    """N feedforward carrier engines in ONE fused program.

    The stereo pilot (19 kHz, scale 2) and RDS carrier (114 kHz, scale
    0.5) recoveries are independent engines over same-shape inputs; ridden
    separately each pays its own launch/fusion boundary.  Stacking the
    inputs on a leading engine axis (with per-engine ramp tables stacked
    alongside) runs both as one vmapped program — numerically equivalent
    to two `pll_feedforward` calls within float32 fusion tolerance (the
    vmap rows are independent, but stacking changes XLA's fusion and hence
    rounding; the regression gate holds outputs to ~2e-6).

    Args: xs/states/params are same-length sequences; params entries are
    (freq, fs, nco_scale, phase_adjust).  Returns (ncos, new_states) as
    tuples in the input order.
    """
    assert len(xs) == len(states) == len(params)
    n = xs[0].shape[-1]
    assert all(x.shape == xs[0].shape for x in xs), "engine inputs must match"
    window = _largest_divisor_at_most(n, window)
    x = jnp.stack(list(xs))                              # (E, ..., n)
    st = jax.tree.map(lambda *a: jnp.stack(a), *states)  # (E, ...)
    tabs = jax.tree.map(
        lambda *a: jnp.stack(a),
        *[_ff_tables(n, window, f, fs, sc, adj)
          for f, fs, sc, adj in params])

    fn = partial(_ff_run_1d, n=n, window=window, out_dtype=out_dtype)
    for _ in range(x.ndim - 2):
        fn = jax.vmap(fn, in_axes=(0, 0, None))          # channel dims
    fn = jax.vmap(fn)                                    # engine axis
    ncos, new = fn(x, st, tabs)
    e = len(xs)
    return (tuple(ncos[i] for i in range(e)),
            tuple(jax.tree.map(lambda a, i=i: a[i], new) for i in range(e)))


def pll_reference(x, freq, fs, nco_scale, phase_adjust, norm_bandwidth, state):
    """Scalar NumPy oracle with the reference's exact loop (src/filter.cpp:136-174).

    state: (integrator, phaseEst, feedbackI, feedbackQ, trigOffset)
    Returns (ncoOut, new_state). float32 arithmetic like the C++.
    """
    f32 = np.float32
    kp = f32(norm_bandwidth) * f32(PLL_CP)
    ki = f32(norm_bandwidth) * f32(norm_bandwidth) * f32(PLL_CI)
    integ, phase, fbi, fbq, trig = (f32(v) for v in state)
    out = np.zeros(len(x), dtype=np.float32)
    for i in range(len(x)):
        error_i = f32(x[i]) * fbi
        error_q = f32(x[i]) * (-fbq)
        error_d = f32(np.arctan2(error_q, error_i))
        integ = f32(integ + ki * error_d)
        phase = f32(phase + kp * error_d + integ)
        trig = f32(trig + 1)
        trig_arg = f32(f32(2 * np.pi * (freq / fs)) * trig + phase)
        fbi = f32(np.cos(trig_arg))
        fbq = f32(np.sin(trig_arg))
        out[i] = f32(np.cos(trig_arg * f32(nco_scale) + f32(phase_adjust)))
    return out, (integ, phase, fbi, fbq, trig)


@partial(jax.jit, static_argnames=("freq", "fs", "nco_scale", "phase_adjust",
                                   "norm_bandwidth", "lag_correction",
                                   "chunk"))
def pll_chunked(x: jax.Array, state: PLLState, *, freq: float, fs: float,
                nco_scale: float = 1.0, phase_adjust: float = 0.0,
                norm_bandwidth: float = 0.01, lag_correction: bool = True,
                chunk: int = 16):
    """Chunk-vectorized PLL: a parallel redesign of the sequential loop.

    The reference loop updates phase every sample at Fs (240 kS/s) although
    the loop bandwidth is only bw*Fs (2.4 kHz at bw=0.01) — the feedback
    phase moves negligibly across a few samples.  This engine freezes the
    *predicted* NCO phase over a K-sample chunk (open-loop extrapolation at
    the current frequency estimate), computes all K phase-detector errors in
    one vector op, then applies the K sequential PI updates *exactly* (they
    are linear in the errors: prefix sums give every intermediate integrator
    and phase value).  The only approximation is the frozen feedback inside
    a chunk — an O((K*bw)^2) phase error, inaudible for K*bw << 1.

    K=16 cuts scan length 16x; each step does (..., K) vector math.
    Validated behaviorally (lock, stereo separation, RDS decode) in
    the test suite; use `pll` for bit-level work.
    """
    kp = jnp.float32(norm_bandwidth * PLL_CP)
    ki = jnp.float32(norm_bandwidth * norm_bandwidth * PLL_CI)
    w0 = jnp.float32(2.0 * np.pi * (freq / fs))
    wmod = jnp.float32(_wrap_modulus(nco_scale))
    scale = jnp.float32(nco_scale)
    adj = jnp.float32(phase_adjust)
    n = x.shape[-1]
    assert n % chunk == 0, f"block length {n} % chunk {chunk} != 0"
    j = jnp.arange(1, chunk + 1, dtype=jnp.float32)

    def chunk_step(carry, xc):
        integ0, acc0 = carry
        # open-loop phase prediction for the whole chunk at the current
        # frequency estimate (w0 + integrator); e_i is measured against the
        # *previous* sample's phase acc_{i-1} (reference src/filter.cpp:159)
        pred = acc0 + (j - 1.0) * (w0 + integ0)
        e = jnp.arctan2(xc * (-jnp.sin(pred)), xc * jnp.cos(pred))
        ce = jnp.cumsum(e)
        # exact K-step PI recurrences given the errors:
        # integ_i = integ0 + ki*ce_i
        # acc_i   = acc0 + i*w0 + kp*ce_i + sum_{m<=i} integ_m
        integ_i = integ0 + ki * ce
        acc_i = acc0 + j * w0 + kp * ce + jnp.cumsum(integ_i)
        out_arg = acc_i - w0 if lag_correction else acc_i
        nco = jnp.cos(out_arg * scale + adj)
        return (integ_i[-1], jnp.mod(acc_i[-1], wmod)), nco

    def scan_1d(x1, st):
        xc = x1.reshape(n // chunk, chunk)
        carry = (st.integrator, st.phase_acc)
        (integ, acc), nco = jax.lax.scan(chunk_step, carry, xc)
        new = PLLState(integrator=integ, phase_acc=acc,
                       feedback_i=jnp.cos(acc), feedback_q=jnp.sin(acc),
                       trig_offset=st.trig_offset)
        return nco.reshape(n), new

    fn = scan_1d
    for _ in range(x.ndim - 1):
        fn = jax.vmap(fn)
    return fn(x, state)
