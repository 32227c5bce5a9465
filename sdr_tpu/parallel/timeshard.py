"""Time-axis sequence parallelism for the mono chain: halo-exchange
overlap-save over a device mesh.

SURVEY §5.7: the reference scales the unbounded sample stream by block
streaming with carried tails — the ancestor of overlap-save.  The mono chain
(channelize -> discriminator -> audio resample) has *no unbounded
recurrence*: every audio sample depends on a bounded window of past raw
samples (FIR tails + the discriminator's one-sample lookback).  So the time
axis shards exactly: device d processes its contiguous chunk plus a left
halo received from device d-1 via `ppermute`, runs the chain statelessly,
and drops the warm-up outputs.  Bit-identical to the sequential scan
(verified in tests/test_parallel.py) with one neighbor exchange per step —
the ICI-riding pattern the SNIPPETS right-permute kernel demonstrates.

The stereo chain carries a true sequential recurrence (the pilot PLL), but
the recurrence is *self-forgetting*: a type-2 PLL locked to the pilot tone
converges to a state determined by the input signal, not by its initial
conditions (lock-in for bw=0.01 at 240 kHz IF is ~1-2 ms ~= 300-500 IF
samples).  `timesharded_stereo` therefore extends each device's left halo
by a PLL warm-up region: every device runs the full stereo chain from a
cold state over (warm-up + chunk), locks during the warm-up, and drops the
warm-up outputs.  No inter-device PLL state handoff — devices run fully in
parallel — at the cost of `warmup_if` redundant IF samples per device.
Equivalence to the serial scan is behavioral (stereo separation / stream
SNR within tolerance, tests/test_parallel.py), not bit-exact: the dropped
transient differs.  `timesharded_full` extends the same construction to
the COMPLETE stereo+RDS chain: the RDS carrier loop warms up in the halo
(instantly under the feedforward engine; ~4x the stereo warm-up for the
feedback engines, bw=0.003), the per-device soft streams are sign-aligned
on host across the halo overlap (squaring-loop 180-degree ambiguity is
per-device), and the concatenated soft stream feeds the host frame sync
unchanged.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from sdr_tpu.config import ModeConfig
from sdr_tpu.models.receiver import Receiver


def halo_if(cfg: ModeConfig) -> int:
    """Left-context depth of the mono chain in IF samples.

    audio FIR needs ceil((audio_taps-1)/U) IF samples back, +1 for the
    discriminator's previous sample, + ceil((rf_taps-1)/rf_decim) IF slots
    whose raw windows reach past the halo start; rounded up to a multiple of
    audio_decim (polyphase output-grid phase alignment).
    """
    ctx = (-(-(cfg.audio_taps - 1) // cfg.audio_interp) + 1
           + -(-(cfg.rf_taps - 1) // cfg.rf_decim))
    return -(-ctx // cfg.audio_decim) * cfg.audio_decim


def halo_pairs(cfg: ModeConfig) -> int:
    """Left-context depth in raw IQ pairs."""
    return halo_if(cfg) * cfg.rf_decim


def _pad_for_mesh(iq_u8, n_dev: int, align: int):
    """Make any capture length shardable: trim to the serial-equivalent
    alignment (rx.run drops the trailing partial block the same way), then
    right-pad with u8 value 128 (decodes to 0.0) so every device receives
    an equal aligned chunk.  Returns (padded host array, n_valid); callers
    trim outputs back to the serial length — mirrors sharded_run's ragged
    channel padding on the time axis."""
    arr = np.asarray(iq_u8)
    n = arr.shape[-1]
    n_valid = (n // align) * align
    if n_valid == 0:
        raise ValueError(f"capture of {n} bytes shorter than the minimum "
                         f"aligned block {align}")
    unit = n_dev * align
    n_pad = -(-n_valid // unit) * unit
    if n_pad == n_valid == n:
        return arr, n_valid
    out = np.full(arr.shape[:-1] + (n_pad,), 128, dtype=np.uint8)
    out[..., :n_valid] = arr[..., :n_valid]
    return out, n_valid


def timesharded_mono(rx: Receiver, iq_u8, mesh: Mesh, *, axis: str = "time"):
    """Mono-decode a single station's u8 stream with time sharded over mesh.

    iq_u8: (n,) u8, any length — trimmed/padded internally (see
    _pad_for_mesh).  Returns the audio stream, identical to
    rx.run(iq_u8)['mono'].
    """
    cfg = rx.cfg
    n_dev = mesh.shape[axis]
    align = 2 * cfg.rf_decim * cfg.audio_decim
    iq_np, n_valid = _pad_for_mesh(iq_u8, n_dev, align)
    chunk_u8 = iq_np.shape[-1] // n_dev
    halo_u8 = 2 * halo_pairs(cfg)
    assert chunk_u8 >= halo_u8, (
        f"per-device chunk {chunk_u8} u8 shorter than the halo {halo_u8}")
    warm_audio = halo_if(cfg) * cfg.audio_interp // cfg.audio_decim

    iq = jax.device_put(iq_np, NamedSharding(mesh, P(axis)))

    @partial(shard_map, mesh=mesh, in_specs=P(axis), out_specs=P(axis),
             check_vma=False)
    def run_shard(local):
        local = local.reshape(-1)  # (chunk_u8,)
        tail = local[-halo_u8:]
        # right-shift: device d's tail becomes device d+1's left halo.
        halo = jax.lax.ppermute(tail, axis,
                                perm=[(i, i + 1) for i in range(n_dev - 1)])
        # device 0 receives no halo; u8 value 128 decodes to 0.0, matching
        # the sequential run's zero-filled initial filter tails (ppermute's
        # zero fill would decode to -1.0).
        idx = jax.lax.axis_index(axis)
        halo = jnp.where(idx == 0, jnp.uint8(128), halo)
        extended = jnp.concatenate([halo, local])
        state = rx.init_state()
        _, out = rx.step(state, extended)
        audio = out["mono"][warm_audio:]
        return audio

    audio = jax.jit(run_shard)(iq)
    n_audio = (n_valid // (2 * cfg.rf_decim * cfg.audio_decim)
               * cfg.audio_interp)
    return audio[:n_audio]


def stereo_warmup_if(rx: Receiver, warmup_if: int = 4096) -> int:
    """Left-halo depth (IF samples) for the time-sharded stereo chain:
    FIR/discriminator context + BPF group delay + mono delay line + PLL
    lock-in, rounded so (a) the polyphase output grid stays aligned and
    (b) the pilot NCO's free-run phase over the
    zero-filled device-0 halo is a whole number of cycles (keeps device 0
    near-identical to the serial cold start)."""
    cfg = rx.cfg
    ctx = (halo_if(cfg) + cfg.bp_taps
           + cfg.mono_delay * cfg.audio_decim // cfg.audio_interp + warmup_if)
    unit = int(np.lcm(cfg.audio_decim,
                      int(cfg.if_fs) // int(np.gcd(int(cfg.pilot_freq),
                                                   int(cfg.if_fs)))))
    return -(-ctx // unit) * unit


def timesharded_stereo(rx: Receiver, iq_u8, mesh: Mesh, *,
                       axis: str = "time", warmup_if: int = 4096):
    """Stereo-decode a single station's u8 stream with time sharded over
    the mesh — extends timesharded_mono past its PLL limit via warm-up
    halos (see module docstring).

    iq_u8: (n,) u8, any length — trimmed/padded internally (see
    _pad_for_mesh).  Returns (left, right), behaviorally equivalent to
    rx.run(iq_u8)['left'/'right'] (stereo separation / SNR within
    tolerance after the initial serial lock-in transient).
    """
    cfg = rx.cfg
    assert rx.stereo and not rx.rds, (
        "stereo time-sharding; for stereo+RDS use timesharded_full")
    n_dev = mesh.shape[axis]
    align = 2 * cfg.rf_decim * cfg.audio_decim
    iq_np, n_valid = _pad_for_mesh(iq_u8, n_dev, align)
    chunk_u8 = iq_np.shape[-1] // n_dev
    warm_if = stereo_warmup_if(rx, warmup_if)
    halo_u8 = 2 * cfg.rf_decim * warm_if
    assert chunk_u8 >= halo_u8, (
        f"chunk {chunk_u8} u8 shorter than the warm-up halo {halo_u8}")
    warm_audio = warm_if * cfg.audio_interp // cfg.audio_decim

    iq = jax.device_put(iq_np, NamedSharding(mesh, P(axis)))

    @partial(shard_map, mesh=mesh, in_specs=P(axis),
             out_specs=(P(axis), P(axis)), check_vma=False)
    def run_shard(local):
        local = local.reshape(-1)
        tail = local[-halo_u8:]
        halo = jax.lax.ppermute(tail, axis,
                                perm=[(i, i + 1) for i in range(n_dev - 1)])
        idx = jax.lax.axis_index(axis)
        halo = jnp.where(idx == 0, jnp.uint8(128), halo)
        extended = jnp.concatenate([halo, local])
        state = rx.init_state()
        _, out = rx.step(state, extended)
        return out["left"][warm_audio:], out["right"][warm_audio:]

    left, right = jax.jit(run_shard)(iq)
    n_audio = (n_valid // (2 * cfg.rf_decim * cfg.audio_decim)
               * cfg.audio_interp)
    return left[:n_audio], right[:n_audio]


def full_warmup_if(rx: Receiver, warmup_if: int | None = None) -> int:
    """Left-halo depth (IF samples) for the full stereo+RDS chain.

    With the feedforward carrier engine (pll_impl='ff') there is no loop
    lock-in at all — the halo only covers FIR/RRC/resampler context plus
    one coherent-integration window; feedback engines need the RDS carrier
    loop's pull-in (bw=0.003 -> ~4x the stereo warm-up, the sizing the
    round-2 module docstring gave).  Rounded to the lcm of every grid the
    chain carries (audio polyphase, RDS resampler/symbol grid, ff window).
    """
    cfg = rx.cfg
    if warmup_if is None:
        warmup_if = 2048 if rx.pll_impl == "ff" else 16384
    # FIR context: RF + IF BPF pair + squaring BPF + 3 kHz LPF + RRC
    # (expressed at the IF rate), plus the channel-vs-carrier delay line
    u, d = cfg.rds_resample
    ctx = (halo_if(cfg) + 3 * cfg.bp_taps
           + (cfg.bp_taps * u) // u + (151 * d) // u
           + (cfg.bp_taps - 1) // 2 + warmup_if)
    unit = np.lcm.reduce([cfg.audio_decim, rx.rds_if_align,
                          rx.pll_window if rx.pll_impl == "ff" else 1])
    return int(-(-ctx // int(unit)) * int(unit))


def timesharded_full(rx: Receiver, iq_u8, mesh: Mesh, *,
                     axis: str = "time", warmup_if: int | None = None):
    """Time-shard the COMPLETE receiver — stereo + RDS — over the mesh.

    The reference's full single-station capability (src/project.cpp:200-271
    + spec pp.13-18) under §5.7's sequence-scaling story: every device runs
    the whole chain over (warm-up halo + chunk) from a cold state and drops
    the warm-up outputs, exactly like timesharded_stereo; the RDS soft
    streams concatenate into the host-side frame sync unchanged.

    One subtlety is RDS-specific: the 57 kHz carrier comes from squaring
    (nco_scale=0.5), so each device's recovered carrier has an independent
    180-degree ambiguity — a per-device sign flip of the soft waveform.
    Devices therefore also return their warm-up soft output, which overlaps
    the left neighbor's chunk in time; the host correlates the overlap and
    sign-corrects each segment before concatenation (the downstream decoder
    then resolves the single remaining global polarity as usual).

    Returns (left, right, rds_soft) — audio behaviorally equivalent to the
    serial run; rds_soft decodes to the same groups (tests/test_parallel.py).
    """
    cfg = rx.cfg
    assert rx.stereo and rx.rds, "timesharded_full wants stereo+RDS"
    n_dev = mesh.shape[axis]
    warm_if = full_warmup_if(rx, warmup_if)
    align_if = int(np.lcm.reduce(
        [cfg.audio_decim, rx.rds_if_align,
         rx.pll_window if rx.pll_impl == "ff" else 1]))
    align = 2 * cfg.rf_decim * align_if
    iq_np, n_valid = _pad_for_mesh(iq_u8, n_dev, align)
    chunk_u8 = iq_np.shape[-1] // n_dev
    halo_u8 = 2 * cfg.rf_decim * warm_if
    assert chunk_u8 >= halo_u8, (
        f"chunk {chunk_u8} u8 shorter than the warm-up halo {halo_u8}")
    warm_audio = warm_if * cfg.audio_interp // cfg.audio_decim
    u, d = cfg.rds_resample
    warm_soft = warm_if * u // d

    iq = jax.device_put(iq_np, NamedSharding(mesh, P(axis)))

    @partial(shard_map, mesh=mesh, in_specs=P(axis),
             out_specs=(P(axis), P(axis), P(axis)), check_vma=False)
    def run_shard(local):
        local = local.reshape(-1)
        tail = local[-halo_u8:]
        halo = jax.lax.ppermute(tail, axis,
                                perm=[(i, i + 1) for i in range(n_dev - 1)])
        idx = jax.lax.axis_index(axis)
        halo = jnp.where(idx == 0, jnp.uint8(128), halo)
        extended = jnp.concatenate([halo, local])
        state = rx.init_state()
        _, out = rx.step(state, extended)
        # keep the warm-up soft too: the host uses the overlap for the
        # per-device 57 kHz sign resolution
        return (out["left"][warm_audio:], out["right"][warm_audio:],
                out["rds_soft"])

    left, right, soft_all = jax.jit(run_shard)(iq)
    n_audio = (n_valid // (2 * cfg.rf_decim * cfg.audio_decim)
               * cfg.audio_interp)
    left, right = left[:n_audio], right[:n_audio]

    # --- host-side polarity stitch (1187.5 bit/s — negligible)
    chunk_soft = (chunk_u8 // (2 * cfg.rf_decim)) * u // d
    soft_all = np.asarray(soft_all).reshape(n_dev, warm_soft + chunk_soft)
    rds_soft = polarity_stitch(soft_all, warm_soft)
    n_soft = (n_valid // (2 * cfg.rf_decim)) * u // d
    return left, right, rds_soft[:n_soft]


def polarity_stitch(soft_all: np.ndarray, warm_soft: int, *,
                    confidence: float = 0.5) -> np.ndarray:
    """Sign-align per-device RDS soft segments across their warm-up overlap.

    soft_all: (n_dev, warm_soft + chunk_soft) — each device's warm-up soft
    output followed by its chunk.  Device d's warm-up overlaps device d-1's
    chunk tail in absolute time; the normalized correlation over the LATER
    half of the warm-up (filters warmed) decides the relative 180-degree
    squaring ambiguity (spec pp.13-14: the 57 kHz carrier from squaring is
    sign-ambiguous per independent acquisition).

    A seam whose overlap carries no RDS energy (squelched station, deep
    fade) yields |corr| ~ 0 — an arbitrary sign decision.  Below
    `confidence` (normalized, in [0,1]) the seam keeps the running sign and
    warns instead of trusting the noise: a possibly-wrong seam sign is
    absorbed by the downstream DIFFERENTIAL decode (spec p.16 — a sign flip
    at a seam corrupts only the one bit spanning it, while a confidently
    wrong flip used to silently invert the whole remaining stream).

    Note the correction applied to device d is sgn(corr) itself, NOT
    sign * sgn(corr): `theirs` is already sign-corrected, so the
    correlation directly measures device d's polarity against the stitched
    stream.  (The round-3 stitch multiplied by the running sign, which
    carried every polarity change one device too far; it went unnoticed
    because clean captures acquire uniform polarity —
    tests/test_parallel.py::test_polarity_stitch_confident_flip_no_warning
    exercises the alternating case.)
    """
    import warnings
    n_dev = soft_all.shape[0]
    chunk_soft = soft_all.shape[1] - warm_soft
    segs = [soft_all[0, warm_soft:]]
    sign = 1.0
    for dev in range(1, n_dev):
        ov = max(warm_soft // 2, 1)
        mine = soft_all[dev, warm_soft - ov:warm_soft]
        theirs = sign * soft_all[dev - 1, warm_soft + chunk_soft - ov:]
        denom = float(np.linalg.norm(mine) * np.linalg.norm(theirs))
        ncorr = float(np.dot(mine, theirs)) / denom if denom > 0 else 0.0
        if abs(ncorr) < confidence:
            warnings.warn(
                f"polarity_stitch: seam {dev - 1}->{dev} overlap correlation "
                f"|{ncorr:.3f}| below confidence {confidence} (no RDS energy "
                f"in overlap?) — keeping running sign; differential decode "
                f"absorbs a wrong seam as one bit error", stacklevel=2)
        else:
            sign = 1.0 if ncorr >= 0 else -1.0
        segs.append(sign * soft_all[dev, warm_soft:])
    return np.concatenate(segs)
