"""Polyphase resampler exactness vs the reference scalar oracle and scipy.

The resampler is the single convolution engine of the receiver (reference
src/filter.cpp:67-103); SURVEY §7 hard-part 2 flags its phase walk as the
top silent-SNR-killer, so it is tested for *exact* index semantics across
every mode's (U, D) pair, including state carry across blocks.
"""

import numpy as np
import pytest
import scipy.signal as sps

from sdr_tpu.config import MODES
from sdr_tpu.ops import firdes
from sdr_tpu.ops.resample import PolyphaseResampler, resample_reference

CASES = [
    # (taps, U, D, blocks of length N)
    (51, 1, 1, 256),     # plain FIR (BPF stages)
    (51, 1, 10, 400),    # RF decimation mode 0/2
    (51, 1, 4, 400),     # RF decimation mode 1
    (51, 1, 9, 405),     # RF decimation mode 3
    (51, 1, 5, 400),     # audio decimation mode 0
    (51 * 147, 147, 800, 1600),   # mode 2 audio rational resampler
    (51 * 19, 19, 120, 1920),     # mode 0 RDS resampler
    (51 * 7, 7, 3, 120),          # upsample-dominant case
]


@pytest.mark.parametrize("taps,up,down,n", CASES)
def test_matches_reference_oracle(taps, up, down, n, rng):
    coeff = rng.standard_normal(taps).astype(np.float32)
    rs = PolyphaseResampler(coeff, up, down)
    tail = rs.init_state()
    # reference carries taps-1 samples; ours the reachable suffix
    ref_state = np.zeros(taps - 1, np.float32)
    for _ in range(3):  # multiple blocks exercise the state carry
        x = rng.standard_normal(n).astype(np.float32)
        y, tail = rs(x, tail)
        y_ref, ref_state = resample_reference(x, ref_state, coeff, up, down)
        np.testing.assert_allclose(np.asarray(y), y_ref, rtol=2e-4, atol=2e-4)
        np.testing.assert_array_equal(np.asarray(tail),
                                      ref_state[len(ref_state) - rs.state_len:]
                                      .astype(np.float32))


def test_matches_scipy_lfilter_decimation(rng):
    """U=1 path == scipy lfilter + [::D] downsample, the golden-model
    formulation (model/fmMonoBlock.py:224-233)."""
    coeff = firdes.lowpass(2.4e6, 100e3, 51, 1)
    rs = PolyphaseResampler(coeff, 1, 10)
    tail = rs.init_state()
    zi = np.zeros(50)
    for _ in range(4):
        x = rng.standard_normal(1000).astype(np.float32)
        y, tail = rs(x, tail)
        y_ref, zi = sps.lfilter(coeff.astype(np.float64), 1.0, x, zi=zi)
        np.testing.assert_allclose(np.asarray(y), y_ref[::10], rtol=1e-4,
                                   atol=1e-5)


def test_block_split_invariance(rng):
    """Processing one big block == two half blocks (state-carry fidelity,
    SURVEY §7 hard-part 3)."""
    coeff = firdes.lowpass(240e3 * 147, 16e3, 51 * 147, 147)
    rs = PolyphaseResampler(coeff, 147, 800)
    x = rng.standard_normal(3200).astype(np.float32)
    y_full, _ = rs(x, rs.init_state())
    y1, t = rs(x[:1600], rs.init_state())
    y2, _ = rs(x[1600:], t)
    np.testing.assert_allclose(np.asarray(y_full),
                               np.concatenate([np.asarray(y1), np.asarray(y2)]),
                               rtol=1e-5, atol=1e-6)


def test_batched_channels(rng):
    """Leading batch dims give identical per-channel results."""
    coeff = firdes.lowpass(2.4e6, 100e3, 51, 1)
    rs = PolyphaseResampler(coeff, 1, 10)
    x = rng.standard_normal((4, 1000)).astype(np.float32)
    yb, tb = rs(x, rs.init_state((4,)))
    for c in range(4):
        y1, t1 = rs(x[c], rs.init_state())
        np.testing.assert_allclose(np.asarray(yb[c]), np.asarray(y1),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(np.asarray(tb[c]), np.asarray(t1))


@pytest.mark.parametrize("mode", sorted(MODES))
def test_mode_resampler_geometry(mode):
    """Every mode's audio resampler produces the exact audio rate."""
    cfg = MODES[mode]
    coeff = firdes.lowpass(cfg.if_fs * cfg.audio_interp, cfg.audio_fc,
                           cfg.audio_taps, cfg.audio_gain)
    rs = PolyphaseResampler(coeff, cfg.audio_interp, cfg.audio_decim)
    n_if = cfg.if_per_block
    y, _ = rs(np.zeros(n_if, np.float32), rs.init_state())
    assert y.shape[-1] == cfg.audio_per_block


def test_multifir_mixed_taps(rng):
    """MultiFIR with unequal tap counts zero-pads to the longest and matches
    per-filter PolyphaseResamplers exactly."""
    from sdr_tpu.ops.resample import MultiFIR

    c_long = firdes.bandpass(240e3, 22e3, 54e3, 51)
    c_short = firdes.bandpass(240e3, 18.5e3, 19.5e3, 31)
    mf = MultiFIR([c_long, c_short])
    assert mf.taps == 51 and mf.state_len == 50

    x = rng.standard_normal(512).astype(np.float32)
    tail = mf.init_state()
    (y_long, y_short), _ = mf(x, tail)

    for coeff, got in ((c_long, y_long), (c_short, y_short)):
        ref = PolyphaseResampler(coeff, 1, 1)
        want, _ = ref(x, ref.init_state())
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   atol=1e-6)


# ------------------------------------------------------- tiled banded GEMM
@pytest.mark.parametrize("name,u,d,taps_fn", [
    ("audio_m0", 1, 5, lambda: firdes.lowpass(240e3, 16e3, 101, 1)),
    ("rds_m0", 19, 120, lambda: firdes.lowpass(240e3 * 19, 3e3, 51 * 19, 19)),
    ("rrc", 1, 1, lambda: firdes.root_raised_cosine(38e3, 151, 2375.0)),
    ("audio_m2", 147, 800,
     lambda: firdes.lowpass(240e3 * 147, 16e3, 101 * 147, 147)),
    ("bpf", 1, 1, lambda: firdes.bandpass(240e3, 22e3, 54e3, 51)),
])
def test_tiled_banded_matches_polyphase(rng, name, u, d, taps_fn):
    """TiledBandedFIR (ops/banded.py — the dense-matmul schedule of the
    resampling stages) computes the same terms
    as PolyphaseResampler: float-tolerance equivalence across two blocks
    (tail carry) at every receiver geometry, non-tile-multiple lengths
    included."""
    from sdr_tpu.ops.banded import TiledBandedFIR

    coeff = taps_fn()
    ref = PolyphaseResampler(coeff, u, d)
    new = TiledBandedFIR(coeff, u, d)
    assert new.state_len == ref.state_len  # state-compatible drop-in
    n = d * 601 if d > 1 else 677          # deliberately ragged tiles
    x = rng.standard_normal((3, n)).astype(np.float32)
    t_ref = np.asarray(ref.init_state((3,)))
    t_new = np.asarray(new.init_state((3,)))
    for _ in range(2):
        y_ref, t_ref = ref(x, t_ref)
        y_new, t_new = new(x, t_new)
        scale = max(float(np.abs(np.asarray(y_ref)).max()), 1e-6)
        np.testing.assert_allclose(np.asarray(y_new), np.asarray(y_ref),
                                   atol=2e-6 * scale)


def test_tiled_banded_bf16_store_matches_cast(rng):
    """bf16 compute: storing inputs/tails at bf16 equals f32 storage with
    per-use bf16 cast (the cast is the first thing the einsum does) —
    the bf16-materialization profile's exactness argument."""
    import jax.numpy as jnp

    from sdr_tpu.ops.banded import TiledBandedFIR

    coeff = firdes.lowpass(240e3, 16e3, 101, 1)
    f = TiledBandedFIR(coeff, 1, 5, compute_dtype=jnp.bfloat16)
    x = rng.standard_normal((2, 1200)).astype(np.float32)
    t = f.init_state((2,))
    assert t.dtype == jnp.bfloat16
    y1, t1 = f(x, t)
    # reference: an engine that KEEPS inputs/tails at f32 and casts to bf16
    # only inside the einsum (the per-use-cast semantics the bf16-store
    # engine claims to match)
    g = TiledBandedFIR(coeff, 1, 5, compute_dtype=jnp.bfloat16)
    g._store_dtype = jnp.float32
    tg = g.init_state((2,))
    assert tg.dtype == jnp.float32
    y2, t2 = g(x, tg)
    np.testing.assert_array_equal(np.asarray(y1), np.asarray(y2))
    # the carried tail is raw input samples: bf16 storage == bf16(f32 tail)
    np.testing.assert_array_equal(
        np.asarray(t1), np.asarray(t2.astype(jnp.bfloat16)))
