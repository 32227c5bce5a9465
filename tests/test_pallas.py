"""Fused front-end kernel (ops/pallas/frontend_kernel.py) against the plain
XLA path, in the Pallas interpreter on the CPU; `gpu`-marked cases compile
it for the card and skip elsewhere."""

import numpy as np
import pytest

import jax.numpy as jnp

from sdr_tpu.config import MODES
from sdr_tpu.device import interpret_kernels
from sdr_tpu.io.stream import decode_u8_iq
from sdr_tpu.ops import firdes
from sdr_tpu.ops.demod import fm_discriminator
from sdr_tpu.ops.pallas.frontend_kernel import TILE, FusedFrontend
from sdr_tpu.ops.resample import PolyphaseResampler


def _plain(cfg):
    """The reference front end: decode, two f32 polyphase FIRs, the
    discriminator; returns a stateful step like FusedFrontend.__call__."""
    coeff = firdes.lowpass(cfg.rf_fs, cfg.rf_fc, cfg.rf_taps, 1)
    rs = PolyphaseResampler(coeff, 1, cfg.rf_decim)

    def step(u8, st):
        i_t, q_t, p_i, p_q = st
        i, q = decode_u8_iq(jnp.asarray(u8))
        i_ds, i_t = rs(i, i_t)
        q_ds, q_t = rs(q, q_t)
        fm, p_i, p_q = fm_discriminator(i_ds, q_ds, p_i, p_q)
        power = jnp.sum(i_ds * i_ds + q_ds * q_ds, axis=-1)
        return fm, (i_t, q_t, p_i, p_q), power

    def init(batch):
        z = jnp.zeros(batch, jnp.float32)
        return (rs.init_state(batch), rs.init_state(batch), z, z)

    return coeff, step, init


def _capture(cfg, n_u8, batch, seed):
    """Real FM captures (different tones per station), cut to n_u8 (the
    transmitter emits whole receiver blocks, so synthesize enough)."""
    from sdr_tpu import tx
    blocks = -(-n_u8 // cfg.block_size_u8)
    n = blocks * cfg.block_size_u8 // 2
    caps = [tx.synthesize_capture(
        cfg, seconds=n / cfg.rf_fs,
        mono=tx.tone(cfg.rf_fs, 700.0 + 300.0 * c, n), seed=seed + c)[:n_u8]
        for c in range(max(1, int(np.prod(batch))))]
    return np.stack(caps).reshape(*batch, n_u8)


def _run_kernel(fe, blocks, batch):
    tail = fe.init_state(batch)
    p_i = p_q = jnp.zeros(batch, jnp.float32)
    outs, powers = [], []
    with interpret_kernels():
        for u8 in blocks:
            fm, tail, p_i, p_q, power = fe(jnp.asarray(u8), tail, p_i, p_q)
            outs.append(np.asarray(fm))
            powers.append(np.asarray(power))
    return np.concatenate(outs, axis=-1), powers, (tail, p_i, p_q)


@pytest.mark.parametrize("batch", [(), (3,)], ids=["scalar", "batch3"])
@pytest.mark.parametrize("mode", [0, 1, 2, 3])
def test_frontend_kernel_matches_plain(mode, batch):
    """Every mode's decimation (10, 4, 10, 9), a scalar and a (3,) batch,
    and blocks whose IF length (150) is not a multiple of the tile:
    fm_demod within 1e-4 of the signal peak of the plain f32 path, with
    the tail and discriminator carry across two blocks."""
    cfg = MODES[mode]
    coeff, step, init = _plain(cfg)
    fe = FusedFrontend(coeff, cfg.rf_decim)
    assert 150 % TILE and 150 > TILE
    n_u8 = 2 * cfg.rf_decim * 150
    cap = _capture(cfg, 2 * n_u8, batch, seed=mode)
    blocks = [cap[..., :n_u8], cap[..., n_u8:]]
    got, _, (tail, p_i, p_q) = _run_kernel(fe, blocks, batch)
    st = init(batch)
    ref = []
    for u8 in blocks:
        fm, st, _ = step(u8, st)
        ref.append(np.asarray(fm))
    ref = np.concatenate(ref, axis=-1)
    assert got.shape == ref.shape == batch + (300,)
    peak = np.abs(ref).max()
    assert np.abs(got - ref).max() <= 1e-4 * peak
    np.testing.assert_array_equal(np.asarray(tail), cap[..., -fe.tail_u8:])
    np.testing.assert_allclose(np.asarray(p_i), np.asarray(st[2]), atol=1e-6)
    np.testing.assert_allclose(np.asarray(p_q), np.asarray(st[3]), atol=1e-6)


def test_frontend_kernel_block_continuity():
    """One long block == the same bytes in three uneven blocks: the raw u8
    tail and the discriminator carry make the split invisible."""
    cfg = MODES[0]
    coeff = firdes.lowpass(cfg.rf_fs, cfg.rf_fc, cfg.rf_taps, 1)
    fe = FusedFrontend(coeff, cfg.rf_decim)
    unit = 2 * cfg.rf_decim
    cap = _capture(cfg, unit * 400, (2,), seed=11)
    whole, _, _ = _run_kernel(fe, [cap], (2,))
    cuts = [0, unit * 70, unit * 263, unit * 400]
    parts, _, _ = _run_kernel(
        fe, [cap[:, a:b] for a, b in zip(cuts, cuts[1:])], (2,))
    peak = np.abs(whole).max()
    assert np.abs(parts - whole).max() <= 1e-6 * peak


def test_frontend_kernel_rssi_power_sum():
    """The per-block sum of I^2 + Q^2 (the RSSI input) matches the plain
    path's decimated I/Q, including a partial last tile."""
    cfg = MODES[3]
    coeff, step, init = _plain(cfg)
    fe = FusedFrontend(coeff, cfg.rf_decim)
    n_u8 = 2 * cfg.rf_decim * 200
    cap = _capture(cfg, 2 * n_u8, (2,), seed=5)
    blocks = [cap[:, :n_u8], cap[:, n_u8:]]
    _, powers, _ = _run_kernel(fe, blocks, (2,))
    st = init((2,))
    for u8, got in zip(blocks, powers):
        _, st, want = step(u8, st)
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5)


def test_receiver_fused_frontend_matches_plain():
    """Receiver(fused_frontend=True) reproduces the plain receiver's mono
    audio and RSSI through the whole chain."""
    from sdr_tpu import tx
    from sdr_tpu.models.receiver import Receiver

    cfg = MODES[0]
    cap = tx.synthesize_capture(cfg, seconds=0.2,
                                mono=tx.tone(cfg.rf_fs, 800.0,
                                             int(0.2 * cfg.rf_fs)))
    with interpret_kernels():
        out_a, _ = Receiver(0, fused_frontend=True, emit_rssi=True).run(cap)
    out_b, _ = Receiver(0, emit_rssi=True).run(cap)
    a, b = np.asarray(out_a["mono"]), np.asarray(out_b["mono"])
    assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max()
    np.testing.assert_allclose(np.asarray(out_a["rssi_db"]),
                               np.asarray(out_b["rssi_db"]), atol=1e-4)


def test_fused_frontend_rejects_arctan_demod():
    """The kernel always fuses the discriminator."""
    from sdr_tpu.models.receiver import Receiver
    with pytest.raises(ValueError, match="arctan"):
        Receiver(0, fused_frontend=True, demod="arctan")


@pytest.mark.gpu
def test_frontend_kernel_compiled_matches_plain(gpu):
    """On the card: the compiled kernel against the plain f32 path at the
    benchmark's station count."""
    cfg = MODES[0]
    coeff, step, init = _plain(cfg)
    fe = FusedFrontend(coeff, cfg.rf_decim)
    batch = (128,)
    cap = _capture(cfg, cfg.block_size_u8 * 4, (8,), seed=1)
    cap = np.tile(cap, (16, 1))
    tail = fe.init_state(batch)
    z = jnp.zeros(batch, jnp.float32)
    got = np.asarray(fe(jnp.asarray(cap), tail, z, z)[0])
    want = np.asarray(step(cap, init(batch))[0])
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
