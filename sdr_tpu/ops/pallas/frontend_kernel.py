"""Fused RF front end for the GPU (Pallas through Triton).

u8 decode + 51-tap FIR + decimation + FM discriminator in one kernel, so the
only bytes that move are the raw u8 IQ stream in and `fm_demod` out.  The
plain XLA path decodes to f32 I/Q first (8 bytes per complex sample instead
of 2), writes that stream, and reads it back into the strided convolution.

One program computes TILE consecutive decimated outputs of one station.
For output n the FIR reads the interleaved bytes of samples nD-(K-1) .. nD;
the discriminator also needs output n-1, whose window is D samples earlier.
Blocks run in parallel in no order, so nothing carries between them:
instead each program gathers the UNION window of both (2*(K+D) bytes) in
`width`-byte chunks from L1 and accumulates two coefficient sets over the
same loaded bytes — the current output and its predecessor.  The I/Q split
is by lane parity (even bytes are I, odd are Q; both rails share one
filter), reduced once per output.

The decode (x - 128) is exact in f32; the 1/128 scale is folded into the
coefficients (a power of two: exact).  Products and sums are f32 on the
CUDA cores — no TF32 anywhere.

Streaming state: the carried last 2*(K-1) u8 bytes of the previous block
(the reference's resample tail, src/filter.cpp:95-102, in the raw
interleaved domain) and the last decimated I/Q sample (the discriminator's
carry, src/filter.cpp:106-133).  The block's first output takes its
predecessor from that carry; windows reaching before the block read the
tail buffer (only the first tile has such windows).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from sdr_tpu import device

WIDTH = 16  # bytes per gathered chunk (8 complex samples)
# outputs per program and warps per program: the fastest of a sweep on an
# H100 at 128 stations (tile 32-256, 1-8 warps, 1-2 stages were all within
# 10% at 50 blocks per step; 64 / 2 best there and near-best at 1 block)
TILE = 64
NUM_WARPS = 2


def _coefficient_sets(coeff: np.ndarray, decim: int, width: int = WIDTH):
    """(2, chunks*width) f32: row 0 weights the union window for output n,
    row 1 for output n-1.  Byte b of the window is sample s = b // 2 (rail
    b % 2) at index nD - D - (K-1) + s, so the current output's tap is
    k = D + K - 1 - s and the predecessor's k = K - 1 - s."""
    taps = len(coeff)
    span = 2 * (taps + decim)
    chunks = -(-span // width)
    sets = np.zeros((2, chunks * width), np.float64)
    h = np.asarray(coeff, np.float64) / 128.0
    for b in range(span):
        s = b // 2
        k_cur = decim + taps - 1 - s
        k_prev = taps - 1 - s
        if 0 <= k_cur < taps:
            sets[0, b] = h[k_cur]
        if 0 <= k_prev < taps:
            sets[1, b] = h[k_prev]
    return sets.astype(np.float32), chunks


def _decode(x):
    """Exact u8 -> f32 (x - 128) without an int-to-float conversion (a
    quarter-rate instruction on the GPU): the bits 0x4B0000xx are the float
    2^23 + x, and subtracting 2^23 + 128 is exact."""
    bits = x.astype(jnp.int32) | jnp.int32(0x4B000000)
    return (jax.lax.bitcast_convert_type(bits, jnp.float32)
            - jnp.float32(8388736.0))


def _frontend_kernel(body_ref, tail_ref, coef_ref, prev_ref, fm_ref, aux_ref,
                     *, decim, taps, tile, n_out, chunks, width):
    c = pl.program_id(0)
    t = pl.program_id(1)
    n_bytes = body_ref.shape[1]
    tail_len = tail_ref.shape[1]
    n = t * tile + jnp.arange(tile, dtype=jnp.int32)          # (tile,)
    lane = jnp.arange(width, dtype=jnp.int32)
    # union window start (bytes, relative to the block body; < 0 = tail)
    start = 2 * (n * decim - decim - (taps - 1))

    row_ok = (n < n_out)[:, None]

    def accumulate(with_tail: bool):
        acc_c = jnp.zeros((tile, width), jnp.float32)
        acc_p = jnp.zeros((tile, width), jnp.float32)
        for q in range(chunks):
            addr = start[:, None] + (q * width) + lane[None, :]
            if with_tail:
                # first tile: windows may start in the carried tail (and,
                # for output 0's predecessor, before it: never used)
                in_body = (addr >= 0) & row_ok
                in_tail = (addr < 0) & (addr >= -tail_len)
                x = plgpu.load(body_ref.at[c, jnp.where(in_body, addr, 0)],
                               mask=in_body, other=128)
                xt = plgpu.load(
                    tail_ref.at[c, jnp.where(in_tail, addr + tail_len, 0)],
                    mask=in_tail, other=128)
                x = jnp.where(in_tail, xt, x)
            else:
                # every window of a valid output lies inside the block
                # (asserted by the caller's geometry): the mask is per row,
                # so the compiler keeps each chunk one contiguous load
                x = plgpu.load(body_ref.at[c, addr], mask=row_ok, other=128)
            xf = _decode(x)
            w_c = plgpu.load(coef_ref.at[0, pl.ds(q * width, width)])
            w_p = plgpu.load(coef_ref.at[1, pl.ds(q * width, width)])
            acc_c = acc_c + xf * w_c[None, :]
            acc_p = acc_p + xf * w_p[None, :]
        return acc_c, acc_p

    acc_c, acc_p = jax.lax.cond(t == 0, lambda: accumulate(True),
                                lambda: accumulate(False))
    even = (lane % 2 == 0)[None, :]
    i_cur = jnp.sum(jnp.where(even, acc_c, 0.0), axis=1)
    q_cur = jnp.sum(jnp.where(even, 0.0, acc_c), axis=1)
    i_prev = jnp.sum(jnp.where(even, acc_p, 0.0), axis=1)
    q_prev = jnp.sum(jnp.where(even, 0.0, acc_p), axis=1)
    # the block's first output continues the previous block's last sample
    first = n == 0
    i_prev = jnp.where(first, plgpu.load(prev_ref.at[c, 0]), i_prev)
    q_prev = jnp.where(first, plgpu.load(prev_ref.at[c, 1]), q_prev)
    # discriminator, ops/demod.py fm_discriminator semantics
    num = i_cur * (q_cur - q_prev) - q_cur * (i_cur - i_prev)
    den = i_cur * i_cur + q_cur * q_cur
    fm = jnp.where(den == 0.0, 0.0, num / jnp.where(den == 0.0, 1.0, den))
    valid = n < n_out
    # a contiguous slice, not a gather index: no two lanes share an address
    plgpu.store(fm_ref.at[c, pl.ds(t * tile, tile)], fm.astype(fm_ref.dtype),
                mask=valid)
    last = n == n_out - 1
    aux_ref[0, c, t] = jnp.sum(jnp.where(valid, den, 0.0))
    aux_ref[1, c, t] = jnp.sum(jnp.where(last, i_cur, 0.0))
    aux_ref[2, c, t] = jnp.sum(jnp.where(last, q_cur, 0.0))


@functools.partial(jax.jit, static_argnames=(
    "decim", "taps", "chunks", "out_dtype", "interpret"))
def _frontend_call(body, tail, coef, prev, *, decim, taps, chunks, out_dtype,
                   interpret):
    c, n_bytes = body.shape
    n_out = n_bytes // (2 * decim)
    n_tiles = pl.cdiv(n_out, TILE)
    kernel = functools.partial(_frontend_kernel, decim=decim, taps=taps,
                               tile=TILE, n_out=n_out, chunks=chunks,
                               width=WIDTH)
    fm, aux = pl.pallas_call(
        kernel,
        grid=(c, n_tiles),
        out_shape=(jax.ShapeDtypeStruct((c, n_out), out_dtype),
                   jax.ShapeDtypeStruct((3, c, n_tiles), jnp.float32)),
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        backend="triton",
        interpret=interpret,
        name="fm_frontend",
    )(body, tail, coef, prev)
    # aux rows: per-tile power sums, and I/Q of the block's last output
    # (only the last tile holds it; every other entry is zero)
    return fm, aux[0].sum(axis=-1), aux[1, :, -1], aux[2, :, -1]


class FusedFrontend:
    """Stateful fused front end: u8 block -> fm_demod, like the plain
    decode + two PolyphaseResamplers + fm_discriminator chain.

    `tail` is the carried last 2*(taps-1) interleaved u8 bytes.
    """

    def __init__(self, coeff: np.ndarray, decim: int, *, out_dtype=None):
        self.taps = len(coeff)
        self.decim = int(decim)
        self.out_dtype = out_dtype or jnp.float32
        self.tail_u8 = 2 * (self.taps - 1)
        sets, self.chunks = _coefficient_sets(coeff, self.decim)
        # geometry the kernel relies on: tiles after the first never reach
        # the tail, and a valid output's padded window ends inside the block
        assert TILE * self.decim >= self.decim + self.taps - 1, TILE
        assert (self.chunks * WIDTH - 2 * (self.taps + self.decim)
                < 2 * self.decim - 1), (self.chunks, self.decim)
        self._coef = sets  # host array: a device constant would leak tracers

    def init_state(self, batch_shape: tuple[int, ...] = ()) -> jax.Array:
        # value 128 decodes to 0.0 == zero-filled float tails
        return jnp.full(batch_shape + (self.tail_u8,), 128, dtype=jnp.uint8)

    def __call__(self, u8_block: jax.Array, tail: jax.Array,
                 prev_i: jax.Array, prev_q: jax.Array):
        """Returns (fm_demod, new_tail, new_prev_i, new_prev_q, power_sum)
        with power_sum = sum(I^2 + Q^2) over the block's IF samples (RSSI).
        Leading batch dims (stations) of any rank; block length a multiple
        of 2*decim and at least the tail."""
        lead = u8_block.shape[:-1]
        n = u8_block.shape[-1]
        assert n % (2 * self.decim) == 0 and n >= self.tail_u8, n
        body = u8_block.reshape(-1, n)
        prev = jnp.stack([jnp.reshape(prev_i, (-1,)),
                          jnp.reshape(prev_q, (-1,))], axis=-1)
        fm, power, last_i, last_q = _frontend_call(
            body, tail.reshape(-1, self.tail_u8), jnp.asarray(self._coef),
            prev.astype(jnp.float32), decim=self.decim, taps=self.taps,
            chunks=self.chunks, out_dtype=self.out_dtype,
            interpret=device.kernel_interpret())
        new_tail = u8_block[..., n - self.tail_u8:]
        return (fm.reshape(*lead, -1), new_tail, last_i.reshape(lead),
                last_q.reshape(lead), power.reshape(lead))
