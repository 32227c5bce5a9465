"""Station-sharded wideband receiver: one antenna stream -> K stations
over an N-device mesh.

The raw wideband block is replicated to every device (it is the single
physical input); each device channelizes ONLY its station slice and runs
the per-station receivers as ordinary channel DP.  The modulated filter
bank (ops/channelizer.py, engine "mfb") is per-station in all its
constants: station k owns columns 2k, 2k+1 of the GEMM matrix `_bmat`, row
k of the factored phasor tables and entry k of the per-block phase advance
— so sharding the station axis shards those constants (a few hundred KB
per device), and every device reads the wideband samples once from its own
copy.  There is NO cross-device communication at any point: the per-device
program contains zero collectives (asserted in tests/test_parallel.py).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from sdr_tpu.models.receiver import Receiver
from sdr_tpu.ops.channelizer import (WidebandChannelizer,
                                     _channelize_mfb,
                                     _largest_divisor_at_most)


def sharded_wideband_run(chan: WidebandChannelizer, rx: Receiver,
                         wide, mesh: Mesh, *, axis: str = "stations",
                         blocks_per_step: int = 1):
    """Run the wideband receiver with stations sharded over `mesh`.

    chan: an mfb WidebandChannelizer for ALL K stations (K divisible by
      the mesh axis size).
    rx:   the per-station Receiver (the same program runs on every device).
    wide: (n,) raw interleaved stream, u8 or f32 — the one antenna input;
      whole steps only (a trailing partial step is dropped, as in
      WidebandReceiver.run).

    Returns (outputs (K, ...) sharded over axis, final receiver state).
    """
    assert chan.engine == "mfb", "station sharding uses the mfb engine"
    n_dev = mesh.shape[axis]
    k = chan.k
    assert k % n_dev == 0, (k, n_dev)
    kl = k // n_dev

    # ---- frame the stream into steps (WidebandReceiver.block_wide)
    bw = 2 * (rx.block_size_u8(blocks_per_step) // 2) * chan.decim
    nsteps = wide.shape[-1] // bw
    assert nsteps > 0, f"capture shorter than one wideband block ({bw})"
    steps = jnp.asarray(wide[: nsteps * bw]).reshape(nsteps, bw)
    n_out = bw // (2 * chan.decim)
    tile = _largest_divisor_at_most(n_out, 16384)  # as _mfb_interleaved

    # ---- per-station constants, split on a leading device axis
    (rc, rs), (bc, bs), adv = chan._phase_tables(n_out, chan.decim, c=tile)
    bmat = np.asarray(chan._bmat)                       # (rows, 2K)
    bm = np.moveaxis(bmat.reshape(bmat.shape[0], n_dev, 2 * kl), 1, 0)
    split = lambda a: np.asarray(a).reshape(n_dev, kl, *a.shape[1:])

    shard = NamedSharding(mesh, P(axis))
    dev = lambda a: jax.device_put(jnp.asarray(a), shard)
    consts = tuple(map(dev, (bm, split(rc), split(rs), split(bc), split(bs),
                             split(adv))))
    steps = jax.device_put(steps, NamedSharding(mesh, P()))
    cstate0 = chan.init_state()
    phase0 = jax.device_put(cstate0["phase"], shard)
    tail0 = jax.device_put(cstate0["tail"], NamedSharding(mesh, P()))
    rx_state0 = jax.jit(lambda: rx.init_state((k,)), out_shardings=shard)()

    @partial(shard_map, mesh=mesh,
             in_specs=(P(),) + (P(axis),) * 7 + (P(), P(axis)),
             out_specs=(P(axis), P(axis)), check_vma=False)
    def run_shard(steps, bm, rc, rs, bc, bs, adv, phase, tail, rx_state):
        bm, rc, rs, bc, bs, adv = (a[0] for a in (bm, rc, rs, bc, bs, adv))

        def step(carry, wide_blk):
            cst, rst = carry
            (i_st, q_st), cst = _channelize_mfb(
                bm, (rc, rs), (bc, bs), adv, chan.decim, chan.state_len,
                chan._n_shift, tile, chan.compute_dtype, wide_blk, cst)
            rst, out = rx.step_iq(rst, i_st, q_st)
            return (cst, rst), out

        (_, rst), outs = jax.lax.scan(
            step, ({"phase": phase, "tail": tail}, rx_state), steps)
        outs = {k_: (jnp.moveaxis(v, 0, 1).reshape(v.shape[1], -1)
                     if v.ndim == 3 else jnp.moveaxis(v, 0, 1))
                for k_, v in outs.items()}
        return outs, rst

    args = (steps, *consts, phase0, tail0, rx_state0)
    compiled = jax.jit(run_shard).lower(*args).compile()
    # expose the per-device program for collective-count inspection
    # (tests assert it contains zero collective ops)
    sharded_wideband_run.last_hlo = compiled.as_text()
    outs, final = compiled(*args)
    return outs, final
