"""Wideband streaming receiver: channelize + decode N stations, ONE program.

Round-1 composed the channelizer and the per-station receiver as separate
dispatches per block with the whole capture in host RAM.
Here the composition is a single pure `step(state, wide_block)` — the
channelizer's oscillator/tail state and the receiver's pytree ride one
carry — jitted once and scanned `scan_steps` blocks per dispatch, so the
per-block Python overhead vanishes and the CLI can stream captures larger
than RAM block-by-block from disk/stdin.

Input is the raw interleaved wideband stream in either f32 or u8
(reference ingest semantics, (x-128)/128 — src/iofunc.cpp:62-69); u8 ships
4x fewer bytes over the host link and decodes on device.
"""

from __future__ import annotations

import functools
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from sdr_tpu.io.stream import decode_u8_iq
from sdr_tpu.models.receiver import Receiver
from sdr_tpu.ops.channelizer import WidebandChannelizer


class WidebandReceiver:
    """One fused program: wideband block -> K station outputs.

    Args:
      chan: configured WidebandChannelizer (K stations).
      rx: per-station Receiver (batch axis = stations).
    """

    def __init__(self, chan: WidebandChannelizer, rx: Receiver):
        self.chan = chan
        self.rx = rx
        # wideband samples per receiver block: station block in IQ pairs
        # times the channelizer decimation
        self.block_pairs = (rx.block_size_u8() // 2) * chan.decim

    def block_wide(self, blocks_per_step: int = 1) -> int:
        """Interleaved wideband scalars (2 per IQ pair) per step."""
        return 2 * self.block_pairs * blocks_per_step

    def init_state(self):
        return (self.chan.init_state(), self.rx.init_state((self.chan.k,)))

    def step(self, state, wide):
        """One block: `wide` is the raw interleaved stream (2N,), u8 or f32.

        Returns (new_state, outputs) with outputs batched over stations.
        The mfb channelizer consumes the interleaved stream directly — u8
        decodes inside the compute cast, so the 8x f32 wideband stream
        never materializes in HBM (the round-2 wideband-ingest bottleneck).
        """
        cstate, rstate = state
        with jax.named_scope("channelize"):
            if self.chan.engine == "mfb":
                (i_st, q_st), cstate = self.chan.call_interleaved(wide,
                                                                  cstate)
            else:
                with jax.named_scope("wideband_ingest"):
                    if wide.dtype == jnp.uint8:
                        i_w, q_w = decode_u8_iq(wide)
                    else:
                        i_w, q_w = wide[0::2], wide[1::2]
                (i_st, q_st), cstate = self.chan(i_w, q_w, cstate)
        rstate, out = self.rx.step_iq(rstate, i_st, q_st)
        return (cstate, rstate), out

    @partial(jax.jit, static_argnums=(0,))
    def _scan_steps(self, state, wide_steps):
        """(S, 2N) blocks under one lax.scan — one dispatch per S blocks."""
        return jax.lax.scan(self.step, state, wide_steps)

    def run(self, wide, *, blocks_per_step: int = 1, state=None):
        """Whole-capture convenience: scan over all full blocks.

        wide: (n,) interleaved u8 or f32; trailing partial block dropped.
        Returns (outputs concatenated over time, final_state).
        """
        bw = self.block_wide(blocks_per_step)
        nsteps = wide.shape[-1] // bw
        if nsteps == 0:
            raise ValueError(f"capture shorter than one block ({bw})")
        steps = jnp.asarray(wide[: nsteps * bw]).reshape(nsteps, bw)
        if state is None:
            state = self.init_state()
        state, outs = self._scan_steps(state, steps)
        outputs = {k: jnp.moveaxis(v, 0, -2).reshape(self.chan.k, -1)
                   if v.ndim == 3 else jnp.moveaxis(v, 0, -1)
                   for k, v in outs.items()}
        return outputs, state

    def stream(self, reader, *, blocks_per_step: int = 1, state=None,
               scan_steps: int = 4):
        """Stream from a chunk reader: yields (outputs, state) per dispatch.

        reader: iterable of np arrays (any sizes); internally re-framed to
        `scan_steps` blocks per scanned dispatch with a bounded carry —
        captures larger than RAM stream in O(scan_steps * block) memory.
        """
        if state is None:
            state = self.init_state()
        bw = self.block_wide(blocks_per_step)
        chunk = scan_steps * bw
        buf: list[np.ndarray] = []
        have = 0
        for raw in reader:
            buf.append(np.asarray(raw))
            have += len(buf[-1])
            while have >= chunk:
                flat = np.concatenate(buf) if len(buf) > 1 else buf[0]
                steps, rest = flat[:chunk], flat[chunk:]
                buf, have = [rest], len(rest)
                state, outs = self._scan_steps(
                    state, jnp.asarray(steps).reshape(scan_steps, bw))
                outputs = {k: jnp.moveaxis(v, 0, -2).reshape(self.chan.k, -1)
                           if v.ndim == 3 else jnp.moveaxis(v, 0, -1)
                           for k, v in outs.items()}
                yield outputs, state
        # tail: whole blocks that don't fill a scan chunk, one at a time
        flat = np.concatenate(buf) if len(buf) > 1 else (
            buf[0] if buf else np.zeros(0))
        for b in range(len(flat) // bw):
            state, out = self._jit_step(
                state, jnp.asarray(flat[b * bw:(b + 1) * bw]))
            yield {k: v for k, v in out.items()}, state

    @functools.cached_property
    def _jit_step(self):
        return jax.jit(self.step)
