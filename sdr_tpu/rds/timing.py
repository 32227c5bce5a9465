"""RDS clock/data recovery (CDR): branchless sampling-phase selection.

The spec requires picking the best sampling instant per 2375 Hz symbol out
of SPS candidates (spec p.14); the reference never implemented it
(SURVEY §2.5).  Data-dependent control flow is jit-hostile, so the device
formulation scores *all* SPS phases and selects by argmax (SURVEY §7
hard-part 4): reshape the RRC-filtered waveform to (nsym, SPS), score each
phase by mean |amplitude| at its sampling instants, take the winning column.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


@partial(jax.jit, static_argnames=("sps",))
def recover_symbols(soft: jax.Array, sps: int):
    """Pick the max-energy sampling phase and slice symbols.

    Args:
      soft: (..., n) RRC-filtered baseband, n divisible by sps.
    Returns:
      (symbols (..., n/sps), phase (...,) int32 chosen sampling offset)
    """
    n = soft.shape[-1]
    nsym = n // sps
    grid = soft[..., : nsym * sps].reshape(*soft.shape[:-1], nsym, sps)
    score = jnp.mean(jnp.abs(grid), axis=-2)           # (..., sps)
    phase = jnp.argmax(score, axis=-1)                  # (...,)
    symbols = jnp.take_along_axis(
        grid, phase[..., None, None], axis=-1)[..., 0]
    return symbols, phase.astype(jnp.int32)


@jax.jit
def manchester_pairing_score(symbols: jax.Array):
    """Score both biphase pairing parities.

    RDS transmits each bit as two opposite-polarity symbols; the receiver
    must decide whether pairs start at even or odd symbol indices.  The
    correct parity maximizes |s0 - s1| summed over pairs (opposite-sign
    pairs add, same-sign cancel).  Returns (score_even, score_odd).
    """
    n = symbols.shape[-1] - (symbols.shape[-1] % 2)
    even = symbols[..., :n]
    s_even = jnp.sum(jnp.abs(even[..., 0::2] - even[..., 1::2]), axis=-1)
    m = symbols.shape[-1] - 1
    m -= (m % 2)
    odd = symbols[..., 1:1 + m]
    s_odd = jnp.sum(jnp.abs(odd[..., 0::2] - odd[..., 1::2]), axis=-1)
    return s_even, s_odd
