"""FM demodulators.

Two variants, matching the reference repertoire:

 - `fm_discriminator`: arctan-free discriminator
   (I*dQ - Q*dI)/(I^2 + Q^2) with divide-by-zero guard and carried previous
   sample (reference: src/filter.cpp:106-133 `FMDemod`; Python oracle
   model/fmMonoBlock.py:59-81 `myDemod`).
 - `fm_arctan`: atan2 + unwrap + phase difference with carried phase
   (reference: model/fmSupportLib.py:34-63 `fmDemodArctan`).

Vectorized: the reference's per-sample loop has a trivial one-sample
recurrence (prev_i/prev_q is just the previous input sample), so it
vectorizes exactly with a concat-shift — no scan needed (SURVEY §7 step 2).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


@jax.jit
def fm_discriminator(i_ds: jax.Array, q_ds: jax.Array,
                     prev_i: jax.Array, prev_q: jax.Array):
    """Arctan-free FM discriminator, block-streaming.

    Args:
      i_ds, q_ds: (..., N) downsampled IF I/Q.
      prev_i, prev_q: (...,) last sample of the previous block.
    Returns:
      (demod (..., N), new_prev_i (...,), new_prev_q (...,))
    """
    i_prev = jnp.concatenate([prev_i[..., None], i_ds[..., :-1]], axis=-1)
    q_prev = jnp.concatenate([prev_q[..., None], q_ds[..., :-1]], axis=-1)
    num = i_ds * (q_ds - q_prev) - q_ds * (i_ds - i_prev)
    den = i_ds * i_ds + q_ds * q_ds
    demod = jnp.where(den == 0.0, 0.0, num / jnp.where(den == 0.0, 1.0, den))
    return demod, i_ds[..., -1], q_ds[..., -1]


@jax.jit
def fm_arctan(i_ds: jax.Array, q_ds: jax.Array, prev_phase: jax.Array):
    """atan2/unwrap/diff demodulator (reference model/fmSupportLib.py:34-63).

    Vectorized: unwrap relative to the carried phase via cumulative 2*pi
    correction, then first difference.
    """
    phase = jnp.arctan2(q_ds, i_ds)
    full = jnp.concatenate([prev_phase[..., None], phase], axis=-1)
    unwrapped = jnp.unwrap(full, axis=-1)
    demod = jnp.diff(unwrapped, axis=-1)
    # Re-wrap the carried phase into (-pi, pi]: shifting the scan origin by a
    # multiple of 2*pi leaves all future diffs unchanged but avoids the
    # unbounded float32 drift the reference suffers on long streams.
    new_prev = jnp.mod(unwrapped[..., -1] + jnp.pi, 2 * jnp.pi) - jnp.pi
    return demod, new_prev
