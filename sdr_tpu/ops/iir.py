"""First-order IIR (single pole) as a parallel associative scan.

Used for FM de-emphasis (75 us Americas / 50 us Europe), the standard
post-demod treble cut that broadcast FM pre-emphasis assumes.  The
reference receiver omits it (not in the course spec's signal chain); a
production receiver needs it, so it is offered as an option
(`Receiver(deemphasis_us=...)`).

Parallel form: y[n] = a*y[n-1] + b*x[n] is a linear recurrence, which
`jax.lax.associative_scan` evaluates in O(log N) depth instead of an
N-step sequential scan — the composition (a2, b2) o (a1, b1) =
(a1*a2, a2*b1 + b2) is associative.  Streaming state is the last output
sample.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


@partial(jax.jit, static_argnames=("alpha",))
def first_order_iir(x: jax.Array, y_prev: jax.Array, *, alpha: float):
    """y[n] = (1-alpha)*y[n-1] + alpha*x[n], streaming.

    Args:
      x: (..., N) input block.
      y_prev: (...,) last output of the previous block.
    Returns (y (..., N), new y_prev (...,)).
    """
    a = jnp.float32(1.0 - alpha)
    b = jnp.float32(alpha)

    # prefix-compose the per-sample affine maps y -> a*y + b*x[n]
    coeff_a = jnp.broadcast_to(a, x.shape)
    coeff_b = b * x

    def compose(left, right):
        a1, b1 = left
        a2, b2 = right
        return a1 * a2, a2 * b1 + b2

    pa, pb = jax.lax.associative_scan(compose, (coeff_a, coeff_b), axis=-1)
    y = pa * y_prev[..., None] + pb
    return y, y[..., -1]


def deemphasis_alpha(fs: float, tau_us: float) -> float:
    """Discretized pole for an RC de-emphasis with time constant tau."""
    return float(1.0 - np.exp(-1.0 / (fs * tau_us * 1e-6)))
