"""Device mesh helpers.

Scale-out (SURVEY §2.3): the reference's only parallelism is a
3-pthread pipeline with a bounded queue (src/project.cpp:17-271); here the
equivalents are
  - channel data-parallelism: independent RF stations sharded over a mesh
    axis (each station's stream stays on one device — preferred, SURVEY §7
    step 7),
  - time-axis sequence parallelism: one station's sample stream sharded
    over devices with overlap halo exchange (parallel/timeshard.py),
  - multi-host: `jax.distributed` + per-host feeding (parallel/distributed.py).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: int | None = None, axis: str = "channels",
              devices: list | None = None) -> Mesh:
    """1-D mesh over the given axis (default: all local devices)."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (axis,))


def channel_sharding(mesh: Mesh, axis: str = "channels") -> NamedSharding:
    """Shard the leading (channel) dim; replicate everything trailing."""
    return NamedSharding(mesh, P(axis))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
