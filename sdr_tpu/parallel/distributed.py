"""Multi-host execution helpers.

SURVEY §5.8: the communication story is collectives among the devices of a
host and across hosts via `jax.distributed`, with each host feeding its
own shard of RF channels (the reference's pipes/queues have no multi-process
analogue to translate).  This module wires that up without requiring a
cluster to import: initialization is explicit and test suites exercise the
same shard_map code on a virtual CPU mesh (SURVEY §4.3).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Bring up the multi-host runtime (no-op on a single process).

    Clusters with standard env plumbing autodetect under a bare
    `jax.distributed.initialize()`; the args are for manual CPU/GPU
    clusters (a single GPU host exports none of that plumbing).
    """
    if num_processes is not None and num_processes <= 1:
        return
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def global_channel_mesh(axis: str = "channels") -> Mesh:
    """Mesh over every device in the job (all hosts)."""
    return Mesh(np.array(jax.devices()), (axis,))


def local_channel_slice(n_channels: int) -> tuple[int, int]:
    """[start, stop) of the channel range this host feeds.

    Per-host feeding: each host reads/synthesizes only its own channels'
    u8 streams and `jax.make_array_from_process_local_data` assembles the
    global sharded batch.
    """
    n_proc = jax.process_count()
    idx = jax.process_index()
    per = n_channels // n_proc
    assert n_channels % n_proc == 0, (
        f"{n_channels} channels not divisible across {n_proc} hosts")
    return idx * per, (idx + 1) * per


def make_global_batch(local_u8: np.ndarray, mesh: Mesh,
                      axis: str = "channels"):
    """Assemble a globally-sharded (channels, n) array from each host's
    locally-fed shard."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    sharding = NamedSharding(mesh, P(axis))
    return jax.make_array_from_process_local_data(sharding, local_u8)
