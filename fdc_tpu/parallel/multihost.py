"""Multi-host bring-up: jax.distributed + global (time, chan) mesh + feeding.

The reference is strictly single-process (SURVEY.md §2.4); this module is
the pod-scale story (BASELINE config 5: 200+ MS/s, 512+ dynamic channels,
≥2 hosts). Pattern:

1. every host calls :func:`initialize_multihost` (jax.distributed),
2. every host builds the same :func:`global_mesh` over ALL devices,
3. a ShardedChannelizer is constructed identically on every host,
4. each host feeds its own contiguous run of time-blocks per step via
   :func:`host_local_batch` (jax.make_array_from_process_local_data) — the
   natural layout when each host fronts its own digitizer/stream shard,
5. the jitted shard_map step runs as one SPMD program; the overlap-save
   history crosses host boundaries inside ``lax.ppermute`` over DCN/ICI.

Device-count-agnostic by construction: the same code runs on 1 chip, one
host, or a pod slice — only the mesh shape changes.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from fdc_tpu.parallel.mesh import CHAN_AXIS, TIME_AXIS

__all__ = ["initialize_multihost", "global_mesh", "host_local_batch"]


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> int:
    """Initialize jax.distributed (no-op when single-process).

    With no arguments, relies on the cluster environment (SLURM / GKE
    metadata) exactly like ``jax.distributed.initialize()``. Returns the
    process index.
    """
    if num_processes is not None and num_processes > 1 or coordinator_address:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    return jax.process_index()


def global_mesh(n_chan: int = 1, devices: Optional[Sequence] = None) -> Mesh:
    """(time, chan) mesh over ALL devices of ALL hosts.

    Device order groups each host's devices contiguously along the time
    axis, so each host's local time shards are consecutive — a host feeds
    one contiguous run of samples (matching a per-host stream source), and
    the ppermute ring crosses hosts only at shard boundaries.
    """
    devices = list(devices) if devices is not None else jax.devices()
    n = len(devices)
    if n % n_chan:
        raise ValueError(f"{n} devices not divisible by n_chan={n_chan}")
    # jax.devices() orders by process; keep that order.
    grid = np.array(devices, dtype=object).reshape(n // n_chan, n_chan)
    return Mesh(grid, (TIME_AXIS, CHAN_AXIS))


def host_local_batch(mesh: Mesh, xf_local: np.ndarray) -> jax.Array:
    """Build the global [B_total*inplen, 2] input from per-host sample runs.

    Each host passes its own xf_local = float32 [B_host*inplen, 2] (its
    contiguous run of this step's samples, complex64 pairs); the result is
    the globally-sharded array the ShardedChannelizer step consumes.
    """
    sharding = NamedSharding(mesh, P(TIME_AXIS, None))
    return jax.make_array_from_process_local_data(sharding, xf_local)
