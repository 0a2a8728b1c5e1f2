"""Multi-host bring-up: jax.distributed + a host-aware mesh.

The reference has no distributed runtime at all (SURVEY §2.8). In this
framework the scale-out story spans three tiers:

1. one device — everything under jit;
2. one host — (data × tile) mesh over its devices
   (:mod:`pcmi_tpu.parallel.mesh`);
3. several hosts — the embarrassingly parallel axes (stereo pairs,
   acquisition dates, AOIs of a sweep) span hosts, while the tile/halo
   axis, the only one that exchanges data every step, stays inside a host.

``initialize()`` wraps ``jax.distributed.initialize``;
``make_multihost_mesh()`` builds a (host, data, tile) mesh whose leading
axis spans processes, so collectives never cross hosts except on the axis
that needs no bandwidth.
"""

from __future__ import annotations

import os
from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh

HOST_AXIS = "host"


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Initialise jax.distributed when running multi-process.

    Safe to call unconditionally: single-process runs (no coordinator in
    the arguments or in ``JAX_COORDINATOR_ADDRESS``) return False without
    touching distributed state.
    """
    env_coord = os.environ.get("JAX_COORDINATOR_ADDRESS")
    if coordinator_address is None and env_coord is None:
        return False
    kwargs = {}
    if coordinator_address or env_coord:
        kwargs["coordinator_address"] = coordinator_address or env_coord
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)
    return True


def make_multihost_mesh(data: int = 1, tile: Optional[int] = None) -> Mesh:
    """(host, data, tile) mesh: processes on the leading axis.

    Pairs/dates/AOIs shard over ``host`` × ``data`` (no communication
    between shards), row-band halo exchange over ``tile`` stays inside a
    host. Falls back to a single-process mesh with a unit host axis.
    """
    n_proc = jax.process_count()
    local = jax.local_device_count()
    if tile is None:
        if local % max(data, 1):
            raise ValueError(f"{local} local devices not divisible by data={data}")
        tile = local // max(data, 1)
    if data * tile != local:
        raise ValueError(f"data*tile={data * tile} != local devices {local}")

    if n_proc == 1:
        grid = np.array(jax.devices()).reshape(1, data, tile)
        return Mesh(grid, (HOST_AXIS, "data", "tile"))

    try:
        from jax.experimental import mesh_utils

        grid = mesh_utils.create_hybrid_device_mesh(
            mesh_shape=(data, tile),
            dcn_mesh_shape=(n_proc, 1),  # the leading (host) axis
            devices=jax.devices(),
        )
    except ValueError:
        # Devices without distinct slice indices (multi-process CPU or
        # GPU): group by process so the leading axis aligns with hosts.
        devs = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
        grid = np.array(devs)
    return Mesh(grid.reshape(n_proc, data, tile), (HOST_AXIS, "data", "tile"))
