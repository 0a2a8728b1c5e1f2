"""Device mesh construction for pjit/shard_map scale-out.

The reference has no distributed runtime at all (SURVEY §2.8) — its scale
strategy is ad-hoc spatial tiling inside one process. Here scale-out is a
first-class ``jax.sharding.Mesh`` with two axes:

* ``data`` — stereo pairs / acquisition dates (embarrassingly parallel),
* ``tile`` — spatial row-bands of one rectified canvas, coupled through
  halo exchange (:mod:`pcmi_tpu.parallel.halo`).

The mesh follows the algorithm: ``tile`` carries the halo ``ppermute``
traffic between neighbouring bands, ``data`` carries none (pairs never
communicate), so ``data`` is the axis to stretch across hosts.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"
TILE_AXIS = "tile"


def make_mesh(
    data: int = 1,
    tile: Optional[int] = None,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Build a (data, tile) mesh. ``tile=None`` uses all remaining devices."""
    devs = list(devices if devices is not None else jax.devices())
    if tile is None:
        if len(devs) % data:
            raise ValueError(f"{len(devs)} devices not divisible by data={data}")
        tile = len(devs) // data
    n = data * tile
    if n > len(devs):
        raise ValueError(f"mesh {data}x{tile} needs {n} devices, have {len(devs)}")
    grid = np.array(devs[:n]).reshape(data, tile)
    return Mesh(grid, (DATA_AXIS, TILE_AXIS))


def pair_sharding(mesh: Mesh) -> NamedSharding:
    """(B, H, W) stacks: pairs over ``data``, rows over ``tile``."""
    return NamedSharding(mesh, P(DATA_AXIS, TILE_AXIS, None))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
