"""Mesh / sharding / halo-exchange scale-out layer."""

from pcmi_tpu.parallel.mesh import (
    DATA_AXIS,
    TILE_AXIS,
    make_mesh,
    pair_sharding,
    replicated,
)
from pcmi_tpu.parallel.fusion_sharded import sharded_dsm_update
from pcmi_tpu.parallel.halo import halo_exchange_rows, sharded_rows_map
from pcmi_tpu.parallel.multihost import (
    HOST_AXIS,
    initialize as initialize_multihost,
    make_multihost_mesh,
)
from pcmi_tpu.parallel.stereo_sharded import (
    batched_pair_step,
    default_halo,
    sharded_disparity,
)

__all__ = [
    "DATA_AXIS",
    "TILE_AXIS",
    "HOST_AXIS",
    "initialize_multihost",
    "make_multihost_mesh",
    "make_mesh",
    "pair_sharding",
    "replicated",
    "sharded_dsm_update",
    "halo_exchange_rows",
    "sharded_rows_map",
    "batched_pair_step",
    "default_halo",
    "sharded_disparity",
]
