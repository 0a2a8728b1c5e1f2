"""Halo exchange over row-band sharded images (`lax.ppermute` collectives).

The sharded equivalent of the reference's margin discipline: the reference pads
``max_disp`` columns so SGBM has search room (``add_margin``,
``processing.py:118-126``) and dilates invalid borders by 24 px
(``processing.py:35-41``). When a rectified canvas is sharded into row bands
across devices, each band needs ``halo`` rows of its neighbours for every
windowed op (census window, block aggregation, vertical SGM paths, median /
guided filters). One neighbour ``ppermute`` each way per step supplies them;
edge shards receive zeros, which downstream code treats as invalid — exactly
the canvas-border convention.

Disparity search itself is horizontal, and row bands keep full rows, so no
halo is needed along the epipolar axis — the reason this layer shards H,
not W.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from pcmi_tpu.parallel.mesh import DATA_AXIS, TILE_AXIS


def halo_exchange_rows(x: jnp.ndarray, halo: int, axis_name: str = TILE_AXIS):
    """Extend a local row band with ``halo`` rows from each neighbour.

    ``x`` is the per-device block ``(h_local, W)`` (or ``(h_local, W, C)``).
    Returns ``(h_local + 2*halo, W[, C])``. Missing neighbours (first/last
    band) contribute zeros.
    """
    if halo == 0:
        return x  # x[-0:] would be the WHOLE band, not an empty slice
    if x.shape[0] < halo:
        raise ValueError(
            f"halo ({halo}) exceeds the local row band ({x.shape[0]}); use "
            f"fewer tile shards or a taller canvas — single-hop neighbour "
            f"exchange can only supply up to one band of context"
        )
    n = jax.lax.axis_size(axis_name)
    down = [(i, i + 1) for i in range(n - 1)]   # send to next (higher) band
    up = [(i, i - 1) for i in range(1, n)]
    from_prev = jax.lax.ppermute(x[-halo:], axis_name, perm=down)
    from_next = jax.lax.ppermute(x[:halo], axis_name, perm=up)
    return jnp.concatenate([from_prev, x, from_next], axis=0)


def sharded_rows_map(
    fn: Callable,
    mesh: Mesh,
    halo: int,
):
    """Wrap ``fn(*local_arrays) -> arrays`` into a halo-exchanged shard_map.

    Every input/output is a ``(B, H, W)`` stack sharded ``(data, tile)``.
    Inside each shard: vmap over the local batch, halo-extend rows, run
    ``fn`` on the extended block, crop the halo back off. ``fn`` must be
    shape-preserving over its first two dims.
    """

    def per_shard_single(*arrays):
        extended = [halo_exchange_rows(a, halo) for a in arrays]
        out = fn(*extended)
        outs = out if isinstance(out, tuple) else (out,)
        # explicit end index: [halo:-halo] is empty when halo == 0
        cropped = tuple(o[halo: o.shape[0] - halo] for o in outs)
        return cropped if len(cropped) > 1 else cropped[0]

    def per_shard(*stacks):
        return jax.vmap(per_shard_single)(*stacks)

    # a single PartitionSpec is a valid pytree prefix: it applies to every
    # input / output leaf
    spec = P(DATA_AXIS, TILE_AXIS, None)
    return jax.shard_map(per_shard, mesh=mesh, in_specs=spec, out_specs=spec)
