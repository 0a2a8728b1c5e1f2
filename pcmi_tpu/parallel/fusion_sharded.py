"""Multi-chip DSM fusion: point blocks over the mesh, grids psum-merged.

The fusion half of the flagship (the advertised multi-day K-means
reconstruction the reference only gestures at, ``README.md:17``) scales
out additively: the streaming accumulator's running sums
(:class:`pcmi_tpu.pipelines.streaming.StreamingDSM`) are *additive*, so
band tiles fan out over every mesh axis, each device scans its local
blocks through the tile-local robust gate, and ONE ``psum`` over the mesh
merges the packed (weight, value, value²) grids. No scatter crosses a
device boundary — the collective moves exactly 3·ny·nx floats per device
regardless of point count.

Semantics are *identical* to the sequential band loop in
:class:`pcmi_tpu.pipelines.streaming.StreamingAOIPipeline`: the robust
sigma gate groups per block (band tile) in both, so the multi-device DSM
equals the single-device DSM bit-for-bit up to float addition order
(asserted by ``tests/test_fusion_sharded.py``).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P


def sharded_dsm_update(
    mesh: Mesh,
    origin: Tuple[float, float],
    cell: float,
    shape: Tuple[int, int],
    robust_sigma: float = 0.0,
    robust_rounds: int = 3,
):
    """Build a jitted ``(B,N,2),(B,N),(B,N) -> StreamingDSM`` fuser.

    ``B`` point blocks (one per band tile / pair, each ``N`` points with
    zero-weight padding) are sharded over ALL mesh axes flattened; the
    returned accumulator is replicated. ``B`` must be divisible by the
    mesh device count. The robust gate (``robust_sigma > 0``) is tile-local
    per block, exactly like the sequential streaming loop.
    """
    # lazy: pipelines.streaming imports pcmi_tpu.parallel (halo sizing), so
    # a module-level import here would be circular
    from pcmi_tpu.pipelines.streaming import StreamingDSM, dsm_update

    axes = tuple(mesh.axis_names)

    def per_shard(xy, values, weights):
        # the carry is device-varying (each shard accumulates its own
        # blocks) even though it starts from the same zeros
        zero = StreamingDSM(
            wsum=jnp.zeros(shape), vsum=jnp.zeros(shape),
            vsq=jnp.zeros(shape))
        def body(acc, blk):
            bxy, bv, bw = blk
            acc = dsm_update(acc, bxy, bv, bw, origin, cell, shape,
                             robust_sigma=robust_sigma,
                             robust_rounds=robust_rounds)
            return acc, None

        acc, _ = jax.lax.scan(body, zero, (xy, values, weights))
        return StreamingDSM(
            wsum=jax.lax.psum(acc.wsum, axes),
            vsum=jax.lax.psum(acc.vsum, axes),
            vsq=jax.lax.psum(acc.vsq, axes),
        )

    spec = P(axes)  # leading block axis split over the flattened mesh
    # check_vma=False: the scan carries inside dsm_update's segmented ops
    # start from constants (device-invariant) and become device-varying on
    # the first accumulation — semantically fine, and the closing psum
    # restores explicit replication; the static VMA checker can't see that.
    fn = jax.shard_map(per_shard, mesh=mesh,
                       in_specs=(spec, spec, spec),
                       out_specs=P(), check_vma=False)
    return jax.jit(fn)
