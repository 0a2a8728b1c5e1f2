"""Multi-chip flagship step: pairs over ``data``, row bands over ``tile``.

Two composition styles, both exercised by tests and ``dryrun_multichip``:

* :func:`sharded_disparity` — *explicit* SPMD: ``shard_map`` with halo
  exchange runs the windowed matcher on row bands; every op inside is
  local, collectives are exactly the two neighbour ``ppermute``s per array.
  This is the pattern the Pallas kernel path slots into.
* :func:`batched_pair_step` — *implicit* SPMD: ``jit`` with NamedSharding
  constraints over the full per-pair core (including its global reductions:
  robust-normalisation sorts, plane fit); XLA GSPMD inserts the collectives.

The halo must cover every windowed op's influence: census window + block
aggregation + guided-filter radius + speckle median + the (decaying)
vertical SGM recurrence. ``default_halo`` is deliberately generous; parity
tests check band-seam agreement against the single-device matcher.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from pcmi_tpu.config import StereoConfig
from pcmi_tpu.ops.stereo.matching import compute_disparity, refine_disparity
from pcmi_tpu.parallel.halo import halo_exchange_rows
from pcmi_tpu.parallel.mesh import DATA_AXIS, TILE_AXIS


def default_halo(cfg: StereoConfig) -> int:
    """Influence radius of the windowed ops, rounded up to 8 rows."""
    r = (
        cfg.census_window // 2
        + cfg.block_size
        + 2 * cfg.gf_radius * cfg.wls_passes
        + cfg.speckle_median_size
        + 16  # vertical SGM decay allowance
    )
    if getattr(cfg, "hierarchical", False):
        # the coarse half-resolution pass doubles every footprint in
        # full-resolution rows (window radii and SGM decay act at 2x scale)
        r *= 2
    return ((r + 7) // 8) * 8


def sharded_disparity(
    mesh: Mesh,
    cfg: StereoConfig,
    halo: int | None = None,
):
    """Build a jitted ``(B,H,W)x4 -> (B,H,W)x2`` sharded matcher.

    Inputs: stacked rectified left/right and validity masks, sharded
    ``P(data, tile, None)``. Output: disparity + validity, same sharding.
    """
    h = halo if halo is not None else default_halo(cfg)

    def one_pair(left, right, vl, vr):
        res = compute_disparity(left, right, vl, vr, cfg, aggregation="sgm")
        res = refine_disparity(res, left, cfg)
        return res.disparity, res.valid

    def per_shard(left, right, vl, vr):
        def single(l, r, a, b):
            le = halo_exchange_rows(l, h)
            re_ = halo_exchange_rows(r, h)
            # halo rows arriving as zeros at the canvas edges are invalid
            ve = halo_exchange_rows(a.astype(jnp.float32), h) > 0.5
            we = halo_exchange_rows(b.astype(jnp.float32), h) > 0.5
            disp, valid = one_pair(le, re_, ve, we)
            # explicit end index: [h:-h] is empty when h == 0
            return disp[h: disp.shape[0] - h], valid[h: valid.shape[0] - h]

        return jax.vmap(single)(left, right, vl, vr)

    spec = P(DATA_AXIS, TILE_AXIS, None)
    # check_vma=False: the matcher's Pallas kernel declares its outputs
    # without mesh-varying types; every output is per-band (varying) anyway
    fn = jax.shard_map(per_shard, mesh=mesh, in_specs=spec, out_specs=spec,
                       check_vma=False)
    return jax.jit(fn)


def batched_pair_step(mesh: Mesh, cfg: StereoConfig, ground_percentile=2.0):
    """GSPMD path: jit the full pair core over the mesh.

    ``rects`` is ``(B, 2, H, W)`` (left/right stacks), ``tri_M`` ``(B, 3, 4)``,
    ``tri_b`` ``(B, 4)``. Returns per-pair disparity, validity and heights,
    data-sharded over pairs and row-sharded over the canvas.
    """
    from pcmi_tpu.pipelines.height_map import pair_core

    def step(rects, tri_M, tri_b):
        def one(pair, M, b):
            out = pair_core(pair[0], pair[1], M, b, cfg,
                            ground_percentile=ground_percentile)
            return out.disparity, out.valid, out.height
        return jax.vmap(one)(rects, tri_M, tri_b)

    in_shardings = (
        NamedSharding(mesh, P(DATA_AXIS, None, TILE_AXIS, None)),
        NamedSharding(mesh, P(DATA_AXIS, None, None)),
        NamedSharding(mesh, P(DATA_AXIS, None)),
    )
    out_sharding = NamedSharding(mesh, P(DATA_AXIS, TILE_AXIS, None))
    return jax.jit(step, in_shardings=in_shardings,
                   out_shardings=(out_sharding,) * 3)
