"""Accuracy evaluation against synthetic ground truth.

One shared routine for the pytest gates, the scene-family sweep and
``bench.py`` — so every accuracy number in the repo is computed the same
way (the reference has no quantitative evaluation at all; its quality
evidence is visual layer inspection, SURVEY §4).
"""

from __future__ import annotations

import numpy as np

from pcmi_tpu.config import PipelineConfig
from pcmi_tpu.geometry.synthetic import SyntheticScene, aoi_lonlat_ranges
from pcmi_tpu.pipelines.height_map import HeightMapPipeline


def truth_on_grid(scene: SyntheticScene, xyz) -> tuple[np.ndarray, np.ndarray]:
    """Bilinearly sample the true terrain height at triangulated (x, y).

    Returns ``(truth, in_bounds)`` on the product grid.
    """
    ox, oy = scene.ground_origin
    terr = np.asarray(scene.terrain)
    gx = (np.asarray(xyz[..., 0]) - ox) / scene.ground_gsd
    gy = (np.asarray(xyz[..., 1]) - oy) / scene.ground_gsd
    gxc = np.clip(gx, 0, terr.shape[1] - 1)
    gyc = np.clip(gy, 0, terr.shape[0] - 1)
    x0 = np.floor(gxc).astype(int)
    y0 = np.floor(gyc).astype(int)
    x1 = np.clip(x0 + 1, 0, terr.shape[1] - 1)
    y1 = np.clip(y0 + 1, 0, terr.shape[0] - 1)
    tx = gxc - x0
    ty = gyc - y0
    t = (
        terr[y0, x0] * (1 - ty) * (1 - tx)
        + terr[y0, x1] * (1 - ty) * tx
        + terr[y1, x0] * ty * (1 - tx)
        + terr[y1, x1] * ty * tx
    )
    inb = (gx >= 0) & (gx < terr.shape[1] - 1) \
        & (gy >= 0) & (gy < terr.shape[0] - 1)
    return t, inb


def grid_truth(scene: SyntheticScene, origin: tuple[float, float],
               cell: float, shape: tuple[int, int]
               ) -> tuple[np.ndarray, np.ndarray]:
    """True terrain height at the cell centres of a DSM grid.

    Returns ``(truth, in_bounds)`` of ``shape``: the terrain sample under
    each cell centre, and whether that centre lies on the terrain.
    """
    ny, nx = shape
    terr = np.asarray(scene.terrain)
    gx = (origin[0] + (np.arange(nx) + 0.5) * cell
          - scene.ground_origin[0]) / scene.ground_gsd
    gy = (origin[1] + (np.arange(ny) + 0.5) * cell
          - scene.ground_origin[1]) / scene.ground_gsd
    gxm, gym = np.meshgrid(gx, gy)
    inb = ((gxm >= 0) & (gxm < terr.shape[1] - 1)
           & (gym >= 0) & (gym < terr.shape[0] - 1))
    truth = terr[np.clip(gym.astype(int), 0, terr.shape[0] - 1),
                 np.clip(gxm.astype(int), 0, terr.shape[1] - 1)]
    return truth, inb


def pair_observability(scene: SyntheticScene, pairs, cell: float,
                       grid_shape: tuple[int, int],
                       origin: tuple[float, float] | None = None,
                       margin_px: float = 0.0) -> np.ndarray:
    """Per-cell count of stereo pairs that image the cell centre in BOTH views.

    Evaluation-side geometry only: each DSM cell centre (at the TRUE terrain
    height) is forward-projected through every view's RPC; a pair observes
    the cell iff the projection lands inside both source images. This is the
    honest completeness denominator for fused products — an AOI bounding box
    always contains corner cells outside every acquisition footprint
    (measured: ~20 % of the d288 bbox is imaged by ZERO pairs), and counting
    those as "missing" scores geometry, not the matcher. The reference never
    evaluates completeness at all (its validity notion is per-pixel rectified
    overlap, ``members/anna/plugin.py:150-152``); the bbox-denominator number
    stays reported alongside for transparency.

    Returns an ``(ny, nx)`` int array: how many of ``pairs`` observe each
    cell. ``margin_px`` shrinks the usable image frame (e.g. matcher margins).
    """
    ny, nx = grid_shape
    ox, oy = origin if origin is not None else scene.ground_origin
    xc = ox + (np.arange(nx, dtype=np.float64) + 0.5) * cell
    yc = oy + (np.arange(ny, dtype=np.float64) + 0.5) * cell
    xm, ym = np.meshgrid(xc, yc)
    truth, _ = truth_on_grid(scene, np.stack([xm, ym, np.zeros_like(xm)], -1))
    lon, lat, _ = scene.frame.to_geodetic(xm, ym, truth)
    lon = np.asarray(lon, np.float64)
    lat = np.asarray(lat, np.float64)
    ok = []
    for v, img in enumerate(scene.images):
        h_im, w_im = img.shape[:2]
        col, row = scene.rpcs[v].project_np(lon.ravel(), lat.ravel(),
                                            np.asarray(truth,
                                                       np.float64).ravel())
        ok.append(((col >= margin_px) & (col <= w_im - 1 - margin_px)
                   & (row >= margin_px) & (row <= h_im - 1 - margin_px))
                  .reshape(ny, nx))
    return sum((ok[i] & ok[j]).astype(np.int32) for i, j in pairs)


def evaluate_pair_accuracy(scene: SyntheticScene,
                           cfg: PipelineConfig,
                           view_idx=(0, 1), stereo_cfg=None) -> dict:
    """Run the flagship pair pipeline on one scene and score it.

    Returns height RMSE / bias / completeness vs the scene's exact terrain
    (the ≤1 m RMSE north-star gate, BASELINE.json).  ``completeness`` is
    valid pixels over the observable footprint (both rectified views carry
    data) — the denominator the reference's validity logic implies
    (``plugin.py:150-152``). ``stereo_cfg`` overrides the search envelope
    sized for this pair alone, e.g. with the one a whole AOI shares.
    """
    i, j = view_idx
    pipe = HeightMapPipeline(cfg)
    geom = pipe.build_geometry(
        scene.rpcs[i], scene.rpcs[j], *aoi_lonlat_ranges(scene),
        scene.images[i].shape, scene.images[j].shape,
    )
    product = pipe.process_pair(scene.images[i], scene.images[j], geom,
                                stereo_cfg)
    valid = np.asarray(product.valid)
    truth, inb = truth_on_grid(scene, product.xyz)
    m = valid & inb
    if not m.any():
        return {"rmse_m": float("nan"), "bias_m": float("nan"),
                "completeness": 0.0, "valid_fraction": 0.0,
                "max_disp": geom and 0}
    err = np.asarray(product.height)[m] - truth[m]
    observable = (np.asarray(product.rect_left) >= 0) \
        & (np.asarray(product.rect_right) >= 0)
    return {
        "rmse_m": float(np.sqrt(np.mean(err ** 2))),
        "bias_m": float(np.mean(err)),
        "abs_p90_m": float(np.quantile(np.abs(err), 0.9)),
        "completeness": float(valid.sum() / max(observable.sum(), 1)),
        "valid_fraction": float(valid.mean()),
    }


def evaluate_fused_dsm(scene: SyntheticScene, cfg: PipelineConfig, views,
                       n_pairs: int = 8, grid_cell: float = 1.0,
                       points_per_pair: int = 1 << 16,
                       flat_grad_m: float = 2.0) -> dict:
    """Multi-date fusion accuracy: fused-DSM coverage + RMSE vs exact truth.

    The evidence behind the low-texture completeness story (VERDICT r3
    item 2): single-pair coverage on SNR~1 scenes is intentionally sparse
    (the gates trade coverage for accuracy), and the advertised multi-day
    fusion (reference ``README.md:17``) is what restores it. This fuses
    every selected pair of a multi-view scene into the robust DSM and
    scores:

    * ``completeness`` — filled cells over all truth-covered grid cells;
    * ``rmse_m`` — filled-cell height error vs cell-centre truth;
    * ``rmse_flat_m`` — the same on flat cells only (|∇truth| below
      ``flat_grad_m`` per cell — a cell straddling a building wall
      legitimately contains both roof and ground heights).
    """
    import dataclasses

    from pcmi_tpu.geometry.pairs import ImageMeta
    from pcmi_tpu.pipelines.multiday import MultiDayFusion

    metas = [ImageMeta(i, inc, az, date=20.0 * i)
             for i, (inc, az) in enumerate(views)]
    fusion = MultiDayFusion(
        cfg.replace(pairs=dataclasses.replace(cfg.pairs, n_pairs=n_pairs)))
    fused = fusion.run(
        scene.images, scene.rpcs, metas, *aoi_lonlat_ranges(scene),
        points_per_pair=points_per_pair, grid_cell=grid_cell,
    )
    dsm = np.asarray(fused.dsm)
    cell = fused.grid_cell
    tt, inb = grid_truth(scene, fused.grid_origin, cell, dsm.shape)
    filled = np.isfinite(dsm) & inb
    comp = float(filled.sum() / max(inb.sum(), 1))
    err = dsm[filled] - tt[filled]
    rmse = float(np.sqrt(np.mean(err ** 2))) if filled.any() else float("nan")
    cell_px = cell / scene.ground_gsd
    gyg, gxg = np.gradient(tt)
    flat = np.hypot(gyg, gxg) * cell_px <= flat_grad_m
    mf = filled & flat
    rmse_flat = (float(np.sqrt(np.mean((dsm[mf] - tt[mf]) ** 2)))
                 if mf.any() else float("nan"))
    return {
        "completeness": comp,
        "rmse_m": rmse,
        "rmse_flat_m": rmse_flat,
        "n_pairs": int(np.asarray(fused.icp_rmse).shape[0]),
        "cells": int(inb.sum()),
        "filled": int(filled.sum()),
    }
