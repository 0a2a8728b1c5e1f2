"""Flagship pipeline: stereo pair → disparity → height map → 3D points.

The in-memory JAX rebuild of the reference's hot path
(``HeightMapExtractor.run``, reference ``plugin.py:36-243`` +
``disparity.py:21-226``): where the reference buses every stage through
``data/TEMP`` files and external binaries (GDAL crop → ASP rectify → OpenCV
SGBM → numpy), here a pair flows through memory as fixed-shape arrays:

  RPCs ──host──▶ affine rectification geometry (geometry.rectify)
  images ─jit─▶ rectify warp → robust normalise → census/SGM disparity →
                guided-filter refine → photoconsistency → triangulate →
                plane-relative heights

The per-pair compute core (:func:`pair_core`) is ONE jitted function whose
only static arguments are the canvas shape and the stereo config — all
per-pair geometry (triangulation operator, warp matrices) enters as arrays,
so processing N pairs of one AOI compiles exactly once.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import List, NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from pcmi_tpu.config import PipelineConfig, StereoConfig
from pcmi_tpu.geometry.rectify import (
    RectifiedGeometry,
    build_geometry_from_rpcs,
    triangulation_operator,
)
from pcmi_tpu.interface import Layer, SatellitePlugin
from pcmi_tpu.ops.morphology import binary_dilation
from pcmi_tpu.ops.normalize import normalise_image, percentile_stretch
from pcmi_tpu.ops.pointcloud import fit_plane, plane_relative_height
from pcmi_tpu.ops.stereo.matching import compute_disparity, refine_disparity

HIGHEST = jax.lax.Precision.HIGHEST


class PairProduct(NamedTuple):
    """Everything the reference emits per pair (disparity GTiff channels +
    consistency.npz + napari layers, ``disparity.py:213-224`` /
    ``plugin.py:126-233``), as in-memory arrays."""

    disparity: jnp.ndarray      # (H, W) signed px, left-rectified frame
    valid: jnp.ndarray          # (H, W) bool
    photo: jnp.ndarray          # (H, W) photoconsistency in [0, 1] (0 = good)
    xyz: jnp.ndarray            # (H, W, 3) local-frame metres
    height: jnp.ndarray         # (H, W) absolute height z (NaN where invalid)
    rel_height: jnp.ndarray     # (H, W) plane-relative, ground-zeroed (m)
    rect_left: jnp.ndarray      # (H, W) normalised rectified left image
    rect_right: jnp.ndarray     # (H, W) normalised rectified right


def required_max_disp(
    geoms: Sequence[RectifiedGeometry], h_range, margin_px: int = 16
) -> int:
    """Smallest /16 search width covering ``h_range`` for all geometries.

    Disparity is exactly ``disp_gain * (z - h_mid)`` (see
    ``RectifiedGeometry``), so the needed signed range is known in closed
    form — the reference instead hardcodes MAX_DISP=288 for every pair
    (``constants.py:54-57``) and pays the full search even when the AOI
    relief needs a fraction of it.
    """
    span = 0.0
    for g in geoms:
        half = max(abs(h_range[0] - g.h_mid), abs(h_range[1] - g.h_mid))
        span = max(span, abs(g.disp_gain) * half)
    total = 2 * (int(np.ceil(span)) + margin_px)
    return ((total + 15) // 16) * 16


# canonical warp implementation lives with the geometry; this alias keeps
# the established pipeline-internal name
from pcmi_tpu.geometry.rectify import rectify_arrays as _rectify_pair  # noqa: E402


def photoconsistency(left: jnp.ndarray, right: jnp.ndarray,
                     disparity: jnp.ndarray,
                     d_min: int = -160, d_max: int = 160,
                     stride: int = 1) -> jnp.ndarray:
    """|right(y, x - d) - left(y, x)| on normalised images — the reference's
    warp-difference map (``processing.py:94-115``).

    Gather-free: the fractional per-pixel shift is expressed as a scan
    over the static disparity range with triangle (linear-interp) weights
    ``max(0, 1 - |d - s|)`` — each step is one contiguous dynamic slice of
    the padded right image.

    ``stride > 1`` scans every stride-th shift with the triangle widened to
    that spacing — linear interpolation of the right view on a stride-px
    grid (1/stride of the passes; sub-grid sampling error only matters at
    high-frequency texture, where the residual is large either way).
    """
    h, w = left.shape
    # grid must reach past d_max so every in-range disparity has two-sided
    # triangle support; pad sized for the last (overshooting) grid point
    pad = max(abs(d_min), abs(d_max)) + stride
    rp = jnp.pad(right, ((0, 0), (pad, pad)))

    def step(acc, s):
        shifted = jax.lax.dynamic_slice_in_dim(rp, pad - s, w, axis=1)
        wgt = jnp.maximum(1.0 - jnp.abs(disparity - s) / stride, 0.0)
        return acc + wgt * shifted, None

    ds = jnp.arange(d_min, d_max + stride, stride, dtype=jnp.int32)
    r, _ = jax.lax.scan(step, jnp.zeros_like(left), ds, unroll=8)
    xs = jax.lax.broadcasted_iota(jnp.float32, (h, w), 1)
    x2 = xs - disparity
    inb = (x2 >= 0) & (x2 <= w - 1) & (disparity >= d_min) & (disparity <= d_max)
    return jnp.where(inb, jnp.abs(r - left), 1.0)


@partial(jax.jit, static_argnames=("cfg", "ground_percentile",
                                   "cap_percentile", "with_plane",
                                   "pre_normalised"))
def pair_core(
    rect1: jnp.ndarray,
    rect2: jnp.ndarray,
    tri_M: jnp.ndarray,
    tri_b: jnp.ndarray,
    cfg: StereoConfig,
    ground_percentile: float = 2.0,
    cap_percentile: float = 98.0,
    with_plane: bool = True,
    row0: jnp.ndarray | float = 0.0,
    pre_normalised: bool = False,
) -> PairProduct:
    """The jit-once per-pair compute core on the rectified canvas.

    ``row0`` offsets the triangulation row coordinates — row-band tiles of
    one canvas (streaming pipeline) triangulate in the global frame while
    sharing a single compiled executable. ``with_plane=False`` skips the
    plane fit and the full-canvas quantile sorts behind ``rel_height`` —
    the fusion pipelines consume only ``xyz``/``valid`` and shouldn't pay
    for the interactive display product. ``pre_normalised=True`` means the
    inputs already carry whole-canvas radiometric normalisation (values in
    [0, 1], invalid = -1); band tiles MUST use it so every band shares one
    radiometry instead of per-band median/MAD bounds (band-seam hazard)."""
    mask1 = rect1 >= 0
    mask2 = rect2 >= 0
    if pre_normalised:
        n1 = jnp.clip(rect1, 0.0, 1.0)
        n2 = jnp.clip(rect2, 0.0, 1.0)
    else:
        n1, _ = normalise_image(rect1, mask1, subsample=cfg.norm_subsample)
        n2, _ = normalise_image(rect2, mask2, subsample=cfg.norm_subsample)
    if cfg.presmooth_sigma > 0:
        # low-texture matchability: trade resolution for SNR (the
        # margin_undefined shrink below already covers the filter's
        # support at the footprint borders)
        from pcmi_tpu.ops.filters import gaussian_filter

        n1 = gaussian_filter(n1, sigma=cfg.presmooth_sigma)
        n2 = gaussian_filter(n2, sigma=cfg.presmooth_sigma)

    # shrink validity away from undefined borders (ref post_process_undefined,
    # processing.py:35-41: binary_dilation of the invalid region x24)
    inv1 = binary_dilation(~mask1, iterations=cfg.margin_undefined)
    inv2 = binary_dilation(~mask2, iterations=cfg.margin_undefined)
    v1 = mask1 & ~inv1
    v2 = mask2 & ~inv2

    noise_ratio = None
    if cfg.noise_adapt > 0 and cfg.gate_profile != "lr":
        from pcmi_tpu.ops.normalize import snr_ratio

        noise_ratio = snr_ratio(n1, mask1)

    if cfg.adapt_band_rows > 0:
        # per-row-band adaptive range: coarse pass -> per-row warp ->
        # narrow full-res search; disparities come back in GLOBAL
        # coordinates and photo is computed in the (equivalent) warped
        # frame — see ops.stereo.banded
        from pcmi_tpu.ops.stereo.banded import banded_disparity

        res0, res, photo, _ = banded_disparity(
            n1, n2, v1, v2, cfg, noise_ratio=noise_ratio)
    elif cfg.hierarchical:
        from pcmi_tpu.ops.stereo.hierarchical import compute_disparity_hierarchical

        res0 = compute_disparity_hierarchical(
            n1, n2, v1, v2, cfg, local_disp=cfg.hierarchical_local_disp)
        res = refine_disparity(res0, n1, cfg)
        photo = photoconsistency(
            n1, n2, res.disparity,
            d_min=cfg.min_disparity,
            d_max=cfg.min_disparity + cfg.max_disp - 1,
            stride=cfg.disp_stride,
        )
    else:
        res0 = compute_disparity(n1, n2, v1, v2, cfg, aggregation="sgm",
                                 noise_ratio=noise_ratio)
        res = refine_disparity(res0, n1, cfg)
        photo = photoconsistency(
            n1, n2, res.disparity,
            d_min=cfg.min_disparity,
            d_max=cfg.min_disparity + cfg.max_disp - 1,
            stride=cfg.disp_stride,
        )

    if cfg.gate_profile == "lr":
        # multi-date fusion profile: per-pair validity is L/R consistency
        # only — the cross-pair consistency mask downstream
        # (streaming.dsm_finalize_multi mad_max) does the blunder
        # rejection with redundancy a single pair does not have
        return _finalise_product(res, v1, mask1, mask2, n1, n2, photo,
                                 tri_M, tri_b, row0, with_plane,
                                 ground_percentile, cap_percentile)

    # Blunder gates: matching errors concentrate in foreground-fattening /
    # occlusion bands around disparity discontinuities (the failure mode the
    # reference attacks with 4 WLS passes + two LRC thresholds,
    # ``disparity.py:129-161``). Gate on (a) deviation from the local median
    # (speckle), (b) distance to a disparity discontinuity (band), and
    # (c) photoconsistency. Fusion refills the bands from other pairs.
    from pcmi_tpu.ops.filters import separable_median_filter
    med = separable_median_filter(res.disparity, cfg.speckle_median_size)
    speckle_ok = jnp.abs(res.disparity - med) <= cfg.speckle_threshold
    gy, gx = jnp.gradient(med)
    edge = jnp.hypot(gy, gx) > cfg.edge_grad_threshold
    band = binary_dilation(edge, iterations=cfg.edge_dilation)
    # Noise-adaptive photoconsistency bound: on noisy / cross-date imagery
    # even perfect matches carry a residual ~ the noise floor, so the fixed
    # threshold is treated as a floor and scaled to the median residual of
    # the LR-consistent population (blunders are the minority there).
    photo_thresh = jnp.float32(cfg.photo_threshold)
    if cfg.photo_adapt_factor > 0:
        from pcmi_tpu.ops.normalize import masked_median_grid
        # one-pass FULL-RES grid quantile: the residual range is known
        # ([0, ~2] on normalised imagery), so one fused compare-and-count
        # pass over every pixel replaces a full-canvas sort
        floor = masked_median_grid(photo, res.valid & v1, 0.0, 2.0)
        photo_thresh = jnp.maximum(photo_thresh,
                                   cfg.photo_adapt_factor * floor)
    photo_ok = photo < photo_thresh
    # Global uniqueness gate: reject flat/bimodal cost curves (bland or
    # repetitive texture) whose WTA is a coin flip the smoothness term then
    # propagates — the dominant blunder source on low-texture scenes.
    unique_ok = res0.margin > cfg.min_margin
    gated_valid = res.valid & speckle_ok & ~band & photo_ok & unique_ok

    # Band recovery (densification): the edge-band gate above discards a
    # ~2·edge_dilation-px strip around every disparity discontinuity —
    # roughly a quarter of the observable frame on built-up scenes. Most of
    # those matches are fine; only foreground-fattening / occlusion blunders
    # are not. Re-admit band pixels that pass three INDEPENDENT checks:
    # (a) sub-pixel agreement with the small-window no-SGM cross-matcher
    #     (uncorrelated fattening radius and smoothness bias),
    # (b) WTA cost-uniqueness margin (fattened pixels sit on flat/bimodal
    #     cost curves), and
    # (c) a tightened photoconsistency bound.
    # Pre-refinement validity (res0) is required so only pixels whose
    # disparity came from actual matching — not guided-filter infill — are
    # recovered. The reference reaches the same goal via its second WLS
    # densification pass (``disparity.py:129-155``).
    if cfg.band_recover and res0.check_disparity is not None:
        agree_thr = jnp.float32(cfg.band_agree_threshold_eff)
        band_margin = jnp.float32(cfg.band_margin_threshold)
        if cfg.noise_adapt > 0 and noise_ratio is not None:
            # Noise-adaptive recovery (calibrated on the scene families):
            # widen the agree slack as the SNR proxy rises (checker
            # quantisation noise grows with image noise), and ramp the
            # margin bar up steeply as the ratio approaches 1 — at
            # per-pixel SNR ~ 1 (bland surfaces) recovery evidence is
            # untrustworthy and only the strict gated lane should pass.
            r01 = jnp.clip((noise_ratio - 0.5) / 0.5, 0.0, 1.0)
            agree_thr = agree_thr + (cfg.noise_adapt
                                     * cfg.noise_agree_widen * r01)
            band_margin = band_margin + (
                cfg.noise_adapt * cfg.noise_margin_ramp
                * jnp.clip((noise_ratio - 0.8) / 0.2, 0.0, 1.0))
        agree = (jnp.abs(res.disparity - res0.check_disparity) <= agree_thr)
        band_keep = (
            res0.valid & speckle_ok & photo_ok & band & agree
            & (res0.margin > band_margin)
            & (photo < cfg.band_photo_factor * photo_thresh)
        )
        if res0.check_margin is not None and cfg.band_check_margin > 0:
            band_keep = band_keep & (res0.check_margin
                                     > cfg.band_check_margin)
        if cfg.band_core_excl > 0:
            # mixed (anti-aliased) pixels on the depth-edge line itself
            # triangulate to intermediate heights while passing every
            # consistency check — exclude the thin edge core outright
            band_keep = band_keep & ~binary_dilation(
                edge, iterations=cfg.band_core_excl)
        gated_valid = gated_valid | band_keep
    res = res._replace(valid=gated_valid)
    return _finalise_product(res, v1, mask1, mask2, n1, n2, photo,
                             tri_M, tri_b, row0, with_plane,
                             ground_percentile, cap_percentile)


def _finalise_product(res, v1, mask1, mask2, n1, n2, photo, tri_M, tri_b,
                      row0, with_plane, ground_percentile, cap_percentile):
    """Triangulation + plane-relative heights + product assembly (the
    shared tail of both gate profiles of :func:`pair_core`)."""
    # triangulate via the shared geometry operator
    from pcmi_tpu.geometry.rectify import triangulate_from_operator

    xyz = triangulate_from_operator(res.disparity, tri_M, tri_b, row0=row0)

    valid = res.valid & v1
    height = jnp.where(valid, xyz[..., 2], jnp.nan)

    # SVD plane fit -> relative heights, ground at the low percentile,
    # capped at the high percentile (ref plugin.py:156-191: 2-98 pct
    # normalisation with ground zeroed at the 2nd percentile)
    if with_plane:
        plane = fit_plane(xyz, valid.astype(jnp.float32))
        rel = plane_relative_height(xyz, plane)
        # two-stage grid quantiles (64² effective bins) instead of the
        # full-canvas sort _masked_quantile pays; the display clip
        # tolerates far coarser resolution than that
        from pcmi_tpu.ops.normalize import masked_quantile_grid
        rlo = jnp.min(jnp.where(valid, rel, jnp.inf))
        rhi = jnp.max(jnp.where(valid, rel, -jnp.inf))
        rlo = jnp.where(jnp.isfinite(rlo), rlo, 0.0)
        rhi = jnp.where(jnp.isfinite(rhi), jnp.maximum(rhi, rlo + 1e-6), 1.0)
        q0 = masked_quantile_grid(rel, valid, rlo, rhi,
                                  ground_percentile / 100.0)
        q1 = masked_quantile_grid(rel, valid, rlo, rhi,
                                  cap_percentile / 100.0)
        rel = jnp.clip(rel - q0, None, q1 - q0)
        rel = jnp.where(valid, rel, jnp.nan)
    else:
        rel = jnp.full_like(height, jnp.nan)

    return PairProduct(
        disparity=res.disparity, valid=valid, photo=photo, xyz=xyz,
        height=height, rel_height=rel,
        # keep the reference's undefined sentinel (-1) in the emitted
        # rectified views so consumers can recover the observable footprint
        rect_left=jnp.where(mask1, n1, -1.0),
        rect_right=jnp.where(mask2, n2, -1.0),
    )


class HeightMapPipeline:
    """Host orchestration: geometry on host, compute under one jit.

    Replaces the reference's crop→ASP→SGBM→WLS file bus
    (``plugin.py:81-124``). ``process_pair`` handles one stereo pair;
    :class:`pcmi_tpu.pipelines.multiday.MultiDayFusion` runs many and fuses.
    """

    def __init__(self, cfg: PipelineConfig = PipelineConfig()):
        self.cfg = cfg

    def build_geometry(self, rpc1, rpc2, lon_range, lat_range,
                       shape1, shape2) -> RectifiedGeometry:
        return build_geometry_from_rpcs(
            rpc1, rpc2, lon_range, lat_range, self.cfg.rectify.height_range,
            shape1, shape2, grid=self.cfg.rectify.probe_grid,
            pad_multiple=self.cfg.tiling.pad_multiple,
        )

    def stereo_cfg_for(self, geoms: Sequence[RectifiedGeometry]) -> StereoConfig:
        """Stereo config with the search range sized to the geometry.

        With ``cfg.metric_gates``, the pixel-denominated blunder-gate
        thresholds are derived from the physical ones via the actual
        disparity gain — at 5+ px/m (steep convergence / fine GSD) the
        pixel defaults would misread ordinary slopes as discontinuities.
        """
        md = required_max_disp(geoms, self.cfg.rectify.height_range)
        updates = dict(max_disp=md)
        if self.cfg.metric_gates and geoms:
            gain = max(abs(g.disp_gain) for g in geoms)
            # Quantise the derived thresholds (5% log steps): StereoConfig
            # is a STATIC jit argument, so every distinct float forces a
            # full pair_core recompile — nearby geometries (different pair
            # subsets of one AOI) must land on the identical config to
            # share one compiled executable. A <5% threshold shift is far
            # inside the gates' tuning slack.
            def _q(x: float) -> float:
                import math
                return float(round(1.05 ** round(math.log(max(x, 1e-6))
                                                 / math.log(1.05)), 4))

            updates["speckle_threshold"] = _q(self.cfg.speckle_threshold_m * gain)
            updates["edge_grad_threshold"] = _q(self.cfg.edge_step_m * gain)
            # invalidated band half-width = the matcher's fattening radius,
            # set by the aggregation footprint (block + census support), not
            # by the geometry; measured halo ≈ block_size + 5 px
            updates["edge_dilation"] = self.cfg.stereo.block_size + 5
        return dataclasses.replace(self.cfg.stereo, **updates)

    def process_pair(
        self,
        img1: jnp.ndarray,
        img2: jnp.ndarray,
        geom: RectifiedGeometry,
        stereo_cfg: Optional[StereoConfig] = None,
        cache=None,
        with_plane: bool = True,
    ) -> PairProduct:
        """``cache`` (a :class:`pcmi_tpu.utils.cache.StageCache`) resumes a
        crashed/repeated run: identical inputs + config hit the stored pair
        product instead of recomputing (the working version of the
        reference's never-read CACHE_DISPARITY flag, ``constants.py:41``)."""
        cfg = stereo_cfg or self.stereo_cfg_for([geom])
        r1, r2 = _rectify_pair(
            jnp.asarray(img1), jnp.asarray(img2),
            jnp.asarray(geom.H1, jnp.float32), jnp.asarray(geom.H2, jnp.float32),
            geom.out_shape,
        )
        M, b = triangulation_operator(geom)

        kwargs = dict(
            ground_percentile=self.cfg.height_percentiles[0],
            cap_percentile=self.cfg.height_percentiles[1],
            with_plane=with_plane,
        )

        def compute():
            out = pair_core(r1, r2, M, b, cfg, **kwargs)
            return {k: np.asarray(v) for k, v in out._asdict().items()}

        if cache is None:
            return pair_core(r1, r2, M, b, cfg, **kwargs)
        got = cache.get_or_compute(
            "pair_core", (repr(cfg), repr(sorted(kwargs.items())),
                          np.asarray(r1), np.asarray(r2),
                          np.asarray(M), np.asarray(b)),
            compute,
        )
        return PairProduct(**{k: jnp.asarray(v) for k, v in got.items()})


def product_point_cloud(
    product: PairProduct, max_points: int = 1 << 18, key=None
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Flatten a pair product into fixed-size (N, 3) points + validity weights.

    Invalid pixels stay in the batch with weight 0 (static shapes under jit);
    when the frame has more valid pixels than ``max_points``, a uniform
    random subset is kept (weighted Gumbel top-k, no host roundtrip).
    """
    xyz = product.xyz.reshape(-1, 3)
    w = product.valid.reshape(-1).astype(jnp.float32)
    n = xyz.shape[0]
    if n <= max_points:
        return xyz, w
    if key is None:
        key = jax.random.PRNGKey(0)
    score = jnp.log(jnp.maximum(w, 1e-12)) + jax.random.gumbel(key, (n,))
    _, idx = jax.lax.top_k(score, max_points)
    return xyz[idx], w[idx]


class HeightMapExtractor(SatellitePlugin):
    """Plugin adapter: emits the reference's layer set
    (``plugin.py:199-233``) — disparity (turbo), photoconsistency,
    invalid-mask overlay, and a [z, y, x] points layer coloured by height."""

    def __init__(self, pipeline: HeightMapPipeline | None = None):
        self.pipeline = pipeline or HeightMapPipeline()
        self._sources = None

    @property
    def name(self) -> str:
        return "Multi-day 3D Point Cloud"

    def set_sources(self, images, rpcs, lon_range, lat_range):
        """Attach the acquisition stack (replaces the reference's disk scan
        of ``data/rafael/WV3/PAN/*.ntf``, ``pair_selector.py:47-69``)."""
        self._sources = (list(images), list(rpcs), lon_range, lat_range)

    def run(self, image=None, viewer=None, pair=None, metas=None,
            mode: str = "first", n: int = 1, seed: int = 0) -> List[Layer]:
        """Run one or more pairs and emit their layers.

        Modes mirror the reference widget's options (``plugin.py:63-70``):
        ``"first"`` takes the best-``n`` selected pairs, ``"random"`` one
        random valid pair, ``"pair"`` an explicit ``pair=(i, j)``. When
        ``metas`` (list of :class:`ImageMeta`) is given, pairs come from the
        convergence-angle selector; otherwise consecutive indices are used.
        """
        if self._sources is None:
            raise RuntimeError("call set_sources(...) before run()")
        images, rpcs, lon_range, lat_range = self._sources

        if pair is not None:
            chosen = [tuple(pair)]
        elif metas is not None:
            from pcmi_tpu.geometry.pairs import select_pairs, take_pairs

            ranked = select_pairs(metas, self.pipeline.cfg.pairs)
            if mode == "random":
                # sample from ALL valid pairs, not the best-n slice
                import random

                valid = [p for p in ranked if p.valid]
                cands = [random.Random(seed).choice(valid)] if valid else []
            else:
                cands = take_pairs(ranked, max(n, 1))
            chosen = [(p.i, p.j) for p in cands]
        else:
            chosen = [(k, k + 1) for k in range(min(n, len(images) - 1))]
        if not chosen:
            raise ValueError("no stereo pairs to process")

        geoms = [
            self.pipeline.build_geometry(
                rpcs[i], rpcs[j], lon_range, lat_range,
                images[i].shape, images[j].shape,
            )
            for i, j in chosen
        ]
        # one stereo config across all chosen pairs: per-pair configs are
        # static jit args and would force a recompile per pair
        stereo_cfg = self.pipeline.stereo_cfg_for(geoms)
        layers: List[Layer] = []
        for (i, j), geom in zip(chosen, geoms):
            product = self.pipeline.process_pair(images[i], images[j], geom,
                                                 stereo_cfg)
            layers.extend(self._product_layers(product, tag=f"{i}-{j}"))
        return layers

    def _product_layers(self, product: PairProduct, tag: str = "") -> List[Layer]:
        suffix = f" [{tag}]" if tag else ""

        disparity = np.asarray(product.disparity)
        valid = np.asarray(product.valid)
        photo = np.asarray(product.photo)
        rel = np.asarray(product.rel_height)

        layers: List[Layer] = [
            (np.where(valid, disparity, np.nan),
             {"name": f"disparity{suffix}", "colormap": "turbo"}, "image"),
            (photo, {"name": f"photoconsistency{suffix}", "colormap": "gray"},
             "image"),
            ((~valid).astype(np.uint8),
             {"name": f"invalid mask{suffix}", "opacity": 0.4}, "image"),
        ]
        ys, xs = np.nonzero(valid)
        if len(ys):
            step = max(1, len(ys) // 200_000)
            ys, xs = ys[::step], xs[::step]
            pts = np.stack([rel[ys, xs], ys, xs], axis=1)
            layers.append(
                (pts, {
                    "name": f"point cloud{suffix}",
                    "features": {"height": rel[ys, xs]},
                    "size": 1,
                }, "points")
            )
        return layers
