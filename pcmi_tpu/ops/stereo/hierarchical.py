"""Coarse-to-fine dense matching: full search at half resolution, local
residual search at full resolution.

The reference pays the full ``MAX_DISP=288`` SGBM search at every pixel
(``constants.py:54-57``). The pyramid form cuts the dominant cost-volume
and SGM work ~5x at that scale: a complete (signed) search on the 2x
downsampled pair fixes a smooth base disparity; the full-resolution pass
only refines a small symmetric residual window around the base after
warping the right image by it — all static shapes, one extra gather (the
base warp) total.

Validity: the coarse pass contributes its L/R-consistency verdict
(occlusions are low-frequency); the fine pass contributes its own local
L/R check in warped space plus the usual downstream gates (speckle /
edge-band / photoconsistency in ``pair_core``). The composed disparity is
``base + local``; the right-view disparity for downstream rechecks is
resampled from the composed field.

Trade-off on the D=288 synthetic scene: it does less than half the work,
but the base warp stretches texture across disparity discontinuities and
the half-res pass bakes in blunders the local window cannot undo — it
misses the ≤1 m gate on built-up scenes, which is why full search stays
the default
(``StereoConfig.hierarchical=False``). Use it where relief is smooth or
metre-level absolute accuracy is not the driver.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from pcmi_tpu.config import StereoConfig
from pcmi_tpu.ops.filters import separable_median_filter
from pcmi_tpu.ops.stereo.matching import (
    DisparityResult,
    compute_disparity,
    refine_disparity,
    _scan_unroll,
)


def _down2(img: jnp.ndarray) -> jnp.ndarray:
    h, w = img.shape
    return img[: h // 2 * 2, : w // 2 * 2].reshape(h // 2, 2, w // 2, 2).mean((1, 3))


def _up2(img: jnp.ndarray, shape) -> jnp.ndarray:
    return jax.image.resize(img, shape, method="linear")


def _warp_right_by(right: jnp.ndarray, base: jnp.ndarray,
                   d_min: int, d_max: int) -> jnp.ndarray:
    """right_w(y, x) = right(y, x - base(y, x)) via the static shift-scan
    (triangle-weight linear interp; no per-pixel gathers)."""
    h, w = right.shape
    pad = max(abs(d_min), abs(d_max)) + 1
    rp = jnp.pad(right, ((0, 0), (pad, pad)))

    def step(acc, s):
        shifted = jax.lax.dynamic_slice_in_dim(rp, pad - s, w, axis=1)
        wgt = jnp.maximum(1.0 - jnp.abs(base - s), 0.0)
        return acc + wgt * shifted, None

    ds = jnp.arange(d_min, d_max + 1, dtype=jnp.int32)
    out, _ = jax.lax.scan(step, jnp.zeros_like(right), ds,
                          unroll=_scan_unroll())
    return out


def _resample_right_disp(disp: jnp.ndarray, d_min: int, d_max: int):
    """d_R(y, x) = d_L(y, x + d_R) ≈ scatter of d_L: use the select-scan
    d_R(x) = sum_s [round(d_L(x+s)) == s] * d_L(x+s)."""
    h, w = disp.shape
    pad = max(abs(d_min), abs(d_max)) + 1
    dp = jnp.pad(disp, ((0, 0), (pad, pad)))
    d_round = jnp.round(dp)

    def step(acc, s):
        shifted = jax.lax.dynamic_slice_in_dim(dp, pad + s, w, axis=1)
        sr = jax.lax.dynamic_slice_in_dim(d_round, pad + s, w, axis=1)
        hit = sr == s
        val, got = acc
        val = jnp.where(hit & ~got, shifted, val)
        return (val, got | hit), None

    ds = jnp.arange(d_min, d_max + 1, dtype=jnp.int32)
    (val, got), _ = jax.lax.scan(
        step, (jnp.zeros_like(disp), jnp.zeros_like(disp, bool)), ds,
        unroll=_scan_unroll())
    return jnp.where(got, val, 0.0), got


@partial(jax.jit, static_argnames=("cfg", "local_disp"))
def compute_disparity_hierarchical(
    left: jnp.ndarray,
    right: jnp.ndarray,
    valid_l: jnp.ndarray,
    valid_r: jnp.ndarray,
    cfg: StereoConfig,
    local_disp: int = 16,
) -> DisparityResult:
    """Two-level matcher; same interface as :func:`compute_disparity`."""
    left = left.astype(jnp.float32)
    right = right.astype(jnp.float32)
    h, w = left.shape

    # --- coarse full-range pass at half resolution ---
    cfg_c = dataclasses.replace(
        cfg,
        max_disp=max(16, cfg.max_disp // 2),
        block_size=max(5, cfg.block_size // 2 | 1),
        census_window=min(cfg.census_window, 5),
        gf_radius=max(2, cfg.gf_radius // 2),
        speckle_median_size=max(5, cfg.speckle_median_size // 2 | 1),
    )
    lc, rc = _down2(left), _down2(right)
    vlc = _down2(valid_l.astype(jnp.float32)) > 0.5
    vrc = _down2(valid_r.astype(jnp.float32)) > 0.5
    res_c = compute_disparity(lc, rc, vlc, vrc, cfg_c, aggregation="sgm")
    res_c = refine_disparity(res_c, lc, cfg_c)

    base = separable_median_filter(res_c.disparity, 5) * 2.0
    base = _up2(base, (h, w))
    base_valid = _up2(res_c.valid.astype(jnp.float32), (h, w)) > 0.5

    # --- fine local pass around the warped base ---
    d_min = cfg.min_disparity
    d_max = cfg.min_disparity + cfg.max_disp - 1
    base = jnp.clip(base, d_min + local_disp // 2, d_max - local_disp // 2)
    right_w = _warp_right_by(right, base, d_min, d_max)
    # the warped image's validity is valid_r warped by the same base — the
    # raw mask would misalign by up to the full base disparity at borders
    valid_rw = _warp_right_by(valid_r.astype(jnp.float32), base,
                              d_min, d_max) > 0.99
    cfg_f = dataclasses.replace(cfg, max_disp=local_disp)
    res_f = compute_disparity(left, right_w, valid_l, valid_rw, cfg_f,
                              aggregation="sgm")

    disp = base + res_f.disparity
    valid = res_f.valid & base_valid
    disp_r, got = _resample_right_disp(disp, d_min, d_max)
    # unmatched right cells get an OUT-OF-RANGE sentinel: 0.0 is a legal
    # disparity and would spuriously pass downstream L/R rechecks
    return DisparityResult(
        disparity=disp,
        valid=valid,
        cost=res_f.cost,
        disparity_right=jnp.where(got, disp_r, jnp.float32(1e9)),
        # uniqueness / cross-check come from the fine local pass (the base
        # is shared, so |disp − check| reduces to the fine-pass residual)
        margin=res_f.margin,
        check_disparity=(None if res_f.check_disparity is None
                         else base + res_f.check_disparity),
    )
