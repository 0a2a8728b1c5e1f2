"""Radiometric normalization ops (jittable).

Replaces the reference's robust median/MAD normalization
(``members/rafael/disparity/processing.py:21-33``) and the 2–98 percentile
band stretch duplicated across members (``viewer.py:76-91``,
``members/marcin/utils.py:7-40``, ``members/jasraj/*/core.py``).

All functions take a validity mask rather than relying on negative-sentinel
poisoning; the sentinel convention of the reference (undefined = -1) is
supported at the boundary via ``mask = img >= 0``.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


def _masked_quantile(x: jnp.ndarray, mask: jnp.ndarray, q: jnp.ndarray) -> jnp.ndarray:
    """Quantiles of ``x[mask]`` without dynamic shapes.

    Invalid entries are pushed to +inf, the array is sorted once, and the
    quantile index is scaled by the valid count. ``q`` may be a vector.
    """
    flat = jnp.where(mask.reshape(-1), x.reshape(-1), jnp.inf)
    order = jnp.sort(flat)
    n_valid = jnp.maximum(jnp.sum(mask), 1)
    idx = jnp.clip((q * (n_valid - 1)).astype(jnp.int32), 0, flat.size - 1)
    return order[idx]


def robust_bounds(img: jnp.ndarray, mask: jnp.ndarray, nb: float = 8.0,
                  subsample: int = 1):
    """Median ± nb·MAD bounds over valid pixels.

    Parity with reference ``normalise_image`` (``processing.py:21-33``):
    ``med = median(values); mad = median(|values - med|);``
    bounds ``[med - nb*mad, med + nb*mad]`` with ``nb = 8``.

    ``subsample > 1`` estimates both medians on a strided grid (2D inputs
    only): the median of a megapixel image is statistically indistinguishable
    from the median of its every-s-th-pixel grid, while the full-array sort
    XLA emits for the exact quantile dominates the whole normalisation cost.
    """
    def _med_mad(im, mk):
        med = _masked_quantile(im, mk, jnp.asarray(0.5))
        mad = _masked_quantile(jnp.abs(im - med), mk, jnp.asarray(0.5))
        return med, mad

    def _med_mad_grid(im, mk):
        # data range from two fused reductions, then two-stage 64-bin grid
        # medians instead of the sort the exact path pays; two refining
        # passes give 64² effective bins, far inside the x8 MAD slack of
        # the bounds. Runs at full resolution.
        lo = jnp.min(jnp.where(mk, im, jnp.inf))
        hi = jnp.max(jnp.where(mk, im, -jnp.inf))
        lo = jnp.where(jnp.isfinite(lo), lo, 0.0)
        hi = jnp.where(jnp.isfinite(hi), hi, 1.0)
        med = masked_quantile_grid(im, mk, lo, hi, 0.5, bins=64, stages=2)
        mad = masked_quantile_grid(jnp.abs(im - med), mk, 0.0, hi - lo,
                                   0.5, bins=64, stages=2)
        return med, mad

    if subsample > 1 and img.ndim == 2:
        med, mad = _med_mad_grid(img, mask)
    else:
        med, mad = _med_mad(img, mask)
    lo = med - nb * mad
    hi = med + nb * mad
    return lo, hi


@partial(jax.jit, static_argnames=("nb", "subsample"))
def normalise_image(img: jnp.ndarray, mask: jnp.ndarray | None = None,
                    nb: float = 8.0, subsample: int = 1):
    """Robust [0, 1] normalization over valid pixels.

    Returns ``(normalised, mask)``. Matches reference ``normalise_image``
    (``processing.py:21-33``) which clips to median±8·MAD, rescales to [0,1]
    and re-poisons undefined pixels; here the mask is carried explicitly.
    ``subsample`` is forwarded to :func:`robust_bounds` (hot paths use a
    strided median estimate; default 1 = exact reference parity).
    """
    img = img.astype(jnp.float32)
    if mask is None:
        mask = img >= 0
    lo, hi = robust_bounds(img, mask, nb, subsample=subsample)
    scale = jnp.where(hi > lo, 1.0 / (hi - lo), 0.0)
    out = jnp.clip((img - lo) * scale, 0.0, 1.0)
    out = jnp.where(mask, out, 0.0)
    return out, mask


@partial(jax.jit, static_argnames=("p_lo", "p_hi"))
def percentile_stretch(
    img: jnp.ndarray,
    mask: jnp.ndarray | None = None,
    p_lo: float = 2.0,
    p_hi: float = 98.0,
):
    """2–98 percentile contrast stretch to [0, 1].

    Parity with the reference's ubiquitous ``normalize_band``
    (``viewer.py:76-91``, ``members/marcin/utils.py:7-40``).
    """
    img = img.astype(jnp.float32)
    if mask is None:
        mask = jnp.isfinite(img)
    img = jnp.where(mask, img, 0.0)
    qs = _masked_quantile(img, mask, jnp.asarray([p_lo / 100.0, p_hi / 100.0]))
    lo, hi = qs[0], qs[1]
    scale = jnp.where(hi > lo, 1.0 / (hi - lo), 0.0)
    out = jnp.clip((img - lo) * scale, 0.0, 1.0)
    return jnp.where(mask, out, 0.0)


def to_uint8(img01: jnp.ndarray) -> jnp.ndarray:
    """[0,1] float -> uint8, the boundary convention for display layers."""
    return jnp.clip(img01 * 255.0, 0, 255).astype(jnp.uint8)


def snr_ratio(img: jnp.ndarray, mask: jnp.ndarray,
              subsample: int = 4) -> jnp.ndarray:
    """Per-scene noise/signal ratio (traced scalar) on normalised imagery.

    Noise: Immerkaer's 2-D Laplacian residual estimator — the median of
    ``|4f - N4 sum|`` over interior valid pixels, scaled to a Gaussian
    sigma (1.4826 / sqrt(20)). Signal: the median high-pass amplitude
    ``|f - G_sigma2(f)|`` over valid pixels. Both medians run on a
    ``subsample``-strided grid (statistically identical, sort-cost ÷ s²).

    Calibrated on the synthetic scene families: clean imagery ~0.5, strong
    cross-date radiometric drift ~0.7, 4x sensor noise ~0.75, low-texture
    (per-pixel SNR ~ 1) ~1.0. Drives the noise-adaptive recovery knobs in
    :func:`pcmi_tpu.ops.stereo.matching.compute_disparity` and
    ``pair_core`` (see ``StereoConfig.noise_adapt``).
    """
    from pcmi_tpu.ops.filters import gaussian_filter

    f = img.astype(jnp.float32)
    lap = (4.0 * f[1:-1, 1:-1] - f[:-2, 1:-1] - f[2:, 1:-1]
           - f[1:-1, :-2] - f[1:-1, 2:])
    m4 = (mask[1:-1, 1:-1] & mask[:-2, 1:-1] & mask[2:, 1:-1]
          & mask[1:-1, :-2] & mask[1:-1, 2:])
    del subsample  # kept for API stability; full-res is the fast form
    # one-pass FULL-RESOLUTION grid medians: a fused compare-and-count
    # pass over every pixel instead of a sort (see masked_median_grid)
    noise = masked_median_grid(jnp.abs(lap), m4,
                               0.0, 8.0) * (1.4826 / jnp.sqrt(20.0))
    hp = jnp.abs(f - gaussian_filter(f, sigma=2.0))
    signal = masked_median_grid(hp, mask, 0.0, 2.0)
    return noise / jnp.maximum(signal, 1e-6)


@partial(jax.jit, static_argnames=("bins", "stages"))
def masked_quantile_grid(x: jnp.ndarray, mask: jnp.ndarray,
                         lo, hi, q=0.5, bins: int = 64,
                         stages: int = 2) -> jnp.ndarray:
    """Approximate q-quantile of ``x[mask]`` via ``stages`` fused passes.

    Each pass counts elements under ``bins`` linearly spaced thresholds
    over the current bracket in ONE compare-and-reduce kernel (the
    :func:`masked_median_grid` trick), then narrows the bracket to the
    bin where the cumulative count crosses ``q * n_valid``. Effective
    resolution is ``(hi - lo) / bins**stages`` — at the defaults that is
    4096 equivalent bins for the cost of two fused passes. Bins stay at
    64 per pass because past that XLA may stop fusing the broadcast
    compare into the reduce and materialise the [N, bins] intermediate.
    """
    xf = x.reshape(-1)
    mf = mask.reshape(-1)
    lo = jnp.asarray(lo, jnp.float32)
    hi = jnp.asarray(hi, jnp.float32)
    n = jnp.maximum(jnp.sum(mf, dtype=jnp.float32), 1.0)
    target = jnp.asarray(q, jnp.float32) * n
    j = jnp.arange(bins, dtype=jnp.float32) / (bins - 1)
    c_lo = jnp.float32(0.0)  # cumulative count at the current lo
    c_hi = n                 # cumulative count at the current hi
    for _ in range(stages):
        ts = lo + (hi - lo) * j
        counts = jnp.sum((xf[:, None] <= ts[None, :]) & mf[:, None],
                         axis=0, dtype=jnp.float32)
        reach = counts >= target
        idx = jnp.argmax(reach)  # first crossing (counts are monotone)
        i0 = jnp.maximum(idx - 1, 0)
        any_reach = jnp.any(reach)
        t0 = jnp.where(idx == 0, lo, ts[i0])
        c0 = jnp.where(idx == 0, c_lo, counts[i0])
        t1 = jnp.where(any_reach, ts[idx], hi)
        c1 = jnp.where(any_reach, counts[idx], c_hi)
        lo, hi, c_lo, c_hi = t0, t1, c0, c1
    frac = jnp.where(c_hi > c_lo,
                     (target - c_lo) / jnp.maximum(c_hi - c_lo, 1e-6), 0.0)
    return lo + jnp.clip(frac, 0.0, 1.0) * (hi - lo)


@partial(jax.jit, static_argnames=("bins", "geometric"))
def masked_median_grid(x: jnp.ndarray, mask: jnp.ndarray,
                       lo, hi, bins: int = 64,
                       geometric: bool = True) -> jnp.ndarray:
    """Approximate median of ``x[mask]`` in ONE fused device pass.

    Counts elements under each of ``bins`` candidate thresholds spanning
    [lo, hi] simultaneously (one compare-and-reduce kernel), then
    interpolates the crossing linearly: one streaming pass instead of a
    ``jnp.sort`` or a sequential bisection loop of small kernels.

    ``geometric`` spaces the thresholds logarithmically over
    [hi/2^12, hi] — the right grid for non-negative, scale-free
    quantities (photo residuals, Laplacian noise) whose median can sit
    orders of magnitude below the range cap; linear spacing suits
    bounded-range data with a known bracket (``lo`` is ignored for the
    geometric grid, which always starts at hi/2^12).
    Accuracy: a few % relative (geometric) / (hi-lo)/bins absolute
    (linear) — far inside the slack of any threshold derived from it.
    """
    xf = x.reshape(-1)
    mf = mask.reshape(-1)
    hi = jnp.asarray(hi, jnp.float32)
    lo = jnp.asarray(lo, jnp.float32)
    j = jnp.arange(bins, dtype=jnp.float32)
    if geometric:
        ts = hi * jnp.exp2(-12.0 * (1.0 - j / (bins - 1)))
    else:
        ts = lo + (hi - lo) * j / (bins - 1)
    counts = jnp.sum(
        (xf[:, None] <= ts[None, :]) & mf[:, None], axis=0,
        dtype=jnp.float32)
    n = jnp.maximum(counts[-1], 1.0)  # ts[-1] = hi >= all masked values
    target = 0.5 * n
    # first threshold whose count reaches the target, with linear
    # interpolation between the bracketing candidates
    reach = counts >= target
    idx = jnp.argmax(reach)  # first True (counts are monotone)
    i0 = jnp.maximum(idx - 1, 0)
    c0 = counts[i0]
    c1 = counts[idx]
    t0 = ts[i0]
    t1 = ts[idx]
    frac = jnp.where(c1 > c0, (target - c0) / jnp.maximum(c1 - c0, 1e-6), 0.0)
    med = t0 + jnp.clip(frac, 0.0, 1.0) * (t1 - t0)
    return jnp.where(idx == 0, ts[0] * 0.5, med)
