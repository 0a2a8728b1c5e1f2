"""Batched image warps (the in-framework replacement for GDAL/ASP/OpenCV resampling).

The reference warps through three external engines: ASP's rectification
resampler (``processing.py:61-83``), ``cv2.warpPerspective`` in stitching
(``image_stitching/core.py:275-293``), and the inverse-affine coordinate warp
``warp_coordinates`` (``processing.py:43-58``). Here everything is one
bilinear ``map_coordinates`` gather, jittable and vmappable.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


@jax.jit
def map_coordinates(img: jnp.ndarray, ys: jnp.ndarray, xs: jnp.ndarray,
                    fill: float = 0.0) -> jnp.ndarray:
    """Bilinear sample of ``img[(H, W)]`` at float coords ``(ys, xs)``.

    Out-of-bounds samples return ``fill``. Shapes of ``ys``/``xs`` are
    preserved in the output.
    """
    h, w = img.shape
    img = img.astype(jnp.float32)

    y0 = jnp.floor(ys)
    x0 = jnp.floor(xs)
    ty = ys - y0
    tx = xs - x0

    def gather(yi, xi):
        yc = jnp.clip(yi, 0, h - 1).astype(jnp.int32)
        xc = jnp.clip(xi, 0, w - 1).astype(jnp.int32)
        return img[yc, xc]

    v00 = gather(y0, x0)
    v01 = gather(y0, x0 + 1)
    v10 = gather(y0 + 1, x0)
    v11 = gather(y0 + 1, x0 + 1)

    top = v00 * (1 - tx) + v01 * tx
    bot = v10 * (1 - tx) + v11 * tx
    out = top * (1 - ty) + bot * ty

    inside = (ys >= 0) & (ys <= h - 1) & (xs >= 0) & (xs <= w - 1)
    return jnp.where(inside, out, fill)


def _grid(out_shape):
    h, w = out_shape
    ys = jax.lax.broadcasted_iota(jnp.float32, (h, w), 0)
    xs = jax.lax.broadcasted_iota(jnp.float32, (h, w), 1)
    return ys, xs


@partial(jax.jit, static_argnames=("out_shape",))
def affine_warp(img: jnp.ndarray, matrix: jnp.ndarray, out_shape, fill: float = 0.0):
    """Warp ``img`` with a 2x3 or 3x3 *output->input* affine ``matrix``.

    ``out[y, x] = img[M @ (x, y, 1)]`` with (x, y) order matching OpenCV's
    ``warpAffine(..., WARP_INVERSE_MAP)`` convention, so rectifying
    transforms fit one code path.
    """
    ys, xs = _grid(out_shape)
    m = matrix.astype(jnp.float32)
    xi = m[0, 0] * xs + m[0, 1] * ys + m[0, 2]
    yi = m[1, 0] * xs + m[1, 1] * ys + m[1, 2]
    return map_coordinates(img, yi, xi, fill)


@partial(jax.jit, static_argnames=("out_shape",))
def homography_warp(img: jnp.ndarray, matrix: jnp.ndarray, out_shape, fill: float = 0.0):
    """Warp with a 3x3 *output->input* homography (cv2.warpPerspective inverse
    convention; stitching parity — ref ``image_stitching/core.py:275-293``)."""
    ys, xs = _grid(out_shape)
    m = matrix.astype(jnp.float32)
    xi = m[0, 0] * xs + m[0, 1] * ys + m[0, 2]
    yi = m[1, 0] * xs + m[1, 1] * ys + m[1, 2]
    zi = m[2, 0] * xs + m[2, 1] * ys + m[2, 2]
    zi = jnp.where(jnp.abs(zi) > 1e-8, zi, 1e-8)
    return map_coordinates(img, yi / zi, xi / zi, fill)


def invert_affine(matrix: jnp.ndarray) -> jnp.ndarray:
    """Invert a 2x3 (promoted to 3x3) or 3x3 affine matrix."""
    m = jnp.asarray(matrix, jnp.float32)
    if m.shape == (2, 3):
        m = jnp.concatenate([m, jnp.asarray([[0.0, 0.0, 1.0]], jnp.float32)], axis=0)
    return jnp.linalg.inv(m)


@jax.jit
def warp_points_affine(matrix: jnp.ndarray, xy: jnp.ndarray) -> jnp.ndarray:
    """Apply a 2x3/3x3 affine to ``(N, 2)`` (x, y) points.

    Parity with reference ``warp_coordinates`` (``processing.py:43-58``)
    which maps rectified-frame coords back to the original crop frame via the
    inverse ASP alignment matrix.
    """
    m = jnp.asarray(matrix, jnp.float32)
    ones = jnp.ones((xy.shape[0], 1), jnp.float32)
    homo = jnp.concatenate([xy.astype(jnp.float32), ones], axis=1)
    return jnp.matmul(homo, m[:2].T, precision=jax.lax.Precision.HIGHEST)
