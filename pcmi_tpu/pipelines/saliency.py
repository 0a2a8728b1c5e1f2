"""Spectral-residual saliency detection (Hou & Zhang), tiled and batched.

Rebuild of the reference's ``spectral_residual_global_detection``
(``members/rafael/saliency_object_annotation/saliency.py:4-98``): the image
is cut into padded tiles, each tile is downscaled, FFT'd, the log-amplitude
spectrum is compared to its local average (the "spectral residual"), and
the inverse transform's squared magnitude becomes the saliency map; tiles
are reassembled without their padding, then thresholded into detection
boxes.

Accelerator-first differences: tiles are a single batched array processed by one
vmapped jitted function (``jnp.fft`` batches cleanly) instead of a Python
loop; the morphological close + connected components + bounding boxes are
JAX too (iterated label propagation), with only the final box list pulled
to host.
"""

from __future__ import annotations

from functools import partial
from typing import List, NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from pcmi_tpu.interface import Layer, SatellitePlugin
from pcmi_tpu.ops.filters import box_filter, gaussian_filter
from pcmi_tpu.ops.morphology import binary_closing
from pcmi_tpu.ops.warp import map_coordinates


def _resize(img: jnp.ndarray, shape: Tuple[int, int]) -> jnp.ndarray:
    h, w = img.shape
    ys = jnp.linspace(0.0, h - 1.0, shape[0])
    xs = jnp.linspace(0.0, w - 1.0, shape[1])
    gy, gx = jnp.meshgrid(ys, xs, indexing="ij")
    return map_coordinates(img, gy, gx)


@partial(jax.jit, static_argnames=("work",))
def spectral_residual_tile(tile: jnp.ndarray, work: Tuple[int, int] = (72, 72)):
    """Saliency of one tile: downscale -> log-spectrum residual -> |IFFT|^2
    -> Gaussian smooth -> per-tile [0,1] normalise (ref ``saliency.py:50-66``)."""
    small = _resize(tile, work)
    F = jnp.fft.fft2(small)
    amp = jnp.abs(F)
    log_amp = jnp.log(jnp.maximum(amp, 1e-9))
    avg = box_filter(log_amp, 1)  # 3x3 box, ref uses cv2.blur(3,3)
    residual = log_amp - avg
    F2 = jnp.exp(residual) * (F / jnp.maximum(amp, 1e-9))
    sal = jnp.abs(jnp.fft.ifft2(F2)) ** 2
    sal = gaussian_filter(sal, 2.5, radius=4)  # ref GaussianBlur 9x9 σ2.5
    sal = sal - sal.min()
    sal = sal / jnp.maximum(sal.max(), 1e-9)
    return _resize(sal, tile.shape)


@partial(jax.jit, static_argnames=("tile", "pad", "work"))
def spectral_residual_map(
    img: jnp.ndarray,
    tile: int = 512,
    pad: int = 64,
    work: Tuple[int, int] = (72, 72),
) -> jnp.ndarray:
    """Full-image saliency via overlapping tiles (ref ``saliency.py:33-79``)."""
    h, w = img.shape
    ny = -(-h // tile)
    nx = -(-w // tile)
    padded = jnp.pad(img, ((pad, ny * tile - h + pad), (pad, nx * tile - w + pad)),
                     mode="reflect")

    # gather all tiles into one (N, tile+2p, tile+2p) batch
    tiles = []
    for ty in range(ny):
        for tx in range(nx):
            tiles.append(jax.lax.dynamic_slice(
                padded, (ty * tile, tx * tile), (tile + 2 * pad, tile + 2 * pad)
            ))
    batch = jnp.stack(tiles)
    sal_tiles = jax.vmap(lambda t: spectral_residual_tile(t, work))(batch)

    out = jnp.zeros((ny * tile, nx * tile), jnp.float32)
    k = 0
    for ty in range(ny):
        for tx in range(nx):
            core = sal_tiles[k, pad:-pad, pad:-pad]
            out = jax.lax.dynamic_update_slice(out, core, (ty * tile, tx * tile))
            k += 1
    return out[:h, :w]


@partial(jax.jit, static_argnames=("max_iters",))
def label_components(mask: jnp.ndarray, max_iters: int = 128) -> jnp.ndarray:
    """Connected-component labels by iterated 3x3 max propagation.

    Each foreground pixel starts with its flat index; neighbourhood max is
    propagated until fixpoint (bounded by ``max_iters``). Background = -1.
    Replaces ``cv2.findContours`` (ref ``saliency.py:90-96``) for box
    extraction — label propagation is pure ``reduce_window``.
    """
    h, w = mask.shape
    idx = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0) * w + \
        jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    lab0 = jnp.where(mask, idx, -1)

    def cond(state):
        i, lab, changed = state
        return (i < max_iters) & changed

    def body(state):
        i, lab, _ = state
        grown = jax.lax.reduce_window(
            lab, jnp.int32(-1), jax.lax.max,
            window_dimensions=(3, 3), window_strides=(1, 1), padding="SAME",
        )
        new = jnp.where(mask, grown, -1)
        return i + 1, new, jnp.any(new != lab)

    _, lab, _ = jax.lax.while_loop(cond, body, (0, lab0, jnp.bool_(True)))
    return lab


def extract_boxes(labels: np.ndarray, min_size: int = 20) -> List[Tuple[int, int, int, int]]:
    """Host-side (y0, x0, y1, x1) boxes from a label map (small output)."""
    labels = np.asarray(labels)
    out = []
    for lab in np.unique(labels):
        if lab < 0:
            continue
        ys, xs = np.nonzero(labels == lab)
        if (ys.max() - ys.min() + 1) * (xs.max() - xs.min() + 1) < min_size:
            continue
        out.append((int(ys.min()), int(xs.min()), int(ys.max()) + 1, int(xs.max()) + 1))
    return out


class SaliencyDetector(SatellitePlugin):
    """Plugin parity with reference ``SaliencyDetector``
    (``saliency_object_annotation/plugin.py:43-73``): returns the input,
    an inferno saliency layer, and red rectangle shapes."""

    def __init__(self, tile: int = 512, pad: int = 64, min_box: int = 20):
        self.tile = tile
        self.pad = pad
        self.min_box = min_box

    @property
    def name(self) -> str:
        return "Saliency Detection"

    def run(self, image: np.ndarray, viewer=None) -> List[Layer]:
        img = np.asarray(image, np.float32)
        if img.ndim == 3:
            img = img.mean(axis=-1)
        scale = img.max() if img.max() > 0 else 1.0
        sal = spectral_residual_map(jnp.asarray(img / scale),
                                    tile=self.tile, pad=self.pad)
        # threshold at min(3*mean, max) (ref saliency.py:84: min(3*mean, 255))
        sal_np = np.asarray(sal)
        thresh = min(3.0 * float(sal_np.mean()), float(sal_np.max()))
        mask = binary_closing(jnp.asarray(sal_np >= thresh), size=5)
        labels = label_components(mask)
        boxes = extract_boxes(np.asarray(labels), self.min_box)
        rects = [
            np.array([[y0, x0], [y0, x1], [y1, x1], [y1, x0]], np.float32)
            for (y0, x0, y1, x1) in boxes
        ]
        layers: List[Layer] = [
            (image, {"name": "input"}, "image"),
            (sal_np, {"name": "saliency", "colormap": "inferno"}, "image"),
        ]
        if rects:
            layers.append((
                np.stack(rects),
                {"name": "detections", "edge_color": "red",
                 "face_color": "transparent", "shape_type": "rectangle"},
                "shapes",
            ))
        return layers
