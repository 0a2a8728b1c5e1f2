"""Classical restoration: NLM denoise → dark-channel dehaze → unsharp.

Rebuild of the reference ``RestorationEngine``
(``members/jasraj/restoration/core.py``): non-local-means denoising
(``cv2.fastNlMeansDenoisingColored`` h=6, template 7, search 21 at
``core.py:138-144``), Dark Channel Prior dehazing (He et al.: min-channel
erosion 25x25 ``:106-123``, atmospheric light from the brightest 0.1 % of
the dark channel ``:164-174``, transmission ``1 - 0.95·dark`` clipped to
[0.1, 1] and Gaussian-refined ``:177-183``, radiance ``J=(I-A)/t + A``
``:186-190``), unsharp masking 1.5/−0.5 σ=2 (``:192-207``), plus the
synthetic haze+noise degradation generator used by its simulation tests
(``add_degradation`` ``:74-104``).

Accelerator-first: NLM is the textbook shifted-SSD formulation — every search
offset contributes ``exp(-boxfilter((I - shift(I))²)/h²)·shift(I)``, all
static shifts and box filters, no gathers. Images are float32 [0, 1],
``(H, W)`` or ``(H, W, 3)``.
"""

from __future__ import annotations

from functools import partial
from typing import List, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from pcmi_tpu.interface import Layer, SatellitePlugin
from pcmi_tpu.ops.filters import box_filter, gaussian_filter, unsharp_mask
from pcmi_tpu.ops.morphology import grey_erosion
from pcmi_tpu.ops.normalize import _masked_quantile


@partial(jax.jit, static_argnames=("h", "template", "search"))
def nlm_denoise(
    img: jnp.ndarray,
    h: float = 6.0 / 255.0,
    template: int = 7,
    search: int = 21,
) -> jnp.ndarray:
    """Non-local means on [0,1] images (ref h=6 on uint8 → 6/255 here)."""
    x = img.astype(jnp.float32)
    mono = x if x.ndim == 2 else x.mean(-1)
    r = search // 2
    tpad = template // 2
    h2 = h * h * template * template
    mp = jnp.pad(mono, r, mode="reflect")
    xp = jnp.pad(x, [(r, r), (r, r)] + [(0, 0)] * (x.ndim - 2), mode="reflect")

    # lax.scan over the (2r+1)^2 search offsets keeps the compiled graph
    # O(1) in the search area (an unrolled Python loop at search=21 is a
    # ~9000-op graph that takes minutes to compile)
    offs = jnp.stack(jnp.meshgrid(jnp.arange(search), jnp.arange(search),
                                  indexing="ij"), -1).reshape(-1, 2)

    def step(carry, off):
        num, den = carry
        core = jax.lax.dynamic_slice(mp, (off[0], off[1]), mono.shape)
        ssd = box_filter((mono - core) ** 2, tpad)
        wgt = jnp.exp(-ssd / h2)
        sx = jax.lax.dynamic_slice(
            xp, (off[0], off[1]) + (0,) * (x.ndim - 2), x.shape)
        num = num + (wgt[..., None] if x.ndim == 3 else wgt) * sx
        return (num, den + wgt), None

    (num, den), _ = jax.lax.scan(
        step, (jnp.zeros_like(x), jnp.zeros_like(mono)), offs)
    den = jnp.maximum(den, 1e-8)
    return num / (den[..., None] if x.ndim == 3 else den)


class DehazeResult(NamedTuple):
    radiance: jnp.ndarray      # restored image
    transmission: jnp.ndarray  # (H, W) in [0.1, 1]
    atmosphere: jnp.ndarray    # scalar or (3,) airlight


@partial(jax.jit, static_argnames=("erosion", "strength"))
def dark_channel_dehaze(
    img: jnp.ndarray, erosion: int = 25, strength: float = 0.95
) -> DehazeResult:
    """Dark Channel Prior dehazing (ref ``core.py:106-190``)."""
    x = img.astype(jnp.float32)
    chan_min = x if x.ndim == 2 else x.min(-1)
    dark = grey_erosion(chan_min, erosion)

    # atmospheric light: median intensity of the top 0.1% dark-channel pixels
    # (ref argpartition top-0.1% + median, core.py:164-174)
    q = _masked_quantile(dark, jnp.ones_like(dark, bool), jnp.asarray(0.999))
    top = dark >= q
    inten = x if x.ndim == 2 else x.mean(-1)
    A_scalar = _masked_quantile(inten, top, jnp.asarray(0.5))
    A = A_scalar if x.ndim == 2 else jnp.full((3,), A_scalar)

    t = 1.0 - strength * dark / jnp.maximum(A_scalar, 1e-6)
    t = jnp.clip(t, 0.1, 1.0)
    t = gaussian_filter(t, 8.0)  # ref refines with a large Gaussian (:177-183)
    t = jnp.clip(t, 0.1, 1.0)
    tb = t if x.ndim == 2 else t[..., None]
    J = (x - A) / tb + A
    return DehazeResult(radiance=jnp.clip(J, 0.0, 1.0), transmission=t,
                        atmosphere=A)


@partial(jax.jit, static_argnames=("haze_strength", "noise_sigma"))
def add_degradation(
    img: jnp.ndarray,
    key: jax.Array,
    haze_strength: float = 0.6,
    noise_sigma: float = 0.02,
):
    """Synthetic haze + Gaussian noise (ref ``add_degradation``
    ``core.py:74-104``) — the fault-injection path for restoration tests."""
    x = img.astype(jnp.float32)
    h, w = x.shape[:2]
    k1, k2 = jax.random.split(key)
    low = jax.random.uniform(k1, (h // 32 + 2, w // 32 + 2))
    from pcmi_tpu.ops.warp import map_coordinates
    ys = jnp.linspace(0, low.shape[0] - 2.0, h)
    xs = jnp.linspace(0, low.shape[1] - 2.0, w)
    gy, gx = jnp.meshgrid(ys, xs, indexing="ij")
    t_field = 1.0 - haze_strength * (0.5 + 0.5 * map_coordinates(low, gy, gx))
    A = 0.9
    tb = t_field if x.ndim == 2 else t_field[..., None]
    hazy = x * tb + A * (1.0 - tb)
    noisy = hazy + noise_sigma * jax.random.normal(k2, x.shape)
    return jnp.clip(noisy, 0.0, 1.0), t_field


class RestorationEngine:
    """run(): denoise -> dehaze -> sharpen (ref ``restore`` ``core.py:209-246``)."""

    def __init__(self, nlm_h: float = 6.0 / 255.0, erosion: int = 25,
                 unsharp_amount: float = 0.5):
        self.nlm_h = nlm_h
        self.erosion = erosion
        self.unsharp_amount = unsharp_amount

    def restore(self, img: jnp.ndarray):
        den = nlm_denoise(img, h=self.nlm_h)
        dh = dark_channel_dehaze(den, erosion=self.erosion)
        sharp = unsharp_mask(dh.radiance, amount=self.unsharp_amount)
        return {
            "denoised": den,
            "dehazed": dh.radiance,
            "transmission": dh.transmission,
            "output": sharp,
        }


class RestorationPlugin(SatellitePlugin):
    """Layer parity with reference ``RestorationPlugin``
    (``restoration/plugin.py:20-89``): input / denoised / dehazed / output /
    transmission(viridis)."""

    def __init__(self, engine: RestorationEngine | None = None):
        self.engine = engine or RestorationEngine()

    @property
    def name(self) -> str:
        return "Image Restoration"

    def run(self, image: np.ndarray, viewer=None) -> List[Layer]:
        img = np.asarray(image, np.float32)
        scale = img.max() if img.max() > 1.5 else 1.0
        out = self.engine.restore(jnp.asarray(img / scale))
        return [
            (image, {"name": "input"}, "image"),
            (np.asarray(out["denoised"]) * scale, {"name": "denoised"}, "image"),
            (np.asarray(out["dehazed"]) * scale, {"name": "dehazed"}, "image"),
            (np.asarray(out["output"]) * scale, {"name": "restored"}, "image"),
            (np.asarray(out["transmission"]),
             {"name": "transmission", "colormap": "viridis"}, "image"),
        ]
