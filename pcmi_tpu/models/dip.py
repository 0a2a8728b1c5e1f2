"""Deep Image Prior engine: the whole optimisation is ONE jitted scan.

Rebuild of the reference ``DIPEngine`` (``members/marcin/models/
deep_image_prior.py:93-160``): a fixed 32-channel noise input is pushed
through a small U-Net; Adam minimises MSE against the *known* pixels only,
and the converged output fills the holes. The reference runs 800-1000
Python-loop Adam iterations on CUDA; here the full loop is a
``lax.scan`` over train steps inside one jit — zero per-step dispatch, the
shape accelerators want for small-model inner loops.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import optax

from pcmi_tpu.models.unet import DIPUNet


@dataclasses.dataclass(frozen=True)
class DIPConfig:
    iters: int = 800              # ref 800-1000 (deep_image_prior.py:11-24)
    lr: float = 1e-2
    noise_channels: int = 32      # ref fixed-noise 32-ch input
    noise_reg: float = 0.03       # per-step input jitter (standard DIP trick)
    max_size: int = 512           # ref downscales to <=512 (:105-110)


class DIPResult(NamedTuple):
    output: jnp.ndarray           # (H, W, C) restored image
    losses: jnp.ndarray           # (iters,) loss curve


class DIPEngine:
    """restore/stitch/enhance(image, mask) — mask 1 = pixel to synthesise."""

    def __init__(self, cfg: DIPConfig = DIPConfig()):
        self.cfg = cfg
        self.model = DIPUNet()

    @partial(jax.jit, static_argnames=("self",))
    def _run(self, image: jnp.ndarray, known: jnp.ndarray, key: jax.Array):
        cfg = self.cfg
        h, w, c = image.shape
        kz, kp, kn = jax.random.split(key, 3)
        z0 = 0.1 * jax.random.normal(kz, (1, h, w, cfg.noise_channels))
        params = self.model.init(kp, z0)
        tx = optax.adam(cfg.lr)
        opt = tx.init(params)
        target = image[None]
        kw = known[None, ..., None].astype(jnp.float32)

        def loss_fn(p, z):
            out = self.model.apply(p, z)
            return jnp.sum(((out - target) ** 2) * kw) / jnp.maximum(jnp.sum(kw), 1.0)

        def step(carry, k):
            p, o = carry
            z = z0 + cfg.noise_reg * jax.random.normal(k, z0.shape)
            loss, grads = jax.value_and_grad(loss_fn)(p, z)
            updates, o = tx.update(grads, o, p)
            p = optax.apply_updates(p, updates)
            return (p, o), loss

        keys = jax.random.split(kn, cfg.iters)
        (params, _), losses = jax.lax.scan(step, (params, opt), keys)
        out = self.model.apply(params, z0)[0]
        return out, losses

    def _prep(self, image, mask):
        """Channelise + pad to the U-Net stride + optional max_size downscale.

        Returns device arrays plus the recipe to undo: U-Net decoders
        require H, W divisible by 2^(levels-1); the reference caps work at
        ``max_size`` px (``deep_image_prior.py:105-110``)."""
        img = jnp.asarray(image, jnp.float32)
        squeeze = img.ndim == 2
        if squeeze:
            img = img[..., None]
        m = jnp.asarray(mask, jnp.float32)
        if m.ndim == 3:
            m = m[..., 0]
        h0, w0 = img.shape[:2]
        scale = max(h0, w0) / self.cfg.max_size
        if scale > 1.0:
            h1 = int(round(h0 / scale))
            w1 = int(round(w0 / scale))
            img = jax.image.resize(img, (h1, w1, img.shape[-1]), "linear")
            m = (jax.image.resize(m, (h1, w1), "linear") > 0.25).astype(jnp.float32)
        stride = 2 ** (len(self.model.widths) - 1)
        ph = (-img.shape[0]) % stride
        pw = (-img.shape[1]) % stride
        if ph or pw:
            img = jnp.pad(img, ((0, ph), (0, pw), (0, 0)), mode="edge")
            m = jnp.pad(m, ((0, ph), (0, pw)))
        return img, m, (h0, w0), squeeze

    def _finish(self, out, orig_image, mask_full, size, squeeze):
        h0, w0 = size
        if out.shape[:2] != (h0, w0):
            out = jax.image.resize(out, (h0, w0, out.shape[-1]), "linear")
        img = jnp.asarray(orig_image, jnp.float32)
        if squeeze:
            img = img[..., None]
        m = jnp.asarray(mask_full, jnp.float32)
        if m.ndim == 3:
            m = m[..., 0]
        comp = jnp.where((m < 0.5)[..., None], img, out)
        if squeeze:
            comp = comp[..., 0]
        return comp

    def restore(self, image: jnp.ndarray, mask: jnp.ndarray,
                seed: int = 0) -> DIPResult:
        """``mask`` 1 = hole. Returns the DIP reconstruction composited so
        known pixels keep their original values."""
        img, m, size, squeeze = self._prep(image, mask)
        known = (m < 0.5)
        out, losses = self._run(img, known, jax.random.PRNGKey(seed))
        comp = self._finish(out, image, mask, size, squeeze)
        return DIPResult(output=comp, losses=losses)

    # stitching = restoring the composite's gap: same semantics
    stitch = restore

    def enhance(self, image: jnp.ndarray, mask=None, seed: int = 0) -> DIPResult:
        """Fit DIP to the WHOLE image and return the network's reconstruction
        (the prior acts as the enhancer). An all-hole mask here would train
        on zero loss and return init noise — every pixel must be known."""
        img, _, size, squeeze = self._prep(
            image, jnp.zeros(jnp.asarray(image).shape[:2]))
        known = jnp.ones(img.shape[:2], bool)
        out, losses = self._run(img, known, jax.random.PRNGKey(seed))
        h0, w0 = size
        if out.shape[:2] != (h0, w0):
            out = jax.image.resize(out, (h0, w0, out.shape[-1]), "linear")
        if squeeze:
            out = out[..., 0]
        return DIPResult(output=out, losses=losses)
