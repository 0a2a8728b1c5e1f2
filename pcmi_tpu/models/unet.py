"""Flax U-Net family: inpainting generator, PatchGAN, SR U-Net, DIP U-Net.

Rebuilds the reference's torch model zoo in Flax linen:

* :class:`InpaintUNet` — 4-level InstanceNorm U-Net over RGB+mask input,
  predicting a masked *residual* (reference ``members/stan/models.py:36-73``
  ``U_net_generator``).
* :class:`PatchDiscriminator` — 70x70-receptive-field PatchGAN (reference
  ``models.py:76-111``).
* :class:`SRUNet` — 3-level norm-free U-Net predicting a residual over the
  bicubic-upsampled input (EDSR rationale noted at reference
  ``models.py:115-118``; ``UNetSRGenerator`` ``:136-179``).
* :class:`DIPUNet` — the Deep-Image-Prior U-Net (encoder 64/128/128 with
  skips, reference ``members/marcin/models/deep_image_prior.py:27-84``).
  The reference uses BatchNorm; with DIP's batch of one, InstanceNorm
  (GroupNorm with one group per channel) is the equivalent normalisation
  and keeps the training step purely functional.

All convolutions are NHWC so XLA lowers them straight onto its convolution kernels;
channel widths stay multiples of 32 to tile cleanly.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import jax
import jax.numpy as jnp
from flax import linen as nn


def instance_norm(x: jnp.ndarray) -> jnp.ndarray:
    mu = x.mean(axis=(1, 2), keepdims=True)
    var = x.var(axis=(1, 2), keepdims=True)
    return (x - mu) * jax.lax.rsqrt(var + 1e-5)


class ConvBlock(nn.Module):
    features: int
    norm: bool = True

    @nn.compact
    def __call__(self, x):
        x = nn.Conv(self.features, (3, 3), padding="SAME")(x)
        if self.norm:
            x = instance_norm(x)
        x = nn.leaky_relu(x, 0.2)
        x = nn.Conv(self.features, (3, 3), padding="SAME")(x)
        if self.norm:
            x = instance_norm(x)
        return nn.leaky_relu(x, 0.2)


def _down(x):
    return nn.max_pool(x, (2, 2), strides=(2, 2))


def _up(x, features):
    b, h, w, c = x.shape
    x = jax.image.resize(x, (b, h * 2, w * 2, c), method="nearest")
    return nn.Conv(features, (3, 3), padding="SAME")(x)


class InpaintUNet(nn.Module):
    """Residual inpainting generator; input (B, H, W, 4) = RGB(3)+mask(1).

    Output: ``input_rgb + tanh(head) * mask`` — the model only repaints the
    hole (reference residual formulation, ``models.py:36-73`` + notebook
    cell 20's masked losses).
    """

    widths: Sequence[int] = (32, 64, 128, 256)
    out_channels: int = 3

    @nn.compact
    def __call__(self, x):
        rgb = x[..., : self.out_channels]
        mask = x[..., self.out_channels:][..., :1]
        skips = []
        h = x
        for wdt in self.widths[:-1]:
            h = ConvBlock(wdt)(h)
            skips.append(h)
            h = _down(h)
        h = ConvBlock(self.widths[-1])(h)
        for wdt, skip in zip(reversed(self.widths[:-1]), reversed(skips)):
            h = _up(h, wdt)
            h = jnp.concatenate([h, skip], axis=-1)
            h = ConvBlock(wdt)(h)
        res = nn.Conv(self.out_channels, (1, 1))(h)
        return rgb + jnp.tanh(res) * mask


class PatchDiscriminator(nn.Module):
    """PatchGAN: stride-2 conv stack -> (B, h', w', 1) real/fake logits
    (reference ``models.py:76-111``)."""

    widths: Sequence[int] = (64, 128, 256, 512)

    @nn.compact
    def __call__(self, x):
        h = x
        for i, wdt in enumerate(self.widths):
            stride = 2 if i < len(self.widths) - 1 else 1
            h = nn.Conv(wdt, (4, 4), strides=(stride, stride), padding="SAME")(h)
            if i > 0:
                h = instance_norm(h)
            h = nn.leaky_relu(h, 0.2)
        return nn.Conv(1, (4, 4), padding="SAME")(h)


def bicubic_upsample(x: jnp.ndarray, factor: int = 4) -> jnp.ndarray:
    b, h, w, c = x.shape
    return jax.image.resize(x, (b, h * factor, w * factor, c), method="cubic")


class SRUNet(nn.Module):
    """4x super-resolution: residual over the bicubic upsample.

    Norm-free (EDSR rationale, reference ``models.py:115-118``): input is
    the bicubic-upsampled LR image; the net adds high-frequency detail.
    """

    widths: Sequence[int] = (32, 64, 128)
    out_channels: int = 3

    @nn.compact
    def __call__(self, x_up):
        skips = []
        h = x_up
        for wdt in self.widths[:-1]:
            h = ConvBlock(wdt, norm=False)(h)
            skips.append(h)
            h = _down(h)
        h = ConvBlock(self.widths[-1], norm=False)(h)
        for wdt, skip in zip(reversed(self.widths[:-1]), reversed(skips)):
            h = _up(h, wdt)
            h = jnp.concatenate([h, skip], axis=-1)
            h = ConvBlock(wdt, norm=False)(h)
        res = nn.Conv(self.out_channels, (1, 1))(h)
        return x_up + res


class DIPUNet(nn.Module):
    """Deep-Image-Prior U-Net over a fixed-noise input (B, H, W, in_ch=32)
    (reference ``deep_image_prior.py:27-84``: enc 64/128/128, dec skips)."""

    widths: Sequence[int] = (64, 128, 128)
    out_channels: int = 3

    @nn.compact
    def __call__(self, z):
        skips = []
        h = z
        for wdt in self.widths[:-1]:
            h = ConvBlock(wdt)(h)
            skips.append(h)
            h = _down(h)
        h = ConvBlock(self.widths[-1])(h)
        for wdt, skip in zip(reversed(self.widths[:-1]), reversed(skips)):
            h = _up(h, wdt)
            h = jnp.concatenate([h, skip], axis=-1)
            h = ConvBlock(wdt)(h)
        return nn.sigmoid(nn.Conv(self.out_channels, (1, 1))(h))
