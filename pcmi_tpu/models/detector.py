"""Trainable object detector: center-heatmap dense prediction (Flax).

Capability parity with the reference's YOLO-OBB training path
(``members/jasraj/object_annotation/obj_model.py:39-52`` trains
``yolo26n-obb.pt`` for 100 epochs): the framework must be able to TRAIN a
detector, not just run one. Anchor-free center-point detection
(CenterNet-style) is the accelerator-idiomatic choice — dense per-pixel heads, no
anchor matching, no NMS-dependent training, decode = max-pool peak picking:

* backbone: small norm-free U-Net trunk (shared with the SR family)
* heads: center heatmap (sigmoid-focal loss), box size (L1 at centers),
  center offset (L1 at centers)
* decode: 3x3 max-pool peak detection + ``top_k`` — jit-friendly, feeds
  the same :class:`pcmi_tpu.pipelines.detection.ObjectDetector` driver as
  the training-free default (fixed (K, 6) output per tile).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax
from flax import linen as nn

from pcmi_tpu.models.unet import ConvBlock, _down, _up


class CenterNetHead(nn.Module):
    """(B, H, W, C_in) -> heatmap (B, H/4, W/4, n_classes), size (.., 2),
    offset (.., 2)[, angle (.., 2)]. Output stride 4.

    ``with_angle`` adds an oriented-box head predicting (sin 2θ, cos 2θ) —
    the double angle makes the regression target continuous under the
    rectangle's π symmetry — giving OBB capability parity with the
    reference's YOLO-OBB model (``obj_model.py:39-52``)."""

    widths: Sequence[int] = (32, 64, 128)
    n_classes: int = 1
    with_angle: bool = False

    @nn.compact
    def __call__(self, x):
        h = ConvBlock(self.widths[0], norm=False)(x)
        h = _down(h)                                  # /2
        h = ConvBlock(self.widths[1], norm=False)(h)
        h = _down(h)                                  # /4
        h = ConvBlock(self.widths[2], norm=False)(h)
        h = ConvBlock(self.widths[2], norm=False)(h)
        heat = nn.Conv(self.n_classes, (1, 1),
                       bias_init=nn.initializers.constant(-2.19))(h)
        size = nn.Conv(2, (1, 1))(h)
        offset = nn.Conv(2, (1, 1))(h)
        if self.with_angle:
            angle = nn.Conv(2, (1, 1))(h)             # (sin 2θ, cos 2θ)
            return heat, size, offset, angle
        return heat, size, offset


def gaussian_heatmap(centers: jnp.ndarray, valid: jnp.ndarray,
                     shape: Tuple[int, int], sigma: jnp.ndarray) -> jnp.ndarray:
    """Render ground-truth center gaussians: (N, 2) centers -> (H, W)."""
    hh, ww = shape
    ys = jax.lax.broadcasted_iota(jnp.float32, (hh, ww), 0)
    xs = jax.lax.broadcasted_iota(jnp.float32, (hh, ww), 1)

    def one(c, v, s):
        d2 = (ys - c[0]) ** 2 + (xs - c[1]) ** 2
        g = jnp.exp(-d2 / (2 * s**2))
        # pin an exact 1.0 at the rounded center cell: with fractional
        # centers the sampled gaussian peaks below the focal loss's
        # positive threshold and training collapses to all-background
        peak = (ys == jnp.round(c[0])) & (xs == jnp.round(c[1]))
        return jnp.where(v, jnp.maximum(g, peak.astype(jnp.float32)), 0.0)

    maps = jax.vmap(one)(centers, valid, sigma)
    return jnp.max(maps, axis=0)


def focal_loss(pred_logits, gt_heat, alpha=2.0, beta=4.0):
    """CenterNet penalty-reduced focal loss."""
    p = jax.nn.sigmoid(pred_logits)
    pos = gt_heat >= 0.999
    pos_loss = -((1 - p) ** alpha) * jnp.log(jnp.maximum(p, 1e-6)) * pos
    neg_loss = (
        -((1 - gt_heat) ** beta) * (p**alpha)
        * jnp.log(jnp.maximum(1 - p, 1e-6)) * (~pos)
    )
    n_pos = jnp.maximum(jnp.sum(pos), 1.0)
    return (jnp.sum(pos_loss) + jnp.sum(neg_loss)) / n_pos


@dataclasses.dataclass(frozen=True)
class DetectorTrainConfig:
    lr: float = 1e-3
    stride: int = 4
    w_size: float = 0.1
    w_offset: float = 1.0
    w_angle: float = 1.0
    max_objects: int = 32


class DetectorTrainer:
    """Jitted train step over (images, boxes, box_valid) batches.

    ``boxes`` are (B, K, 4) ``(y0, x0, y1, x1)`` padded with zeros;
    ``box_valid`` is (B, K) bool.
    """

    def __init__(self, cfg: DetectorTrainConfig = DetectorTrainConfig(),
                 model: nn.Module | None = None):
        self.cfg = cfg
        self.model = model or CenterNetHead()
        self.tx = optax.adam(cfg.lr)

    def init(self, key, sample_images):
        params = self.model.init(key, sample_images)
        return params, self.tx.init(params)

    def _targets(self, boxes, valid, out_shape):
        s = self.cfg.stride
        cy = (boxes[:, :, 0] + boxes[:, :, 2]) / 2 / s
        cx = (boxes[:, :, 1] + boxes[:, :, 3]) / 2 / s
        hgt = (boxes[:, :, 2] - boxes[:, :, 0]) / s
        wid = (boxes[:, :, 3] - boxes[:, :, 1]) / s
        sigma = jnp.maximum(jnp.sqrt(jnp.maximum(hgt * wid, 1.0)) / 3.0, 1.0)
        centers = jnp.stack([cy, cx], axis=-1)
        heat = jax.vmap(lambda c, v, sg: gaussian_heatmap(c, v, out_shape, sg))(
            centers, valid, sigma)
        return heat[..., None], centers, jnp.stack([hgt, wid], -1)

    @partial(jax.jit, static_argnames=("self",))
    def train_step(self, params, opt, images, boxes, box_valid):
        cfg = self.cfg

        def loss_fn(p):
            heat_l, size_p, off_p = self.model.apply(p, images)
            hh, ww = heat_l.shape[1:3]
            gt_heat, centers, sizes = self._targets(boxes, box_valid, (hh, ww))
            l_heat = focal_loss(heat_l[..., 0], gt_heat[..., 0])

            # gather predictions at gt centers (small K -> fine)
            ci = jnp.clip(centers.astype(jnp.int32), 0,
                          jnp.array([hh - 1, ww - 1]))
            bidx = jnp.arange(images.shape[0])[:, None]
            sp = size_p[bidx, ci[..., 0], ci[..., 1]]
            op = off_p[bidx, ci[..., 0], ci[..., 1]]
            v = box_valid.astype(jnp.float32)[..., None]
            n = jnp.maximum(jnp.sum(v), 1.0)
            l_size = jnp.sum(jnp.abs(sp - sizes) * v) / n
            frac = centers - jnp.floor(centers)
            l_off = jnp.sum(jnp.abs(op - frac) * v) / n
            total = l_heat + cfg.w_size * l_size + cfg.w_offset * l_off
            return total, {"heat": l_heat, "size": l_size, "off": l_off}

        (loss, parts), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt = self.tx.update(grads, opt, params)
        params = optax.apply_updates(params, updates)
        return params, opt, {"loss": loss, **parts}

    def make_tile_detector(self, params, max_boxes: int = 16,
                           score_thresh: float = 0.25):
        """Adapter: (N, T, T) batch -> (N, max_boxes, 6) for ObjectDetector."""
        s = self.cfg.stride
        model = self.model

        @jax.jit
        def detect(batch):
            x = batch[..., None] if batch.ndim == 3 else batch
            heat_l, size_p, off_p = model.apply(params, x)
            heat_all = jax.nn.sigmoid(heat_l)       # (N, h, w, n_classes)
            heat = heat_all.max(axis=-1)
            cls = jnp.argmax(heat_all, axis=-1)     # per-peak class
            peaks = jax.lax.reduce_window(
                heat, -jnp.inf, jax.lax.max, (1, 3, 3), (1, 1, 1), "SAME")
            is_peak = (heat == peaks) & (heat > score_thresh)
            score = jnp.where(is_peak, heat, 0.0)
            n, hh, ww = score.shape
            flat = score.reshape(n, -1)
            top, idx = jax.lax.top_k(flat, max_boxes)
            py = (idx // ww).astype(jnp.float32)
            px = (idx % ww).astype(jnp.float32)
            bidx = jnp.arange(n)[:, None]
            sz = size_p[bidx, idx // ww, idx % ww]
            of = off_p[bidx, idx // ww, idx % ww]
            kls = cls[bidx, idx // ww, idx % ww].astype(jnp.float32)
            cy = (py + of[..., 0]) * s
            cx = (px + of[..., 1]) * s
            bh = jnp.maximum(sz[..., 0], 0.0) * s
            bw = jnp.maximum(sz[..., 1], 0.0) * s
            return jnp.stack([
                cy - bh / 2, cx - bw / 2, cy + bh / 2, cx + bw / 2,
                top, kls,
            ], axis=-1)

        return detect


class OBBDetectorTrainer:
    """Oriented-box (OBB) trainer — the reference's YOLO-OBB capability
    (``obj_model.py:39-52``, claimed 92.8% mAP at ``test_obj.py:53``) on the
    same center-heatmap architecture plus the (sin 2θ, cos 2θ) angle head.

    Ground truth per image: ``obbs`` (B, K, 5) = (cy, cx, h, w, theta),
    ``valid`` (B, K) bool. Decode emits (N, K, 6) = (cy, cx, h, w, theta,
    score); evaluate with :mod:`pcmi_tpu.models.detector_eval`.
    """

    def __init__(self, cfg: DetectorTrainConfig = DetectorTrainConfig(),
                 model: nn.Module | None = None):
        self.cfg = cfg
        self.model = model or CenterNetHead(with_angle=True)
        assert getattr(self.model, "with_angle", False), \
            "OBBDetectorTrainer needs a with_angle head"
        self.tx = optax.adam(cfg.lr)

    def init(self, key, sample_images):
        params = self.model.init(key, sample_images)
        return params, self.tx.init(params)

    @partial(jax.jit, static_argnames=("self",))
    def train_step(self, params, opt, images, obbs, valid):
        cfg = self.cfg
        s = cfg.stride

        def loss_fn(p):
            heat_l, size_p, off_p, ang_p = self.model.apply(p, images)
            hh, ww = heat_l.shape[1:3]
            cy = obbs[:, :, 0] / s
            cx = obbs[:, :, 1] / s
            sizes = obbs[:, :, 2:4] / s
            theta = obbs[:, :, 4]
            sigma = jnp.maximum(
                jnp.sqrt(jnp.maximum(sizes[..., 0] * sizes[..., 1], 1.0)) / 3.0,
                1.0)
            centers = jnp.stack([cy, cx], axis=-1)
            gt_heat = jax.vmap(
                lambda c, v, sg: gaussian_heatmap(c, v, (hh, ww), sg)
            )(centers, valid, sigma)
            l_heat = focal_loss(heat_l[..., 0], gt_heat)

            ci = jnp.clip(centers.astype(jnp.int32), 0,
                          jnp.array([hh - 1, ww - 1]))
            bidx = jnp.arange(images.shape[0])[:, None]
            sp = size_p[bidx, ci[..., 0], ci[..., 1]]
            op = off_p[bidx, ci[..., 0], ci[..., 1]]
            ap_ = ang_p[bidx, ci[..., 0], ci[..., 1]]
            v = valid.astype(jnp.float32)[..., None]
            n = jnp.maximum(jnp.sum(v), 1.0)
            l_size = jnp.sum(jnp.abs(sp - sizes) * v) / n
            frac = centers - jnp.floor(centers)
            l_off = jnp.sum(jnp.abs(op - frac) * v) / n
            gt_ang = jnp.stack([jnp.sin(2 * theta), jnp.cos(2 * theta)], -1)
            l_ang = jnp.sum(jnp.abs(ap_ - gt_ang) * v) / n
            total = (l_heat + cfg.w_size * l_size + cfg.w_offset * l_off
                     + cfg.w_angle * l_ang)
            return total, {"heat": l_heat, "size": l_size, "off": l_off,
                           "angle": l_ang}

        (loss, parts), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt = self.tx.update(grads, opt, params)
        params = optax.apply_updates(params, updates)
        return params, opt, {"loss": loss, **parts}

    def make_obb_detector(self, params, max_boxes: int = 16,
                          score_thresh: float = 0.25):
        """(N, T, T[, C]) batch -> (N, max_boxes, 6) = (cy, cx, h, w, θ, score)."""
        s = self.cfg.stride
        model = self.model

        @jax.jit
        def detect(batch):
            x = batch[..., None] if batch.ndim == 3 else batch
            heat_l, size_p, off_p, ang_p = model.apply(params, x)
            heat = jax.nn.sigmoid(heat_l).max(axis=-1)
            peaks = jax.lax.reduce_window(
                heat, -jnp.inf, jax.lax.max, (1, 3, 3), (1, 1, 1), "SAME")
            is_peak = (heat == peaks) & (heat > score_thresh)
            score = jnp.where(is_peak, heat, 0.0)
            n, hh, ww = score.shape
            top, idx = jax.lax.top_k(score.reshape(n, -1), max_boxes)
            py = (idx // ww).astype(jnp.float32)
            px = (idx % ww).astype(jnp.float32)
            bidx = jnp.arange(n)[:, None]
            sz = size_p[bidx, idx // ww, idx % ww]
            of = off_p[bidx, idx // ww, idx % ww]
            ag = ang_p[bidx, idx // ww, idx % ww]
            theta = 0.5 * jnp.arctan2(ag[..., 0], ag[..., 1])
            return jnp.stack([
                (py + of[..., 0]) * s, (px + of[..., 1]) * s,
                jnp.maximum(sz[..., 0], 0.0) * s,
                jnp.maximum(sz[..., 1], 0.0) * s,
                theta, top,
            ], axis=-1)

        return detect


def synthesize_obb_batch(key, batch: int = 8, size: int = 128,
                         max_objects: int = 5, hard: bool = False):
    """Aircraft-like oriented targets on textured ground with exact OBB truth.

    The synthetic stand-in for the reference's Roboflow DOTA-planes download
    (``obj_model.py:13``, egress-free here): low-frequency textured terrain,
    plus per-object rotated "plane" shapes (fuselage + wing bar) at random
    orientation/scale/contrast. Returns ``(images, obbs, valid)`` with
    ``obbs`` (B, K, 5) = (cy, cx, h, w, theta) tight around the shape.

    ``hard=True`` makes the benchmark earn its number (VERDICT r2 item 10):
    plane-bright DISTRACTOR objects (wingless rectangles and round tanks —
    a detector keying on brightness alone false-positives on them), road
    clutter lines, a 2x wider target scale range and a lower contrast
    floor.
    """
    kb, kn, kc, ks, ka, kg, kd = jax.random.split(key, 7)
    # textured ground: sum of smoothed noise octaves
    gy = jax.random.normal(kn, (batch, size // 8 + 2, size // 8 + 2, 1))
    ground = jax.image.resize(gy, (batch, size, size, 1), "linear")
    g2 = jax.random.normal(jax.random.fold_in(kn, 1),
                           (batch, size // 2, size // 2, 1))
    ground = 0.45 + 0.12 * ground + 0.06 * jax.image.resize(
        g2, (batch, size, size, 1), "linear")

    n_obj = jax.random.randint(kb, (batch,), 1, max_objects + 1)
    cy = jax.random.uniform(kc, (batch, max_objects), minval=0.18, maxval=0.82) * size
    cx = jax.random.uniform(jax.random.fold_in(kc, 1), (batch, max_objects),
                            minval=0.18, maxval=0.82) * size
    lo_l, hi_l = (11.0, 34.0) if hard else (16.0, 30.0)
    lo_b = 0.18 if hard else 0.25
    length = jax.random.uniform(ks, (batch, max_objects), minval=lo_l, maxval=hi_l)
    span = length * jax.random.uniform(jax.random.fold_in(ks, 1),
                                       (batch, max_objects),
                                       minval=0.7, maxval=0.95)
    theta = jax.random.uniform(ka, (batch, max_objects),
                               minval=-np.pi / 2, maxval=np.pi / 2)
    bright = jax.random.uniform(kg, (batch, max_objects), minval=lo_b, maxval=0.45)
    valid = jnp.arange(max_objects)[None, :] < n_obj[:, None]

    ys = jax.lax.broadcasted_iota(jnp.float32, (size, size), 0)
    xs = jax.lax.broadcasted_iota(jnp.float32, (size, size), 1)

    def render(img, cys, cxs, Ls, Ws, ths, brs, vs):
        def one(c_y, c_x, L, Wd, th, br, v):
            # rotate into the box frame: u along fuselage (length L),
            # w across (span Wd)
            dy = ys - c_y
            dx = xs - c_x
            u = dy * jnp.cos(th) + dx * jnp.sin(th)
            w_ = -dy * jnp.sin(th) + dx * jnp.cos(th)
            fuselage = (jnp.abs(u) < L / 2) & (jnp.abs(w_) < L / 8)
            wing = (jnp.abs(u) < L / 8) & (jnp.abs(w_) < Wd / 2)
            tail = (u > L / 2 - L / 6) & (jnp.abs(u) < L / 2) & (
                jnp.abs(w_) < Wd / 4)
            shape = fuselage | wing | tail
            return jnp.where(v & shape, br, 0.0)

        marks = jax.vmap(one)(cys, cxs, Ls, Ws, ths, brs, vs)
        return jnp.clip(img[..., 0] + jnp.sum(marks, 0), 0, 1)[..., None]

    images = jax.vmap(render)(ground, cy, cx, length, span, theta, bright, valid)

    if hard:
        nd = 4  # distractors per scene (buildings / tanks / roads)
        k1, k2, k3, k4, k5 = jax.random.split(kd, 5)
        dy_ = jax.random.uniform(k1, (batch, nd)) * size
        dx_ = jax.random.uniform(jax.random.fold_in(k1, 1), (batch, nd)) * size
        dl = jax.random.uniform(k2, (batch, nd), minval=8.0, maxval=26.0)
        dw = dl * jax.random.uniform(jax.random.fold_in(k2, 1), (batch, nd),
                                     minval=0.3, maxval=0.6)
        dth = jax.random.uniform(k3, (batch, nd), minval=-np.pi / 2,
                                 maxval=np.pi / 2)
        dbr = jax.random.uniform(k4, (batch, nd), minval=lo_b, maxval=0.45)
        round_ = jax.random.bernoulli(k5, 0.4, (batch, nd))

        def add_distractors(img, cys, cxs, Ls, Ws, ths, brs, rnd):
            def one(c_y, c_x, L, Wd, th, br, rd):
                dy = ys - c_y
                dx = xs - c_x
                u = dy * jnp.cos(th) + dx * jnp.sin(th)
                w_ = -dy * jnp.sin(th) + dx * jnp.cos(th)
                rect = (jnp.abs(u) < L / 2) & (jnp.abs(w_) < Wd / 2)
                disk = (dy * dy + dx * dx) < (L / 2) ** 2
                return jnp.where(jnp.where(rd, disk, rect), br, 0.0)

            marks = jax.vmap(one)(cys, cxs, Ls, Ws, ths, brs, rnd)
            return jnp.clip(img[..., 0] + jnp.sum(marks, 0), 0, 1)[..., None]

        images = jax.vmap(add_distractors)(
            images, dy_, dx_, dl, dw, dth, dbr, round_)

        # road clutter: two dark lines per scene
        kr = jax.random.fold_in(kd, 7)
        p0 = jax.random.uniform(kr, (batch, 2, 2)) * size
        ang = jax.random.uniform(jax.random.fold_in(kr, 1), (batch, 2),
                                 minval=0.0, maxval=np.pi)

        def add_roads(img, ps, angs):
            def one(p, a):
                d = jnp.abs((ys - p[0]) * jnp.sin(a) - (xs - p[1]) * jnp.cos(a))
                return jnp.where(d < 1.5, -0.25, 0.0)

            marks = jax.vmap(one)(ps, angs)
            return jnp.clip(img[..., 0] + jnp.sum(marks, 0), 0, 1)[..., None]

        images = jax.vmap(add_roads)(images, p0, ang)

    obbs = jnp.stack([cy, cx, length, span, theta], axis=-1)
    return images, obbs, valid


def synthesize_detection_batch(key, batch: int = 8, size: int = 128,
                               max_objects: int = 6):
    """Random bright-blob scenes + ground-truth boxes (training data the
    reference gets from Roboflow; here synthetic, egress-free)."""
    kb, kn, kc, ks = jax.random.split(key, 4)
    base = 0.1 * jax.random.uniform(kn, (batch, size, size, 1))
    n_obj = jax.random.randint(kb, (batch,), 1, max_objects + 1)
    cy = jax.random.uniform(kc, (batch, max_objects), minval=0.15, maxval=0.85) * size
    cx = jax.random.uniform(jax.random.fold_in(kc, 1), (batch, max_objects),
                            minval=0.15, maxval=0.85) * size
    hw = jax.random.uniform(ks, (batch, max_objects, 2), minval=8.0, maxval=24.0)
    valid = jnp.arange(max_objects)[None, :] < n_obj[:, None]

    ys = jax.lax.broadcasted_iota(jnp.float32, (size, size), 0)
    xs = jax.lax.broadcasted_iota(jnp.float32, (size, size), 1)

    def render(img, cys, cxs, hws, vs):
        def one(c_y, c_x, h_w, v):
            inside = (jnp.abs(ys - c_y) < h_w[0] / 2) & (jnp.abs(xs - c_x) < h_w[1] / 2)
            return jnp.where(v & inside, 0.9, 0.0)
        blobs = jax.vmap(one)(cys, cxs, hws, vs)
        return jnp.clip(img[..., 0] + jnp.sum(blobs, 0), 0, 1)[..., None]

    images = jax.vmap(render)(base, cy, cx, hw, valid)
    boxes = jnp.stack([
        cy - hw[..., 0] / 2, cx - hw[..., 1] / 2,
        cy + hw[..., 0] / 2, cx + hw[..., 1] / 2,
    ], axis=-1)
    return images, boxes, valid
