"""OBIA land-use classification: superpixels → features → K-means.

Rebuild of the reference ``OBIAClassifier``
(``members/jasraj/land_use_classification/core.py:168-255``): SLIC
superpixels (n≈1500, compactness 20, ``:189-196``), a 20-dim per-pixel
feature stack — LAB colour (``:146``), a 16-filter Gabor bank each blurred
15x15 (``:92-112,152-157``), local entropy over disk(5) (``:114-127``) —
per-superpixel mean aggregation (a Python loop at ``:210-215``),
StandardScaler + KMeans k=5 on the object features (``:224-228``), and the
label-map reconstruction + boundary/PCA visualisations (``:235-253``).

Accelerator-first rebuild:

* SLIC **is** K-means over (colour, compact·x, compact·y) features — the
  grid-seeded Lloyd iterations run as chunked distance matmuls
  instead of skimage's Cython neighbourhood walk.
* Per-superpixel aggregation is one ``segment_sum`` per feature block, not
  a Python loop over 1500 segments.
* PCA = eigh of the 20x20 feature covariance; boundaries = neighbour
  label-difference (shift compares).
"""

from __future__ import annotations

from functools import partial
from typing import List, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from pcmi_tpu.interface import Layer, SatellitePlugin
from pcmi_tpu.ops.filters import (
    box_filter,
    filter_bank_2d,
    gabor_bank,
    gaussian_filter,
    local_entropy,
)

HIGHEST = jax.lax.Precision.HIGHEST


def rgb_to_lab(rgb: jnp.ndarray) -> jnp.ndarray:
    """sRGB [0,1] -> CIELAB (D65), vectorised."""
    rgb = jnp.clip(rgb.astype(jnp.float32), 0.0, 1.0)
    lin = jnp.where(rgb > 0.04045, ((rgb + 0.055) / 1.055) ** 2.4, rgb / 12.92)
    M = jnp.asarray([
        [0.4124564, 0.3575761, 0.1804375],
        [0.2126729, 0.7151522, 0.0721750],
        [0.0193339, 0.1191920, 0.9503041],
    ], jnp.float32)
    xyz = jnp.einsum("...c,kc->...k", lin, M, precision=HIGHEST)
    white = jnp.asarray([0.95047, 1.0, 1.08883], jnp.float32)
    t = xyz / white
    f = jnp.where(t > (6 / 29) ** 3, jnp.cbrt(t), t / (3 * (6 / 29) ** 2) + 4 / 29)
    L = 116 * f[..., 1] - 16
    a = 500 * (f[..., 0] - f[..., 1])
    b = 200 * (f[..., 1] - f[..., 2])
    return jnp.stack([L, a, b], axis=-1)


class SlicResult(NamedTuple):
    labels: jnp.ndarray     # (H, W) int32 superpixel ids
    centers: jnp.ndarray    # (K, D) final cluster features
    n_segments: int


@partial(jax.jit, static_argnames=("n_segments", "iters", "chunk"))
def slic(
    image: jnp.ndarray,
    n_segments: int = 256,
    compactness: float = 20.0,
    iters: int = 8,
    chunk: int = 16384,
) -> SlicResult:
    """SLIC superpixels as grid-seeded K-means over (lab, s·y, s·x).

    ``compactness`` weights the spatial terms exactly as skimage does:
    spatial features are scaled by ``compactness / S`` with grid step ``S``.
    Distance evaluation is chunked over pixels; each chunk is one
    (chunk x K) matmul.
    """
    img = image.astype(jnp.float32)
    if img.ndim == 2:
        feats = img[..., None] * 100.0  # grayscale pseudo-L
    else:
        feats = rgb_to_lab(img)
    h, w = feats.shape[:2]
    S = float(np.sqrt(h * w / n_segments))
    ratio = compactness / S
    ys = jax.lax.broadcasted_iota(jnp.float32, (h, w), 0) * ratio
    xs = jax.lax.broadcasted_iota(jnp.float32, (h, w), 1) * ratio
    X = jnp.concatenate([feats, ys[..., None], xs[..., None]], axis=-1)
    X = X.reshape(-1, X.shape[-1])
    n = X.shape[0]

    # grid seeding
    gh = int(np.round(np.sqrt(n_segments * h / w)))
    gw = int(np.ceil(n_segments / max(gh, 1)))
    cy = (np.arange(gh) + 0.5) * h / gh
    cx = (np.arange(gw) + 0.5) * w / gw
    grid = np.stack(np.meshgrid(cy, cx, indexing="ij"), -1).reshape(-1, 2)
    grid = grid[:n_segments] if len(grid) >= n_segments else np.pad(
        grid, ((0, n_segments - len(grid)), (0, 0)), mode="edge")
    seed_idx = jnp.asarray(
        np.clip(grid[:, 0].astype(int), 0, h - 1) * w
        + np.clip(grid[:, 1].astype(int), 0, w - 1)
    )
    centers = X[seed_idx]

    pad = (-n) % chunk
    Xp = jnp.pad(X, ((0, pad), (0, 0)))

    def assign(centers):
        cn = jnp.sum(centers * centers, axis=1)

        def one_chunk(start):
            q = jax.lax.dynamic_slice_in_dim(Xp, start, chunk, axis=0)
            d2 = (
                jnp.sum(q * q, axis=1, keepdims=True)
                - 2.0 * jnp.dot(q, centers.T, precision=HIGHEST)
                + cn[None, :]
            )
            return jnp.argmin(d2, axis=1).astype(jnp.int32)

        starts = jnp.arange(0, n + pad, chunk)
        return jax.lax.map(one_chunk, starts).reshape(-1)[:n]

    def step(centers, _):
        a = assign(centers)
        sums = jax.ops.segment_sum(X, a, num_segments=n_segments)
        cnts = jax.ops.segment_sum(jnp.ones((n,), jnp.float32), a,
                                   num_segments=n_segments)
        new = jnp.where(cnts[:, None] > 0,
                        sums / jnp.maximum(cnts, 1.0)[:, None], centers)
        return new, None

    centers, _ = jax.lax.scan(step, centers, None, length=iters)
    labels = assign(centers).reshape(h, w)
    return SlicResult(labels=labels, centers=centers, n_segments=n_segments)


@partial(jax.jit, static_argnames=("entropy_radius",))
def obia_features(image: jnp.ndarray, entropy_radius: int = 5) -> jnp.ndarray:
    """20-dim per-pixel stack: LAB(3) + 16 blurred Gabor responses + entropy
    (ref ``core.py:146-165``)."""
    img = image.astype(jnp.float32)
    gray = img if img.ndim == 2 else img.mean(-1)
    lab = (
        jnp.stack([gray * 100.0, jnp.zeros_like(gray), jnp.zeros_like(gray)], -1)
        if img.ndim == 2 else rgb_to_lab(img)
    )
    bank = gabor_bank()  # 16 kernels, ksize 31 (ref parity)
    gab = filter_bank_2d(gray, bank)                       # (16, H, W)
    gab = jax.vmap(lambda g: box_filter(g, 7))(jnp.abs(gab))  # blur 15x15
    ent = local_entropy(jnp.clip(gray, 0.0, 1.0), radius=entropy_radius)
    return jnp.concatenate(
        [lab, jnp.moveaxis(gab, 0, -1), ent[..., None]], axis=-1
    )


class OBIAResult(NamedTuple):
    superpixels: jnp.ndarray   # (H, W) int32
    classes: jnp.ndarray       # (H, W) int32 in [0, k)
    pca_rgb: jnp.ndarray       # (H, W, 3) visualisation
    boundaries: jnp.ndarray    # (H, W) bool


@partial(jax.jit, static_argnames=("n_segments", "k"))
def _obia_core(image, n_segments: int, k: int, key) -> OBIAResult:
    feats = obia_features(image)
    sp = slic(image, n_segments=n_segments)
    flat = feats.reshape(-1, feats.shape[-1])
    lab = sp.labels.reshape(-1)

    # per-superpixel mean (segment ops, ref python loop :210-215)
    sums = jax.ops.segment_sum(flat, lab, num_segments=n_segments)
    cnts = jax.ops.segment_sum(jnp.ones_like(lab, jnp.float32), lab,
                               num_segments=n_segments)
    seg_feats = sums / jnp.maximum(cnts, 1.0)[:, None]
    present = cnts > 0

    # StandardScaler over present segments (ref :224)
    mu = jnp.sum(seg_feats * present[:, None], 0) / jnp.maximum(jnp.sum(present), 1)
    var = jnp.sum(((seg_feats - mu) ** 2) * present[:, None], 0) / jnp.maximum(
        jnp.sum(present), 1)
    z = (seg_feats - mu) / jnp.sqrt(var + 1e-8)

    from pcmi_tpu.ops.pointcloud import kmeans
    km = kmeans(z, present.astype(jnp.float32), k=k, iters=25, key=key)
    class_of_seg = km.assignment                        # (n_segments,)
    classes = class_of_seg[lab].reshape(sp.labels.shape)

    # 3-component PCA visualisation of the z features (ref :240-253)
    cov = jnp.einsum("nd,ne->de", z * present[:, None], z * present[:, None],
                     precision=HIGHEST) / jnp.maximum(jnp.sum(present), 1)
    _, vecs = jnp.linalg.eigh(cov)
    proj = z @ vecs[:, -3:]
    pca_seg = (proj - proj.min(0)) / jnp.maximum(proj.max(0) - proj.min(0), 1e-6)
    pca_rgb = pca_seg[lab].reshape(*sp.labels.shape, 3)

    lbl = sp.labels
    boundaries = (
        (lbl != jnp.roll(lbl, 1, 0)) | (lbl != jnp.roll(lbl, 1, 1))
    )
    return OBIAResult(superpixels=sp.labels, classes=classes,
                      pca_rgb=pca_rgb, boundaries=boundaries)


class OBIAClassifier:
    def __init__(self, n_segments: int = 1500, k: int = 5, seed: int = 0):
        self.n_segments = n_segments
        self.k = k
        self.seed = seed

    def run_obia_pipeline(self, image: jnp.ndarray) -> OBIAResult:
        return _obia_core(jnp.asarray(image), self.n_segments, self.k,
                          jax.random.PRNGKey(self.seed))


class LandUseClassificationPlugin(SatellitePlugin):
    """Layer parity with ``land_use_classification/plugin.py:5-78``:
    input / superpixel boundaries / PCA / classification labels."""

    def __init__(self, classifier: OBIAClassifier | None = None):
        self.classifier = classifier or OBIAClassifier()

    @property
    def name(self) -> str:
        return "Land Use Classification"

    def run(self, image: np.ndarray, viewer=None) -> List[Layer]:
        img = np.asarray(image, np.float32)
        scale = img.max() if img.max() > 1.5 else 1.0
        res = self.classifier.run_obia_pipeline(img / scale)
        return [
            (image, {"name": "input"}, "image"),
            (np.asarray(res.boundaries).astype(np.uint8),
             {"name": "superpixels", "opacity": 0.5}, "image"),
            (np.asarray(res.pca_rgb), {"name": "pca"}, "image"),
            (np.asarray(res.classes).astype(np.int32),
             {"name": "classification"}, "labels"),
        ]
