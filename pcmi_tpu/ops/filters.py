"""Separable and edge-aware filters (jittable, XLA-fusable).

Replaces the OpenCV filtering the reference leans on: Gaussian blurs
(``restoration/core.py:177-183``), box means, the WLS disparity post-filter
(``disparity.py:287-310``) — stood in for by the fast guided filter (He et
al., closed-form box-filter algebra, fully vectorised) — the Gabor bank
(``land_use_classification/core.py:92-112``), and unsharp masking
(``restoration/core.py:192-207``).

Convention: images are ``(H, W)`` or ``(H, W, C)`` float32; all filters use
reflect padding like OpenCV's default BORDER_REFLECT_101 unless noted.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def _conv1d_along(img: jnp.ndarray, kernel: jnp.ndarray, axis: int) -> jnp.ndarray:
    """Correlate a 1-D kernel along ``axis`` of a 2-D/3-D image, reflect-padded."""
    k = kernel.shape[0]
    pad = k // 2
    pad_width = [(0, 0)] * img.ndim
    pad_width[axis] = (pad, pad)
    padded = jnp.pad(img, pad_width, mode="reflect")
    # Express as a sum of shifted slices: k is small/static, XLA fuses this
    # into a single vectorized expression — no gather.
    out = jnp.zeros_like(img)
    for i in range(k):
        sl = [slice(None)] * img.ndim
        sl[axis] = slice(i, i + img.shape[axis])
        out = out + kernel[i] * padded[tuple(sl)]
    return out


def separable_filter(img: jnp.ndarray, ky: jnp.ndarray, kx: jnp.ndarray) -> jnp.ndarray:
    """Apply separable kernel: rows with ``ky`` then cols with ``kx``."""
    return _conv1d_along(_conv1d_along(img, ky, 0), kx, 1)


def gaussian_kernel1d(sigma: float, radius: int | None = None) -> jnp.ndarray:
    if radius is None:
        radius = max(1, int(3.0 * sigma + 0.5))
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return jnp.asarray(k / k.sum())


@partial(jax.jit, static_argnames=("sigma", "radius"))
def gaussian_filter(img: jnp.ndarray, sigma: float, radius: int | None = None):
    k = gaussian_kernel1d(sigma, radius)
    return separable_filter(img.astype(jnp.float32), k, k)


def box_filter(img: jnp.ndarray, radius: int) -> jnp.ndarray:
    """Mean filter with window ``2r+1``, computed as two 1-D sums.

    For the small radii used here a shift-sum beats a cumsum (static
    slices, fully fused); normalization uses the constant window area with
    reflect padding so edges stay unbiased.
    """
    k = jnp.ones((2 * radius + 1,), jnp.float32) / np.float32(2 * radius + 1)
    return separable_filter(img.astype(jnp.float32), k, k)


@partial(jax.jit, static_argnames=("radius", "eps"))
def guided_filter(
    guide: jnp.ndarray,
    src: jnp.ndarray,
    radius: int = 9,
    eps: float = 1e-3,
) -> jnp.ndarray:
    """Fast guided filter (He, Sun, Tang 2010) — edge-aware smoothing of
    ``src`` guided by ``guide``.

    Stands in for the reference's ``cv2.ximgproc.createDisparityWLSFilter``
    post-filtering (``disparity.py:287-310``): both are edge-preserving
    global-ish smoothers; the guided filter is pure box-filter algebra so it
    is elementwise work with no iterative solve.
    """
    I = guide.astype(jnp.float32)
    p = src.astype(jnp.float32)
    mean_I = box_filter(I, radius)
    mean_p = box_filter(p, radius)
    corr_I = box_filter(I * I, radius)
    corr_Ip = box_filter(I * p, radius)
    var_I = corr_I - mean_I * mean_I
    cov_Ip = corr_Ip - mean_I * mean_p
    a = cov_Ip / (var_I + eps)
    b = mean_p - a * mean_I
    mean_a = box_filter(a, radius)
    mean_b = box_filter(b, radius)
    return mean_a * I + mean_b


@partial(jax.jit, static_argnames=("radius", "eps"))
def masked_guided_filter(
    guide: jnp.ndarray,
    src: jnp.ndarray,
    mask: jnp.ndarray,
    radius: int = 9,
    eps: float = 1e-3,
) -> jnp.ndarray:
    """Guided filter where only ``mask`` pixels of ``src`` contribute.

    Used to in-fill low-confidence disparities from confident neighbours —
    the role of the WLS confidence map at reference ``disparity.py:300-310``.
    """
    I = guide.astype(jnp.float32)
    m = mask.astype(jnp.float32)
    p = src.astype(jnp.float32) * m
    n = box_filter(m, radius)
    safe = jnp.maximum(n, 1e-6)
    mean_I = box_filter(I * m, radius) / safe
    mean_p = box_filter(p, radius) / safe
    corr_I = box_filter(I * I * m, radius) / safe
    corr_Ip = box_filter(I * p, radius) / safe
    var_I = jnp.maximum(corr_I - mean_I * mean_I, 0.0)
    cov_Ip = corr_Ip - mean_I * mean_p
    a = cov_Ip / (var_I + eps)
    b = mean_p - a * mean_I
    mean_a = box_filter(a * m, radius) / safe
    mean_b = box_filter(b * m, radius) / safe
    return mean_a * I + mean_b


def gabor_bank(
    ksize: int = 31,
    thetas=(0.0, np.pi / 4, np.pi / 2, 3 * np.pi / 4),
    sigmas=(2.0, 4.0),
    lambdas=(8.0, 16.0),
    gamma: float = 0.5,
) -> jnp.ndarray:
    """Build the 16-filter Gabor bank of the reference OBIA classifier
    (4 orientations x 2 sigmas x 2 wavelengths, ksize 31 — reference
    ``land_use_classification/core.py:92-112``). Returns ``(N, k, k)``.
    """
    ys, xs = np.mgrid[-(ksize // 2): ksize // 2 + 1, -(ksize // 2): ksize // 2 + 1]
    kernels = []
    for theta in thetas:
        xr = xs * np.cos(theta) + ys * np.sin(theta)
        yr = -xs * np.sin(theta) + ys * np.cos(theta)
        for sigma in sigmas:
            for lam in lambdas:
                g = np.exp(-(xr**2 + (gamma * yr) ** 2) / (2 * sigma**2))
                g = g * np.cos(2 * np.pi * xr / lam)
                g = g - g.mean()
                kernels.append(g.astype(np.float32))
    return jnp.asarray(np.stack(kernels))


@jax.jit
def filter_bank_2d(img: jnp.ndarray, kernels: jnp.ndarray) -> jnp.ndarray:
    """Correlate ``(H, W)`` image with ``(N, k, k)`` kernels -> ``(N, H, W)``.

    Uses ``lax.conv_general_dilated`` so XLA lowers it to its convolution kernels.
    """
    h, w = img.shape
    lhs = img.reshape(1, 1, h, w).astype(jnp.float32)
    rhs = kernels[:, None, :, :].astype(jnp.float32)
    k = kernels.shape[-1]
    out = jax.lax.conv_general_dilated(
        lhs, rhs, window_strides=(1, 1), padding=[(k // 2, k // 2)] * 2,
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
    )
    return out[0]


def _batcher_pairs(n: int):
    """Compare-exchange index pairs of Batcher's odd-even mergesort."""
    pairs = []
    p = 1
    while p < n:
        k = p
        while k >= 1:
            for j in range(k % p, n - k, 2 * k):
                for i in range(min(k, n - j - k)):
                    if (i + j) // (2 * p) == (i + j + k) // (2 * p):
                        pairs.append((i + j, i + j + k))
            k //= 2
        p *= 2
    return pairs


def _median_along(img: jnp.ndarray, size: int, axis: int) -> jnp.ndarray:
    """1-D running median via a Batcher min/max selection network.

    ``jnp.median`` lowers to a SORT of the stacked (size, H, W) planes,
    dominated by materialising and re-reading the stack. The sorting
    network is pure elementwise min/max over ``size`` shifted VIEWS of one
    padded array, which XLA fuses into a single streaming pass (no stack,
    no sort).
    """
    pad = size // 2
    pad_width = [(0, 0)] * img.ndim
    pad_width[axis] = (pad, pad)
    padded = jnp.pad(img, pad_width, mode="edge")
    planes = []
    for i in range(size):
        sl = [slice(None)] * img.ndim
        sl[axis] = slice(i, i + img.shape[axis])
        planes.append(padded[tuple(sl)])
    for a, b in _batcher_pairs(size):
        lo = jnp.minimum(planes[a], planes[b])
        hi = jnp.maximum(planes[a], planes[b])
        planes[a], planes[b] = lo, hi
    return planes[size // 2]


@partial(jax.jit, static_argnames=("size",))
def separable_median_filter(img: jnp.ndarray, size: int = 9) -> jnp.ndarray:
    """Median-of-medians: 1-D median along rows, then columns.

    The separable approximation of a true 2-D median — standard for speckle
    gating (the role of OpenCV's ``filterSpeckles`` post-SGBM). Memory stays
    O(size·H·W) instead of O(size²·H·W), and each pass is a static
    shift-stack + ``jnp.median`` — sort-free for small ``size``.
    """
    out = _median_along(img.astype(jnp.float32), size, 0)
    return _median_along(out, size, 1)


@partial(jax.jit, static_argnames=("iters",))
def masked_jacobi_fill(image: jnp.ndarray, mask: jnp.ndarray, iters: int = 128):
    """Fill ``mask`` holes by Jacobi relaxation from the rim.

    The Telea-inpaint stand-in (ref ``components/restoration.py:9-16``) and
    the conditioning baseline the inpainting model predicts residuals over.
    Lives in ops so both the generative pipelines and the model trainers
    share one implementation.
    """
    img = image.astype(jnp.float32)
    m = mask.astype(jnp.float32)
    m3 = m[..., None] if img.ndim == 3 and m.ndim == 2 else m
    # seed the hole with the (per-image) mean of the KNOWN pixels — divide
    # by the broadcast count so multi-channel images aren't biased
    w = jnp.broadcast_to(1.0 - m3, img.shape)
    known_mean = jnp.sum(img * w) / jnp.maximum(jnp.sum(w), 1.0)
    init = img * (1.0 - m3) + known_mean * m3

    def body(_, x):
        blur = gaussian_filter(x, 1.5, radius=2)
        return jnp.where(m3 > 0.5, blur, img)

    return jax.lax.fori_loop(0, iters, body, init)


@partial(jax.jit, static_argnames=("amount", "sigma"))
def unsharp_mask(img: jnp.ndarray, amount: float = 1.5, sigma: float = 2.0):
    """Unsharp masking: ``(1+a)*img - a*blur`` (reference
    ``restoration/core.py:192-207`` uses addWeighted 1.5/-0.5 σ=2)."""
    blur = gaussian_filter(img, sigma)
    return jnp.clip((1.0 + amount) * img - amount * blur, 0.0, 1.0)


@partial(jax.jit, static_argnames=("radius",))
def local_entropy(img01: jnp.ndarray, radius: int = 5, n_bins: int = 16):
    """Local Shannon entropy over a disk-ish window.

    Replaces ``skimage.filters.rank.entropy(img, disk(5))`` (reference
    ``land_use_classification/core.py:114-127``) with a soft-binned,
    box-filtered histogram — branch-free and fully vectorized.
    """
    img01 = img01.astype(jnp.float32)
    centers = (jnp.arange(n_bins, dtype=jnp.float32) + 0.5) / n_bins
    # Soft one-hot binning: triangular kernel of width one bin.
    dist = jnp.abs(img01[..., None] - centers) * n_bins
    weights = jnp.maximum(1.0 - dist, 0.0)  # (H, W, B)
    probs = box_filter(weights, radius)
    probs = probs / jnp.maximum(probs.sum(-1, keepdims=True), 1e-8)
    ent = -jnp.sum(probs * jnp.log2(jnp.maximum(probs, 1e-8)), axis=-1)
    return ent
