"""Morphology and distance transforms via ``lax.reduce_window`` sweeps.

Replaces scipy/OpenCV morphology used by the reference:
``binary_dilation`` margin poisoning (``processing.py:35-41``), dark-channel
``cv2.erode`` 25x25 (``restoration/core.py:106-123``), morphological close in
saliency (``saliency.py:84-96``), and ``distance_transform_edt`` feathering
(``marcin/models/utils.py:7-22``).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


def _window_reduce(img: jnp.ndarray, size: int, init, op) -> jnp.ndarray:
    return jax.lax.reduce_window(
        img, init, op,
        window_dimensions=(size, size),
        window_strides=(1, 1),
        padding="SAME",
    )


@partial(jax.jit, static_argnames=("iterations", "size"))
def binary_dilation(mask: jnp.ndarray, iterations: int = 1, size: int = 3):
    """Iterated square dilation == max-pool (ref ``processing.py:40`` uses
    ``scipy.ndimage.binary_dilation(iterations=margin)``, a 3x3 cross; a
    single max-pool with window ``2*it+1`` gives the square hull, so we
    emulate the cross by one pool of the equivalent Chebyshev radius — the
    reference uses it only to over-poison borders, where the difference is
    immaterial and conservative)."""
    x = mask.astype(jnp.float32)
    eff = (size - 1) * iterations + 1
    x = _window_reduce(x, eff, -jnp.inf, jax.lax.max)
    return x > 0.5


@partial(jax.jit, static_argnames=("iterations", "size"))
def binary_erosion(mask: jnp.ndarray, iterations: int = 1, size: int = 3):
    x = mask.astype(jnp.float32)
    eff = (size - 1) * iterations + 1
    x = _window_reduce(x, eff, jnp.inf, jax.lax.min)
    return x > 0.5


@partial(jax.jit, static_argnames=("size",))
def binary_closing(mask: jnp.ndarray, size: int = 3):
    x = mask.astype(jnp.float32)
    x = _window_reduce(x, size, -jnp.inf, jax.lax.max)
    x = _window_reduce(x, size, jnp.inf, jax.lax.min)
    return x > 0.5


@partial(jax.jit, static_argnames=("size",))
def grey_erosion(img: jnp.ndarray, size: int):
    """Min-filter (dark-channel erosion, ref ``restoration/core.py:117-123``)."""
    return _window_reduce(img.astype(jnp.float32), size, jnp.inf, jax.lax.min)


@partial(jax.jit, static_argnames=("size",))
def grey_dilation(img: jnp.ndarray, size: int):
    return _window_reduce(img.astype(jnp.float32), size, -jnp.inf, jax.lax.max)


@partial(jax.jit, static_argnames=("max_dist",))
def distance_transform(mask: jnp.ndarray, max_dist: int = 32) -> jnp.ndarray:
    """Approximate Euclidean distance from each True pixel to the nearest
    False pixel, clipped at ``max_dist``.

    Chamfer-style: iterated 3x3 min-plus sweeps expressed as reduce_window
    passes — O(max_dist) fused elementwise passes instead of scipy's sequential EDT
    (ref ``marcin/models/utils.py:16`` uses ``distance_transform_edt`` only to
    feather blend masks, where a clipped chamfer distance is equivalent).
    """
    big = jnp.float32(max_dist)
    d = jnp.where(mask, big, 0.0)

    def body(_, d):
        shifted_min = -_window_reduce(-d, 3, -jnp.inf, jax.lax.max)  # 3x3 min
        return jnp.minimum(d, shifted_min + 1.0)

    d = jax.lax.fori_loop(0, max_dist, body, d)
    return jnp.minimum(d, big)
