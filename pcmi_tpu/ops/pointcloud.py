"""Point-cloud ops: plane fit, K-means, kNN filtering, gridding, ICP.

This is the multi-day fusion layer. The reference README advertises
"Multi-day 3D Point Cloud K-means Reconstruction" (reference ``README.md:17``)
but ships no fusion code — each stereo pair emits an independent cloud
(reference ``plugin.py:106,220-233``); the only K-means in the repo clusters
OBIA superpixels (``land_use_classification/core.py:227``). Here the
advertised capability is implemented for real, on the accelerator:

* plane fit       — the reference's full-frame SVD of an ~10^6 x 3 matrix
                    (``plugin.py:160-175``) becomes a weighted 3x3 covariance
                    (one matmul) + closed-form 3x3 ``eigh``.
* K-means         — ``lax.scan`` over iterations; assignment is a distance
                    matmul; centroid update is ``segment_sum``.
* kNN             — brute-force chunked distance matmuls + ``lax.top_k``;
                    no KD-tree (trees are pointer-chasing, hostile to
                    vector hardware; a tiled matmul is dense work).
* gridding        — DSM rasterisation via sort-segmented cell sums with
                    an optional robust re-pass (MAD rejection).
* ICP             — cross-date registration: chunked NN correspondence +
                    closed-form rigid/translation update per iteration.

Everything is fixed-shape and jittable: invalid points are carried as
``weight=0`` rows, never dropped, so batch shapes stay static under jit.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

HIGHEST = jax.lax.Precision.HIGHEST


# ---------------------------------------------------------------------------
# plane fit (reference plugin.py:156-175)
# ---------------------------------------------------------------------------


class Plane(NamedTuple):
    normal: jnp.ndarray    # (3,) unit normal, oriented +z
    centroid: jnp.ndarray  # (3,)


@jax.jit
def fit_plane(xyz: jnp.ndarray, weights: jnp.ndarray) -> Plane:
    """Weighted least-squares plane through ``xyz`` ((N, 3) or (H, W, 3)).

    Replaces the reference's dense SVD of the full centred point matrix
    (``plugin.py:160-166``) with the 3x3 scatter-matrix eigenproblem — same
    minimiser, O(N) instead of O(N·min(N,3)^2) memory traffic.
    """
    pts = xyz.reshape(-1, 3).astype(jnp.float32)
    w = weights.reshape(-1).astype(jnp.float32)
    wsum = jnp.maximum(jnp.sum(w), 1e-6)
    mu = jnp.sum(pts * w[:, None], axis=0) / wsum
    centred = (pts - mu) * jnp.sqrt(w)[:, None]
    cov = jnp.einsum("ni,nj->ij", centred, centred, precision=HIGHEST) / wsum
    # smallest-eigenvalue eigenvector of a symmetric 3x3 = plane normal
    _, vecs = jnp.linalg.eigh(cov)
    n = vecs[:, 0]
    n = jnp.where(n[2] < 0, -n, n)  # orient upward (ref plugin.py:168-170)
    return Plane(normal=n, centroid=mu)


@jax.jit
def plane_relative_height(xyz: jnp.ndarray, plane: Plane) -> jnp.ndarray:
    """Signed distance of each point to the plane along its normal —
    the reference's "relative height" (``plugin.py:171-175``)."""
    return jnp.einsum("...k,k->...", xyz - plane.centroid, plane.normal,
                      precision=HIGHEST)


# ---------------------------------------------------------------------------
# K-means (segment-op / matmul formulation)
# ---------------------------------------------------------------------------


class KMeansResult(NamedTuple):
    centroids: jnp.ndarray   # (K, D)
    assignment: jnp.ndarray  # (N,) int32
    inertia: jnp.ndarray     # () weighted sum of squared distances


def _pairwise_sqdist(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """(N, K) squared distances via the |a|^2 - 2ab + |b|^2 expansion."""
    an = jnp.sum(a * a, axis=1, keepdims=True)
    bn = jnp.sum(b * b, axis=1)
    ab = jnp.dot(a, b.T, precision=HIGHEST)
    return jnp.maximum(an - 2.0 * ab + bn[None, :], 0.0)


@partial(jax.jit, static_argnames=("k", "iters"))
def kmeans(
    points: jnp.ndarray,
    weights: jnp.ndarray,
    k: int,
    iters: int = 20,
    key: jax.Array | None = None,
) -> KMeansResult:
    """Weighted Lloyd's K-means, fixed iteration count (jit-static).

    Init is farthest-point sampling (greedy max-min, the deterministic core
    of k-means++): after a weighted-random first pick, each next centroid is
    the valid point farthest from the current centroid set. Guarantees one
    seed per well-separated mode — plain random init routinely doubles up a
    blob and strands another (empty clusters keep their previous centroid).
    ``weights`` zero-masks invalid points.
    """
    pts = points.astype(jnp.float32)
    w = weights.astype(jnp.float32)
    if key is None:
        key = jax.random.PRNGKey(0)
    # first seed: weighted random
    logw = jnp.where(w > 0, jnp.log(jnp.maximum(w, 1e-12)), -jnp.inf)
    g = logw + jax.random.gumbel(key, (pts.shape[0],))
    first = pts[jnp.argmax(g)]
    invalid_penalty = jnp.where(w > 0, 0.0, -jnp.inf)

    def fps_step(carry, _):
        init, mind = carry
        i, cents = init
        d2 = jnp.sum((pts - cents[i - 1]) ** 2, axis=1)
        mind = jnp.minimum(mind, d2)
        nxt = pts[jnp.argmax(mind + invalid_penalty)]
        cents = jax.lax.dynamic_update_index_in_dim(cents, nxt, i, axis=0)
        return ((i + 1, cents), mind), None

    cents0 = jnp.zeros((k, pts.shape[1]), jnp.float32)
    cents0 = cents0.at[0].set(first)
    ((_, init), _), _ = jax.lax.scan(
        fps_step,
        ((jnp.int32(1), cents0), jnp.full((pts.shape[0],), jnp.inf)),
        None,
        length=k - 1,
    )

    def step(centroids, _):
        d2 = _pairwise_sqdist(pts, centroids)
        assign = jnp.argmin(d2, axis=1)
        onehot = jax.nn.one_hot(assign, k, dtype=jnp.float32) * w[:, None]
        counts = jnp.sum(onehot, axis=0)                       # (K,)
        sums = jnp.dot(onehot.T, pts, precision=HIGHEST)       # (K, D)
        new = jnp.where(counts[:, None] > 0, sums / jnp.maximum(counts, 1e-12)[:, None], centroids)
        return new, None

    centroids, _ = jax.lax.scan(step, init, None, length=iters)
    d2 = _pairwise_sqdist(pts, centroids)
    assign = jnp.argmin(d2, axis=1).astype(jnp.int32)
    inertia = jnp.sum(jnp.min(d2, axis=1) * w)
    return KMeansResult(centroids=centroids, assignment=assign, inertia=inertia)


# ---------------------------------------------------------------------------
# brute-force kNN (chunked distance matmuls + top_k)
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("k", "chunk"))
def knn_mean_distance(
    points: jnp.ndarray,
    valid: jnp.ndarray,
    k: int = 8,
    chunk: int = 1024,
) -> jnp.ndarray:
    """Mean distance of each point to its ``k`` nearest valid neighbours.

    Chunked over query rows so peak memory is (chunk x N); each chunk is one
    distance matmul + ``top_k``. Invalid points get +inf distance as both
    query result and neighbour candidates.
    """
    pts = points.astype(jnp.float32)
    n = pts.shape[0]
    pad = (-n) % chunk
    ptsp = jnp.pad(pts, ((0, pad), (0, 0)))
    vq = jnp.pad(valid, (0, pad))
    inf = jnp.float32(jnp.inf)
    cand_mask = jnp.where(valid, 0.0, inf)  # (N,) additive mask

    def one_chunk(start):
        q = jax.lax.dynamic_slice_in_dim(ptsp, start, chunk, axis=0)
        d2 = _pairwise_sqdist(q, pts) + cand_mask[None, :]
        # exclude self-match: the zero-distance hit is the point itself
        neg_top, _ = jax.lax.top_k(-d2, k + 1)
        d_sorted = -neg_top  # ascending squared distances, (chunk, k+1)
        return jnp.mean(jnp.sqrt(d_sorted[:, 1:]), axis=1)

    starts = jnp.arange(0, n + pad, chunk)
    out = jax.lax.map(one_chunk, starts).reshape(-1)[:n]
    return jnp.where(vq[:n], out, inf)


@partial(jax.jit, static_argnames=("k", "chunk"))
def knn_outlier_mask(
    points: jnp.ndarray,
    valid: jnp.ndarray,
    k: int = 8,
    sigma: float = 3.0,
    chunk: int = 1024,
) -> jnp.ndarray:
    """Statistical outlier removal: flag points whose mean-kNN distance
    exceeds median + sigma * MAD over the valid population.

    The robust (median/MAD) analogue of PCL's StatisticalOutlierRemoval,
    consistent with the reference's median/MAD radiometric normalisation
    habit (``processing.py:21-33``).
    """
    d = knn_mean_distance(points, valid, k=k, chunk=chunk)
    finite = valid & jnp.isfinite(d)
    dv = jnp.where(finite, d, jnp.nan)
    med = jnp.nanmedian(dv)
    mad = jnp.nanmedian(jnp.abs(dv - med)) + 1e-9
    return finite & (d <= med + sigma * 1.4826 * mad)


@partial(jax.jit, static_argnames=("chunk",))
def nearest_neighbor(
    query: jnp.ndarray,
    ref: jnp.ndarray,
    ref_valid: jnp.ndarray,
    chunk: int = 1024,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Index + distance of the nearest valid ``ref`` point per query row."""
    q = query.astype(jnp.float32)
    r = ref.astype(jnp.float32)
    n = q.shape[0]
    pad = (-n) % chunk
    qp = jnp.pad(q, ((0, pad), (0, 0)))
    cand_mask = jnp.where(ref_valid, 0.0, jnp.float32(jnp.inf))

    def one_chunk(start):
        qq = jax.lax.dynamic_slice_in_dim(qp, start, chunk, axis=0)
        d2 = _pairwise_sqdist(qq, r) + cand_mask[None, :]
        idx = jnp.argmin(d2, axis=1)
        return idx, jnp.sqrt(jnp.min(d2, axis=1))

    starts = jnp.arange(0, n + pad, chunk)
    idx, dist = jax.lax.map(one_chunk, starts)
    return idx.reshape(-1)[:n].astype(jnp.int32), dist.reshape(-1)[:n]


# ---------------------------------------------------------------------------
# DSM gridding (segment-op scatter means)
# ---------------------------------------------------------------------------


class GridSpec2D(NamedTuple):
    origin: Tuple[float, float]  # (x0, y0) of cell (0, 0)
    cell: float                  # cell size
    shape: Tuple[int, int]       # (rows=ny, cols=nx)


@partial(jax.jit, static_argnames=("shape",))
def grid_fuse(
    xy: jnp.ndarray,
    values: jnp.ndarray,
    weights: jnp.ndarray,
    origin: Tuple[float, float],
    cell: float,
    shape: Tuple[int, int],
    robust_sigma: float = 3.0,
):
    """Rasterise scattered (x, y, value) samples onto a regular grid.

    Two-pass robust mean per cell: plain weighted mean, then re-mean after
    rejecting samples > ``robust_sigma`` cell-stddevs from it. Returns
    ``(dsm, count)`` with NaN where a cell received no samples.

    Per-cell statistics come from one sort by cell id plus segmented
    scans (:mod:`pcmi_tpu.ops.segmented`); the only scatter is the
    cell-sized compacted grid write
    (:func:`pcmi_tpu.ops.segmented.grid_segment_sums`).
    """
    from pcmi_tpu.ops.segmented import (
        grid_segment_sums,
        segment_totals_at_points,
        sort_by_segment,
    )

    ny, nx = shape
    gx = jnp.floor((xy[..., 0] - origin[0]) / cell).astype(jnp.int32)
    gy = jnp.floor((xy[..., 1] - origin[1]) / cell).astype(jnp.int32)
    inb = (gx >= 0) & (gx < nx) & (gy >= 0) & (gy < ny)
    w = jnp.where(inb, weights.astype(jnp.float32), 0.0)
    ids = jnp.where(inb, gy * nx + gx, 0).reshape(-1)
    v = values.reshape(-1).astype(jnp.float32)
    w = w.reshape(-1)
    # zero-weight members must not carry NaN/Inf/wild values into the
    # segmented totals (they would poison the global shift there)
    v = jnp.where(w > 0, v, 0.0)

    num = ny * nx
    ids, v, w, boundary = sort_by_segment(ids, v, w)
    ws_p, vs_p, vq_p = segment_totals_at_points(boundary, w, w * v, w * v * v)
    mean_p = vs_p / jnp.maximum(ws_p, 1e-12)
    std_p = jnp.sqrt(
        jnp.maximum(vq_p / jnp.maximum(ws_p, 1e-12) - mean_p**2, 0.0))

    # robust second pass: reject samples far from their cell mean
    keep = w * (jnp.abs(v - mean_p) <= robust_sigma * std_p + 1e-6)
    packed = grid_segment_sums(ids, boundary, (w, w * v, keep, keep * v),
                               num)
    wsum, vsum, wsum2, vsum2 = (packed[:, k] for k in range(4))
    mean = vsum / jnp.maximum(wsum, 1e-12)
    use2 = wsum2 > 0
    fused = jnp.where(use2, vsum2 / jnp.maximum(wsum2, 1e-12), mean)
    fused = jnp.where(wsum > 0, fused, jnp.nan)
    return fused.reshape(ny, nx), wsum.reshape(ny, nx)


# ---------------------------------------------------------------------------
# ICP cross-date registration
# ---------------------------------------------------------------------------


class ICPResult(NamedTuple):
    R: jnp.ndarray        # (3, 3)
    t: jnp.ndarray        # (3,)
    rmse: jnp.ndarray     # () final inlier RMSE


@partial(jax.jit, static_argnames=("iters", "chunk", "mode"))
def icp(
    src: jnp.ndarray,
    src_valid: jnp.ndarray,
    dst: jnp.ndarray,
    dst_valid: jnp.ndarray,
    iters: int = 10,
    chunk: int = 1024,
    mode: str = "rigid",
    trim_quantile: float = 0.8,
) -> ICPResult:
    """Point-to-point ICP aligning ``src`` onto ``dst``.

    Per iteration: chunked NN correspondences, trim to the best
    ``trim_quantile`` fraction by distance (robustness to partial overlap),
    then a closed-form update — full Kabsch (3x3 SVD) for ``mode="rigid"``
    or centroid shift for ``mode="translation"``. Fixed ``iters`` under
    ``lax.scan`` keeps it jittable.
    """
    s = src.astype(jnp.float32)
    d = dst.astype(jnp.float32)
    sw = src_valid.astype(jnp.float32)

    def step(carry, _):
        R, t = carry
        moved = jnp.dot(s, R.T, precision=HIGHEST) + t
        idx, dist = nearest_neighbor(moved, d, dst_valid, chunk=chunk)
        matched = d[idx]
        thresh = jnp.quantile(jnp.where(src_valid, dist, jnp.inf),
                              trim_quantile * jnp.mean(src_valid.astype(jnp.float32)))
        # gross-outlier gate on top of the quantile trim: correspondences
        # several times the median distance drag the centroid even when
        # they survive the trim fraction (seen with planted z-outliers)
        med = jnp.quantile(jnp.where(src_valid, dist, jnp.inf),
                           0.5 * jnp.mean(src_valid.astype(jnp.float32)))
        thresh = jnp.minimum(thresh, 4.0 * med + 1e-6)
        w = sw * (dist <= thresh)
        wsum = jnp.maximum(jnp.sum(w), 1e-6)
        mu_s = jnp.sum(moved * w[:, None], axis=0) / wsum
        mu_d = jnp.sum(matched * w[:, None], axis=0) / wsum
        if mode == "rigid":
            H = jnp.einsum("ni,nj->ij", (moved - mu_s) * w[:, None],
                           matched - mu_d, precision=HIGHEST)
            U, _, Vt = jnp.linalg.svd(H)
            det = jnp.linalg.det(jnp.matmul(Vt.T, U.T, precision=HIGHEST))
            S = jnp.diag(jnp.array([1.0, 1.0, 1.0]) .at[2].set(det))
            dR = jnp.matmul(jnp.matmul(Vt.T, S, precision=HIGHEST), U.T,
                            precision=HIGHEST)
        else:
            dR = jnp.eye(3)
        dt = mu_d - jnp.dot(dR, mu_s, precision=HIGHEST)
        R_new = jnp.dot(dR, R, precision=HIGHEST)
        t_new = jnp.dot(dR, t, precision=HIGHEST) + dt
        rmse = jnp.sqrt(jnp.sum(w * dist**2) / wsum)
        return (R_new, t_new), rmse

    (R, t), rmses = jax.lax.scan(step, (jnp.eye(3), jnp.zeros(3)), None,
                                 length=iters)
    return ICPResult(R=R, t=t, rmse=rmses[-1])


def apply_rigid(points: jnp.ndarray, R: jnp.ndarray, t: jnp.ndarray):
    return jnp.dot(points, R.T, precision=HIGHEST) + t
