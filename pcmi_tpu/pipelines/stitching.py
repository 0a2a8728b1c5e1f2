"""Feature-based image stitching in JAX (no SIFT).

Rebuild of the reference ``ImageStitcher`` (``members/jasraj/
image_stitching/core.py:204-323``): SIFT + BF-kNN ratio matching + spatial
consistency + RANSAC homography + canvas warp + DP seam carve + feathered
composition. SIFT's scale-space keypoint machinery is branch-heavy and
gather-bound — hostile to vector hardware — so this design replaces the
front end while keeping the same geometric estimation:

1. **Phase correlation** (FFT) for a global translation prior.
2. **Harris corners** on a fixed grid: corner response is pure convs; the
   top-K corners come from ``lax.top_k`` (static K).
3. **Patch NCC matching**: normalised 11x11 patches around each corner are
   correlated against a search window in the other image centred by the
   phase prior — one batched einsum.
4. **Vectorised RANSAC**: 256 homography hypotheses from random 4-subsets,
   solved by batched 8x9 DLT SVD and scored in parallel (``vmap``), inlier
   refit at the end. Replaces ``cv2.findHomography(..., RANSAC, 5.0)``
   (ref ``core.py:242-244``).
5. **DP seam** through the overlap difference (ref ``find_optimal_seam``
   ``core.py:122-178`` is an O(H·W) Python loop; here it is a ``lax.scan``
   over rows with parent backtracking by a reverse scan).
"""

from __future__ import annotations

from functools import partial
from typing import List, NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from pcmi_tpu.interface import Layer, SatellitePlugin
from pcmi_tpu.ops.filters import box_filter, gaussian_filter
from pcmi_tpu.ops.warp import homography_warp

HIGHEST = jax.lax.Precision.HIGHEST


# ---------------------------------------------------------------------------
# 1. phase correlation
# ---------------------------------------------------------------------------


@jax.jit
def phase_correlation(a: jnp.ndarray, b: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Translation (dy, dx) aligning ``b`` to ``a`` via the cross-power FFT.

    Inputs are zero-padded to 2x before the FFT so large shifts (side-by-side
    mosaics routinely exceed half the frame) don't alias circularly.
    """
    h, w = a.shape
    am = a - a.mean()
    bm = b - b.mean()
    ap = jnp.pad(am, ((0, h), (0, w)))
    bp = jnp.pad(bm, ((0, h), (0, w)))
    Fa = jnp.fft.fft2(ap)
    Fb = jnp.fft.fft2(bp)
    cross = Fa * jnp.conj(Fb)
    cross = cross / jnp.maximum(jnp.abs(cross), 1e-9)
    corr = jnp.abs(jnp.fft.ifft2(cross))
    idx = jnp.argmax(corr)
    H, W = 2 * h, 2 * w
    dy = idx // W
    dx = idx % W
    dy = jnp.where(dy > h, dy - H, dy).astype(jnp.float32)
    dx = jnp.where(dx > w, dx - W, dx).astype(jnp.float32)
    return dy, dx


# ---------------------------------------------------------------------------
# 2. Harris corners
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("n_corners", "border"))
def harris_corners(img: jnp.ndarray, n_corners: int = 256, k: float = 0.04,
                   border: int = 16):
    """Top-K Harris corner (y, x) positions + responses."""
    x = img.astype(jnp.float32)
    dy = (jnp.roll(x, -1, 0) - jnp.roll(x, 1, 0)) * 0.5
    dx = (jnp.roll(x, -1, 1) - jnp.roll(x, 1, 1)) * 0.5
    Ixx = gaussian_filter(dx * dx, 1.5)
    Iyy = gaussian_filter(dy * dy, 1.5)
    Ixy = gaussian_filter(dx * dy, 1.5)
    resp = Ixx * Iyy - Ixy**2 - k * (Ixx + Iyy) ** 2
    # non-max suppression over 5x5 + border exclusion
    nms = jax.lax.reduce_window(resp, -jnp.inf, jax.lax.max, (5, 5), (1, 1), "SAME")
    h, w = resp.shape
    ys = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    xs = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    ok = (resp == nms) & (ys >= border) & (ys < h - border) \
        & (xs >= border) & (xs < w - border)
    flat = jnp.where(ok, resp, -jnp.inf).reshape(-1)
    vals, idx = jax.lax.top_k(flat, n_corners)
    return jnp.stack([idx // w, idx % w], axis=1), vals


# ---------------------------------------------------------------------------
# 3. patch NCC matching around the phase prior
# ---------------------------------------------------------------------------


def _extract_patches(img: jnp.ndarray, pts: jnp.ndarray, size: int):
    """(N, size, size) patches centred at integer points (dynamic slices)."""
    r = size // 2
    padded = jnp.pad(img, r, mode="edge")

    def one(p):
        return jax.lax.dynamic_slice(padded, (p[0], p[1]), (size, size))

    return jax.vmap(one)(pts)


@partial(jax.jit, static_argnames=("patch", "search"))
def ncc_match(
    img1: jnp.ndarray, img2: jnp.ndarray, pts1: jnp.ndarray,
    prior_dy: jnp.ndarray, prior_dx: jnp.ndarray,
    patch: int = 11, search: int = 24,
):
    """For each corner in img1, the best NCC match in img2 within ±search
    of the phase-prior location. Returns (pts2, score)."""
    h, w = img2.shape
    p1 = _extract_patches(img1, pts1, patch)
    p1 = p1 - p1.mean(axis=(1, 2), keepdims=True)
    p1 = p1 / jnp.maximum(jnp.linalg.norm(p1, axis=(1, 2), keepdims=True), 1e-6)

    win = 2 * search + patch
    centers = jnp.stack([
        jnp.clip(pts1[:, 0] - jnp.round(prior_dy).astype(jnp.int32) - win // 2, 0, h - 1),
        jnp.clip(pts1[:, 1] - jnp.round(prior_dx).astype(jnp.int32) - win // 2, 0, w - 1),
    ], axis=1)
    padded2 = jnp.pad(img2, win, mode="edge")
    wins = jax.vmap(
        lambda c: jax.lax.dynamic_slice(padded2, (c[0] + win, c[1] + win), (win, win))
    )(centers)

    # Normalised cross-correlation as a GROUPED convolution: each corner's
    # unit-norm zero-mean patch is one depthwise filter over its own search
    # window (matmul work), and the per-position normaliser comes from two
    # box-sum convs — O(N·S²) memory instead of the O(N·S²·p²) unfold the
    # previous double-vmap form materialised. Since the template is
    # zero-mean, correlating the RAW window equals correlating the
    # mean-subtracted one, so scores are identical.
    S = 2 * search + 1
    n = p1.shape[0]
    lhs = wins[None].astype(jnp.float32)             # (1, N, win, win)
    dn = jax.lax.conv_dimension_numbers(
        lhs.shape, (n, 1, patch, patch), ("NCHW", "OIHW", "NCHW"))

    def gconv(x, rhs):
        return jax.lax.conv_general_dilated(
            x, rhs, (1, 1), "VALID", dimension_numbers=dn,
            feature_group_count=n, precision=HIGHEST)[0]  # (N, S, S)

    raw = gconv(lhs, p1[:, None])
    ones = jnp.ones((n, 1, patch, patch), jnp.float32)
    s1 = gconv(lhs, ones)
    s2 = gconv(lhs * lhs, ones)
    var = jnp.maximum(s2 - s1 * s1 / (patch * patch), 0.0)
    scores = raw / jnp.maximum(jnp.sqrt(var), 1e-6)  # (N, S, S)
    flat = scores.reshape(scores.shape[0], -1)
    best = jnp.argmax(flat, axis=1)
    sc = jnp.max(flat, axis=1)
    by = best // S
    bx = best % S
    pts2 = jnp.stack([
        centers[:, 0] + by + patch // 2,
        centers[:, 1] + bx + patch // 2,
    ], axis=1)
    return pts2, sc


# ---------------------------------------------------------------------------
# 3b. GMS-style spatial-consistency match prefilter
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=())
def spatial_consistency_filter(
    pts1: jnp.ndarray, pts2: jnp.ndarray, weights: jnp.ndarray,
    radius: float = 100.0, disp_tol: float = 10.0, min_support: int = 6,
):
    """Zero the weight of matches without local motion support.

    The reference prefilters feature matches by common-neighbourhood
    consistency before RANSAC (``image_stitching/core.py:62-117``, a
    GMS-style check over cKDTree neighbourhoods): correct matches on a
    rigid scene move like their neighbours, while the structured outliers
    of repetitive satellite texture (lattice-aliased matches one period
    off) do not — yet pass any NCC *score* threshold, since the texture
    really does repeat.

    Accelerator form: the N is small (corner budget, default 256), so the
    whole check is one dense O(N²) mask — distance matrix in the image-1
    frame, displacement-agreement matrix, and a support count — instead of
    a KD-tree. Match i survives only if ≥ ``min_support`` *other* live
    matches within ``radius`` px displace within ``disp_tol`` px of it.
    """
    v = (pts2 - pts1).astype(jnp.float32)
    d1 = jnp.linalg.norm(
        pts1[:, None, :].astype(jnp.float32) - pts1[None, :, :], axis=-1)
    dv = jnp.linalg.norm(v[:, None, :] - v[None, :, :], axis=-1)
    live = weights > 0
    near = (d1 <= radius) & ~jnp.eye(d1.shape[0], dtype=bool) & live[None, :]
    support = jnp.sum(near & (dv <= disp_tol), axis=1)
    return jnp.where(support >= min_support, weights, 0.0)


# ---------------------------------------------------------------------------
# 4. vectorised RANSAC homography
# ---------------------------------------------------------------------------


def _norm_transform(pts: jnp.ndarray, weights: jnp.ndarray | None = None):
    """Hartley normalisation: similarity T mapping points to mean 0 /
    RMS sqrt(2). Raw-pixel DLT mixes O(1) and O(coord^2) terms and loses
    most float32 significant digits on large frames."""
    w = jnp.ones(pts.shape[0]) if weights is None else weights
    wsum = jnp.maximum(jnp.sum(w), 1e-6)
    mu = jnp.sum(pts * w[:, None], axis=0) / wsum
    rms = jnp.sqrt(jnp.sum(w * jnp.sum((pts - mu) ** 2, axis=1)) / wsum)
    s = jnp.sqrt(2.0) / jnp.maximum(rms, 1e-6)
    # (y, x) points; T acts on homogeneous (x, y, 1)
    T = jnp.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]])
    T = T.at[0, 0].set(s).at[1, 1].set(s)
    T = T.at[0, 2].set(-s * mu[1]).at[1, 2].set(-s * mu[0])
    return T, mu, s


def _apply_norm(pts: jnp.ndarray, mu: jnp.ndarray, s: jnp.ndarray):
    return (pts - mu) * s


def _dlt(p1: jnp.ndarray, p2: jnp.ndarray,
         weights: jnp.ndarray | None = None) -> jnp.ndarray:
    """Homography p1 -> p2 from N>=4 correspondences ((y,x) order in, (x,y)
    math inside) via SVD of the 2N x 9 DLT system, Hartley-normalised."""
    T1, mu1, s1 = _norm_transform(p1, weights)
    T2, mu2, s2 = _norm_transform(p2, weights)
    p1n = _apply_norm(p1, mu1, s1)
    p2n = _apply_norm(p2, mu2, s2)
    x1 = p1n[:, 1]; y1 = p1n[:, 0]
    x2 = p2n[:, 1]; y2 = p2n[:, 0]
    z = jnp.zeros_like(x1)
    o = jnp.ones_like(x1)
    r1 = jnp.stack([x1, y1, o, z, z, z, -x2 * x1, -x2 * y1, -x2], axis=1)
    r2 = jnp.stack([z, z, z, x1, y1, o, -y2 * x1, -y2 * y1, -y2], axis=1)
    if weights is not None:
        r1 = r1 * weights[:, None]
        r2 = r2 * weights[:, None]
    A = jnp.concatenate([r1, r2], axis=0)
    _, _, vt = jnp.linalg.svd(A, full_matrices=True)
    Hn = vt[-1].reshape(3, 3)
    # denormalise: H = T2^-1 Hn T1 (T acts in (x, y) homogeneous coords)
    T2inv = jnp.linalg.inv(T2)
    Hm = T2inv @ Hn @ T1
    return Hm / jnp.where(jnp.abs(Hm[2, 2]) > 1e-12, Hm[2, 2], 1e-12)


def _project(Hm: jnp.ndarray, pts: jnp.ndarray) -> jnp.ndarray:
    """Apply homography to (N, 2) (y, x) points."""
    x = pts[:, 1]; y = pts[:, 0]
    d = Hm[2, 0] * x + Hm[2, 1] * y + Hm[2, 2]
    d = jnp.where(jnp.abs(d) > 1e-9, d, 1e-9)
    xn = (Hm[0, 0] * x + Hm[0, 1] * y + Hm[0, 2]) / d
    yn = (Hm[1, 0] * x + Hm[1, 1] * y + Hm[1, 2]) / d
    return jnp.stack([yn, xn], axis=1)


@partial(jax.jit, static_argnames=("n_hyp",))
def ransac_homography(
    pts1: jnp.ndarray, pts2: jnp.ndarray, weights: jnp.ndarray,
    key: jax.Array, thresh: float = 5.0, n_hyp: int = 256,
):
    """Best homography pts1->pts2 under inlier count; weighted final refit.

    All hypotheses are evaluated in parallel (vmap over ``n_hyp`` 4-point
    DLTs) — the batched form of the RANSAC loop in ``cv2.findHomography``.
    """
    n = pts1.shape[0]
    keys = jax.random.split(key, n_hyp)

    def hyp(k):
        p = (weights + 1e-9) / jnp.sum(weights + 1e-9)  # all-zero guard
        idx = jax.random.choice(k, n, shape=(4,), replace=False, p=p)
        Hm = _dlt(pts1[idx], pts2[idx])
        err = jnp.linalg.norm(_project(Hm, pts1) - pts2, axis=1)
        inl = (err < thresh) & (weights > 0)
        return jnp.sum(inl), Hm

    scores, Hs = jax.vmap(hyp)(keys)
    best = jnp.argmax(scores)
    Hm = Hs[best]
    err = jnp.linalg.norm(_project(Hm, pts1) - pts2, axis=1)
    inliers = (err < thresh) & (weights > 0)

    # final refit on all inliers (weighted, Hartley-normalised DLT)
    Hr = _dlt(pts1, pts2, weights=inliers.astype(jnp.float32))
    return Hr, inliers


def affine_fit(p1: jnp.ndarray, p2: jnp.ndarray, weights: jnp.ndarray):
    """Weighted 6-dof affine p1 -> p2 as a 3x3 homography (last row 0,0,1).

    The stable model for thin overlap strips, where a full homography's
    perspective terms are unconstrained and can go wild."""
    w = weights[:, None]
    X = jnp.concatenate([p1[:, 1:2], p1[:, 0:1], jnp.ones_like(w)], axis=1)
    sol, *_ = jnp.linalg.lstsq(X * w, jnp.stack([p2[:, 1], p2[:, 0]], 1) * w)
    Hm = jnp.eye(3)
    Hm = Hm.at[0, :].set(jnp.array([sol[0, 0], sol[1, 0], sol[2, 0]]))
    Hm = Hm.at[1, :].set(jnp.array([sol[0, 1], sol[1, 1], sol[2, 1]]))
    return Hm


# ---------------------------------------------------------------------------
# 5. DP seam + composition
# ---------------------------------------------------------------------------


@jax.jit
def dp_seam(energy: jnp.ndarray) -> jnp.ndarray:
    """Min-energy vertical seam column index per row (ref ``core.py:122-178``).

    Forward ``lax.scan`` accumulates the DP table rows; the seam is read
    back with a reverse scan over stored per-row parent choices.
    """
    h, w = energy.shape
    big = jnp.float32(1e9)

    def fwd(prev, row):
        left = jnp.concatenate([jnp.full((1,), big), prev[:-1]])
        right = jnp.concatenate([prev[1:], jnp.full((1,), big)])
        stacked = jnp.stack([left, prev, right])      # (3, W)
        choice = jnp.argmin(stacked, axis=0)          # 0=left,1=mid,2=right
        cur = row + jnp.min(stacked, axis=0)
        return cur, (cur, choice)

    last, (table, choices) = jax.lax.scan(fwd, jnp.zeros(w), energy)

    end = jnp.argmin(last).astype(jnp.int32)

    def back(carry, ch_row):
        j = carry
        move = ch_row[j] - 1                          # -1, 0, +1
        prev_j = jnp.clip(j + move, 0, w - 1)
        return prev_j, j

    _, seam_rev = jax.lax.scan(back, end, choices, reverse=True)
    return seam_rev  # (H,) column index per row


class StitchResult(NamedTuple):
    mosaic: jnp.ndarray
    homography: jnp.ndarray
    n_inliers: jnp.ndarray
    seam: jnp.ndarray
    canvas_offset: Tuple[int, int]


class ImageStitcher:
    """stitch(img1, img2): estimate H (img2->img1 frame), compose with a DP
    seam through the overlap (feathered around the seam)."""

    def __init__(self, n_corners: int = 256, patch: int = 11, search: int = 24,
                 ransac_thresh: float = 5.0, blend_width: int = 16):
        self.n_corners = n_corners
        self.patch = patch
        self.search = search
        self.ransac_thresh = ransac_thresh
        self.blend_width = blend_width

    def estimate(self, img1: jnp.ndarray, img2: jnp.ndarray, key=None):
        key = key if key is not None else jax.random.PRNGKey(0)
        # phase correlation needs a common shape: use the top-left overlap
        ch = min(img1.shape[0], img2.shape[0])
        cw = min(img1.shape[1], img2.shape[1])
        dy, dx = phase_correlation(img1[:ch, :cw], img2[:ch, :cw])
        pts1, resp = harris_corners(img1, self.n_corners)
        pts2, score = ncc_match(img1, img2, pts1, dy, dx,
                                patch=self.patch, search=self.search)
        wts = jnp.where(score > 0.5, score, 0.0)
        # spatial-consistency prefilter: NCC score alone passes
        # lattice-aliased matches on repetitive texture (ref
        # core.py:62-117 runs the same check before RANSAC)
        wts = spatial_consistency_filter(pts1.astype(jnp.float32),
                                         pts2.astype(jnp.float32), wts)
        p1f = pts1.astype(jnp.float32)
        p2f = pts2.astype(jnp.float32)
        Hm, inl = ransac_homography(p1f, p2f, wts, key,
                                    thresh=self.ransac_thresh)
        return Hm, inl, p1f, p2f

    def stitch(self, img1: jnp.ndarray, img2: jnp.ndarray, key=None,
               min_inliers: int = 8) -> StitchResult:
        img1 = jnp.asarray(img1, jnp.float32)
        img2 = jnp.asarray(img2, jnp.float32)
        Hm, inl, p1f, p2f = self.estimate(img1, img2, key)

        # match-quality guard (cv2.findHomography returns None in the same
        # situation, which the reference handles): without enough inliers
        # the homography is garbage and the canvas below can explode
        n_inl = int(jnp.sum(inl))
        if n_inl < min_inliers:
            raise ValueError(
                f"stitching failed: only {n_inl} consistent matches "
                f"(need >= {min_inliers}) — do the images overlap?"
            )

        h1, w1 = img1.shape
        h2, w2 = img2.shape

        def canvas_of(Hn):
            if not np.isfinite(Hn).all() or abs(np.linalg.det(Hn)) < 1e-9:
                return None
            Hinv = np.linalg.inv(Hn)
            corners = np.array(
                [[0, 0], [0, w2 - 1], [h2 - 1, 0], [h2 - 1, w2 - 1]],
                np.float32)
            proj = np.asarray(_project(jnp.asarray(Hinv, jnp.float32),
                                       jnp.asarray(corners)))
            y0 = int(np.floor(min(0.0, proj[:, 0].min())))
            x0 = int(np.floor(min(0.0, proj[:, 1].min())))
            y1 = int(np.ceil(max(h1 - 1.0, proj[:, 0].max()))) + 1
            x1 = int(np.ceil(max(w1 - 1.0, proj[:, 1].max()))) + 1
            ch, cw = y1 - y0, x1 - x0
            if ch * cw > 16 * (h1 * w1 + h2 * w2):
                return None  # wild perspective -> multi-GB canvas
            return Hinv, y0, x0, ch, cw

        # canvas bounds: project img2 corners into img1 frame (host math,
        # mirrors ref core.py:250-273). Thin overlap strips underconstrain
        # the perspective terms; fall back to the 6-dof affine fit when the
        # full homography goes wild.
        bounds = canvas_of(np.asarray(Hm))
        if bounds is None:
            Hm = affine_fit(p1f, p2f, inl.astype(jnp.float32))
            bounds = canvas_of(np.asarray(Hm))
        if bounds is None:
            raise ValueError("stitching failed: degenerate geometry even "
                             "under the affine fallback")
        Hinv, y0, x0, ch, cw = bounds
        Hn = np.asarray(Hm)

        # warp both onto the canvas (translation for img1; H∘T for img2)
        T = np.array([[1.0, 0, y0], [0, 1, x0], [0, 0, 1]])  # canvas->img1 (y,x)
        # homography_warp expects pixel transform in (x, y): build from (y,x)
        def yx_to_xy(M):
            P = np.array([[0, 1, 0], [1, 0, 0], [0, 0, 1.0]])
            return P @ M @ P
        H1c = jnp.asarray(yx_to_xy(T), jnp.float32)
        H2c = jnp.asarray(yx_to_xy(Hn @ T), jnp.float32)
        warp1 = homography_warp(img1, H1c, (ch, cw), fill=jnp.nan)
        warp2 = homography_warp(img2, H2c, (ch, cw), fill=jnp.nan)

        m1 = jnp.isfinite(warp1)
        m2 = jnp.isfinite(warp2)
        overlap = m1 & m2
        diff = jnp.where(overlap, jnp.abs(warp1 - warp2), 0.0)
        # energy outside the overlap is high so the seam stays inside it
        energy = jnp.where(overlap, diff, 1e3)
        seam = dp_seam(energy)

        xs = jax.lax.broadcasted_iota(jnp.int32, (ch, cw), 1)
        side1 = xs < seam[:, None]
        # feathered alpha around the seam (ref feathers with blend_width 5)
        dist = (xs - seam[:, None]).astype(jnp.float32)
        alpha = jnp.clip(0.5 - dist / (2 * self.blend_width), 0.0, 1.0)
        w1_ = jnp.where(m1, jnp.where(m2, alpha, 1.0), 0.0)
        w2_ = jnp.where(m2, jnp.where(m1, 1.0 - alpha, 1.0), 0.0)
        total = jnp.maximum(w1_ + w2_, 1e-6)
        mosaic = (jnp.nan_to_num(warp1) * w1_ + jnp.nan_to_num(warp2) * w2_) / total
        mosaic = jnp.where(m1 | m2, mosaic, jnp.nan)
        return StitchResult(
            mosaic=mosaic, homography=Hm,
            n_inliers=jnp.sum(inl), seam=seam, canvas_offset=(y0, x0),
        )


class ImageStitchingPlugin(SatellitePlugin):
    """Two-image plugin (ref ``image_stitching/plugin.py:5-127`` — the host
    introspects the ``image2`` kwarg to show a second picker)."""

    def __init__(self, stitcher: ImageStitcher | None = None):
        self.stitcher = stitcher or ImageStitcher()

    @property
    def name(self) -> str:
        return "Image Stitching"

    def run(self, image: np.ndarray, viewer=None, image2: np.ndarray = None) -> List[Layer]:
        if image2 is None:
            raise ValueError("stitching needs image2")
        a = np.asarray(image, np.float32)
        b = np.asarray(image2, np.float32)
        if a.ndim == 3:
            a = a.mean(-1)
        if b.ndim == 3:
            b = b.mean(-1)
        res = self.stitcher.stitch(jnp.asarray(a), jnp.asarray(b))
        return [
            (image, {"name": "image 1"}, "image"),
            (image2, {"name": "image 2"}, "image"),
            (np.asarray(res.mosaic), {"name": "mosaic"}, "image"),
        ]
