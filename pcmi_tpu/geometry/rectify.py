"""Affine epipolar rectification + triangulation — the ASP replacement.

The reference shells out to Ames Stereo Pipeline (``stereo -t rpc
--stop-point=1``) for epipolar rectification (``processing.py:12-18,61-83``)
and reads back ASP's affine alignment matrix (``disparity.py:38-44``). Here
rectification is closed-form affine epipolar geometry:

1. Fit affine cameras to both RPCs over an AOI probe lattice
   (:func:`pcmi_tpu.geometry.affine.fit_affine_camera`).
2. Fit the *affine fundamental matrix*: correspondences satisfy
   ``a*x2 + b*y2 + c*x1 + d*y1 + e = 0`` — a single linear constraint,
   recovered by SVD over probe projections (exact for affine cameras).
3. Rotate image 1 so epipolar lines are horizontal; map image 2 with the
   affine transform that makes ``y2' == y1'`` identically. Disparity is then
   purely horizontal, as dense stereo requires.
4. Triangulation: with rectified affine cameras the 4 observation equations
   are linear with a *constant* design matrix, so 3D recovery is one
   precomputed (3, 4) matrix applied per pixel — one batched matmul.

Geometry solves run on host in float64 numpy (tiny: 5-vector SVD); warps and
triangulation are jitted JAX.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from pcmi_tpu.geometry.affine import AffineCamera, LocalFrame, fit_affine_camera
from pcmi_tpu.geometry.rpc import RPCCamera
from pcmi_tpu.ops.warp import affine_warp, invert_affine


def fit_affine_fundamental(p1: np.ndarray, p2: np.ndarray) -> np.ndarray:
    """Fit (a, b, c, d, e) with ``a x2 + b y2 + c x1 + d y1 + e = 0``.

    ``p1``/``p2`` are (N, 2) corresponding pixels. Centred SVD — the affine
    analogue of the 8-point algorithm (Hartley & Zisserman §14.2).
    """
    p1 = np.asarray(p1, np.float64)
    p2 = np.asarray(p2, np.float64)
    m1 = p1.mean(0)
    m2 = p2.mean(0)
    X = np.concatenate([p2 - m2, p1 - m1], axis=1)  # (N, 4)
    _, _, vt = np.linalg.svd(X, full_matrices=False)
    abcd = vt[-1]
    e = -float(abcd[:2] @ m2 + abcd[2:] @ m1)
    return np.concatenate([abcd, [e]])


@dataclass(frozen=True)
class RectifiedGeometry:
    """Host-side rectification result (plain numpy, hashable-ish)."""

    H1: np.ndarray          # (2, 3) image1 -> rectified1
    H2: np.ndarray          # (2, 3) image2 -> rectified2
    out_shape: tuple        # (H, W) common rectified canvas
    cam1_rect: AffineCamera  # rectified affine cameras (local frame)
    cam2_rect: AffineCamera
    frame: LocalFrame
    epipolar_residual: float  # max |y1' - y2'| over probes, px
    disp_gain: float        # disparity = disp_gain * (height - h_mid), px/m
    h_mid: float            # height at which disparity is zero (m)


def _compose(H: np.ndarray, cam: AffineCamera) -> AffineCamera:
    """Rectified camera = 2x3 pixel transform ∘ affine camera.

    Host float64: JAX's default matmul precision truncates f32 dots to
    bfloat16 on accelerator backends, which costs ~0.5 m of height accuracy
    if it leaks into camera composition.
    """
    L = np.asarray(H[:, :2], np.float64)
    t = np.asarray(H[:, 2], np.float64)
    A = L @ np.asarray(cam.A, np.float64)
    b = L @ np.asarray(cam.b, np.float64) + t
    return AffineCamera(A=jnp.asarray(A, jnp.float32), b=jnp.asarray(b, jnp.float32))


def compute_rectification(
    cam1: AffineCamera,
    cam2: AffineCamera,
    frame: LocalFrame,
    probes_local: np.ndarray,
    shape1: tuple,
    shape2: tuple,
    pad_multiple: int = 128,
) -> RectifiedGeometry:
    """Derive rectifying 2x3 transforms from two affine cameras.

    ``probes_local`` is an (N, 3) lattice in the local metric frame spanning
    the AOI volume; it determines the epipolar fit and output bounds.
    ``shape1``/``shape2`` are reserved: the rectified canvas derives from
    the probe projections only and is NOT clipped to the image footprints
    (out-of-footprint samples come back as the -1 fill after warping).
    """
    P = np.asarray(probes_local, np.float64)
    p1 = P @ np.asarray(cam1.A, np.float64).T + np.asarray(cam1.b, np.float64)
    p2 = P @ np.asarray(cam2.A, np.float64).T + np.asarray(cam2.b, np.float64)

    a, b, c, d, e = fit_affine_fundamental(p1, p2)
    n1 = float(np.hypot(c, d))
    n2 = float(np.hypot(a, b))

    # Image 1: rotate epipolar direction (-d, c)/n1 onto +x.
    dir1 = np.array([-d, c]) / n1
    H1 = np.array([
        [dir1[0], dir1[1], 0.0],
        [-c / n1, -d / n1, 0.0],
    ])
    # Image 2: y chosen so y2' == y1' identically:
    #   y1' = -(c x1 + d y1)/n1 = (a x2 + b y2 + e)/n1.
    # For x, exploit that x1' is *exactly* affine in (x2, y2, z) for affine
    # cameras:  x1' = alpha x2 + beta y2 + delta z + gamma.  Taking image 2's
    # x-row as (alpha, beta | gamma + delta h_mid) aligns the two rectified
    # images at the mid reference height, so disparity becomes exactly
    # d = x1' - x2' = delta (z - h_mid): a centred, height-proportional
    # search range — the role of ASP's out-align-L.txt alignment transform
    # (reference disparity.py:38-44) derived in closed form.
    x1p = p1 @ dir1
    h_mid = float(np.median(P[:, 2]))
    design = np.stack([p2[:, 0], p2[:, 1], P[:, 2], np.ones(len(P))], axis=1)
    (alpha, beta, delta, gamma), *_ = np.linalg.lstsq(design, x1p, rcond=None)
    x_resid = float(np.abs(design @ [alpha, beta, delta, gamma] - x1p).max())
    H2 = np.array([
        [alpha, beta, gamma + delta * h_mid],
        [a / n1, b / n1, e / n1],
    ])

    # Residual sanity: probes must land on identical rows, and the x-model
    # must hold (both exact for affine cameras; small for true RPCs).
    y1p = p1 @ H1[1, :2] + H1[1, 2]
    y2p = p2 @ H2[1, :2] + H2[1, 2]
    resid = max(float(np.abs(y1p - y2p).max()), x_resid)

    # Common canvas: translate so AOI probes start at (0, 0); pad to lane
    # multiples for jit-friendly static shapes.
    x1r = p1 @ H1[0, :2] + H1[0, 2]
    x2r = p2 @ H2[0, :2] + H2[0, 2]
    tx = -min(x1r.min(), x2r.min())
    ty = -min(y1p.min(), y2p.min())
    H1[:, 2] += [tx, ty]
    H2[:, 2] += [tx, ty]

    def _pad(v):
        return int(np.ceil(v / pad_multiple) * pad_multiple)

    width = _pad(max(x1r.max(), x2r.max()) + tx + 1)
    height = _pad(max(y1p.max(), y2p.max()) + ty + 1)

    return RectifiedGeometry(
        H1=H1, H2=H2, out_shape=(height, width),
        cam1_rect=_compose(H1, cam1), cam2_rect=_compose(H2, cam2),
        frame=frame, epipolar_residual=resid,
        disp_gain=float(delta), h_mid=h_mid,
    )


from functools import partial


@partial(jax.jit, static_argnames=("out_shape", "fill"))
def rectify_arrays(img1, img2, H1, H2, out_shape, fill=-1.0):
    """Warp both images onto the rectified canvas (bilinear, jitted).

    The array-only core shared by every production path (pipelines, bench,
    streaming); ``rectify_images`` is the geometry-object convenience view.
    Fill value -1 follows the reference's undefined-pixel sentinel
    (``processing.py:21-41``); downstream masks are ``img >= 0``.
    """
    r1 = affine_warp(img1, invert_affine(H1), out_shape, fill=fill)
    r2 = affine_warp(img2, invert_affine(H2), out_shape, fill=fill)
    return r1, r2


def rectify_images(geom: RectifiedGeometry, img1: jnp.ndarray, img2: jnp.ndarray,
                   fill: float = -1.0):
    """Geometry-object wrapper over :func:`rectify_arrays`."""
    return rectify_arrays(
        img1, img2,
        jnp.asarray(geom.H1, jnp.float32), jnp.asarray(geom.H2, jnp.float32),
        geom.out_shape, fill=fill,
    )


def triangulate_from_operator(
    disparity: jnp.ndarray,
    tri_M: jnp.ndarray,
    tri_b: jnp.ndarray,
    row0=0.0,
):
    """Dense disparity -> (H, W, 3) local-frame points, given the constant
    triangulation operator. Convention ``x2 = x1 - d``; ``row0`` offsets the
    rows for band tiles of a larger canvas. The single shared
    implementation behind both the geometry API and the pipeline core."""
    h, w = disparity.shape
    ys = jax.lax.broadcasted_iota(jnp.float32, (h, w), 0) + row0
    xs = jax.lax.broadcasted_iota(jnp.float32, (h, w), 1)
    x2 = xs - disparity.astype(jnp.float32)
    obs = jnp.stack([xs, ys, x2, ys], axis=-1)
    # HIGHEST precision: default (bf16) matmul would cost metres of height.
    return jnp.einsum("hwk,ck->hwc", obs - tri_b, tri_M,
                      precision=jax.lax.Precision.HIGHEST)


def triangulation_operator(geom: RectifiedGeometry):
    """Precompute the constant (3, 4) triangulation solve matrix.

    Rectified observations per pixel are ``obs = (x1', y', x2', y')``;
    the cameras give ``obs = A_stack @ X + b_stack`` with constant
    ``A_stack (4,3)``. Returns ``(M, b)`` with ``X = M @ (obs - b)`` in the
    least-squares sense (pinv), so triangulating a full image is one matmul.
    """
    A_stack = np.concatenate(
        [np.asarray(geom.cam1_rect.A, np.float64), np.asarray(geom.cam2_rect.A, np.float64)]
    )
    b_stack = np.concatenate(
        [np.asarray(geom.cam1_rect.b, np.float64), np.asarray(geom.cam2_rect.b, np.float64)]
    )
    M = np.linalg.pinv(A_stack)  # (3, 4), float64 host solve
    return jnp.asarray(M, jnp.float32), jnp.asarray(b_stack, jnp.float32)


def triangulate_disparity(
    geom: RectifiedGeometry,
    disparity: jnp.ndarray,
    valid: jnp.ndarray | None = None,
):
    """Dense disparity -> local-frame 3D points + height map.

    ``disparity`` is (H, W) with the convention ``x2' = x1' - d`` (positive
    disparity shifts left, the SGBM sign convention the reference uses via
    ``minDisparity=-MAX_DISP/2`` at ``disparity.py:265``).

    Returns ``(xyz, height)`` where ``xyz`` is (H, W, 3) in the local metric
    frame and ``height = xyz[..., 2]``.
    """
    M, b = triangulation_operator(geom)
    xyz = triangulate_from_operator(disparity, M, b)
    height = xyz[..., 2]
    if valid is not None:
        height = jnp.where(valid, height, jnp.nan)
    return xyz, height


def build_geometry_from_rpcs(
    rpc1: RPCCamera,
    rpc2: RPCCamera,
    lon_range,
    lat_range,
    h_range,
    shape1,
    shape2,
    grid=(8, 8, 5),
    pad_multiple: int = 128,
) -> RectifiedGeometry:
    """End-to-end: RPC pair + AOI volume -> rectification geometry.

    The one-call replacement for the reference's crop -> ASP stereo
    --stop-point=1 stage (``preprocessing.py:68-96`` + ``processing.py:61-83``).
    """
    from pcmi_tpu.geometry.affine import probe_grid

    frame = LocalFrame(
        lon0=jnp.float32(0.5 * (lon_range[0] + lon_range[1])),
        lat0=jnp.float32(0.5 * (lat_range[0] + lat_range[1])),
    )
    llh = probe_grid(lon_range, lat_range, h_range, grid)
    cam1 = fit_affine_camera(rpc1, frame, llh)
    cam2 = fit_affine_camera(rpc2, frame, llh)
    x, y, z = frame.to_local_np(llh[:, 0], llh[:, 1], llh[:, 2])
    probes_local = np.stack([x, y, z], axis=1)
    return compute_rectification(
        cam1, cam2, frame, probes_local, shape1, shape2, pad_multiple
    )
