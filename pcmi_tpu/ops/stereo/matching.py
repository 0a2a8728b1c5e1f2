"""Dense stereo matcher: census+AD cost, box/SGM aggregation, WTA.

The XLA-path implementation of the reference's OpenCV SGBM + WLS stage
(``disparity.py:263-310``): signed disparity search over
``[-max_disp/2, max_disp/2)`` (SGBM ``minDisparity=-MAX_DISP/2``,
``disparity.py:265-267``), census-hamming + absolute-difference matching
cost, 15x15 block aggregation (``BLOCK_SIZE_DISP``, ``constants.py:58``),
4-path semi-global aggregation standing in for SGBM's smoothness term, WTA
with parabola sub-pixel interpolation, and L/R consistency
(``disparity.py:229-250``).

Everything is jit-compiled; the cost volume is built by a ``lax.scan`` over
disparities (static shapes, no data-dependent control flow). SGM runs as
``lax.scan`` recurrences along each of 4 directions with (D, span) carries,
or on a GPU as the Pallas kernel in
:mod:`pcmi_tpu.ops.stereo.pallas_kernels` (``StereoConfig.sgm_backend``).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from pcmi_tpu.config import StereoConfig


def _cost_dtype(cfg: StereoConfig):
    """Storage dtype for cost/aggregation volumes (see StereoConfig.cost_dtype)."""
    if cfg.cost_dtype == "auto":
        return jnp.float32
    return jnp.dtype(cfg.cost_dtype)


def _scan_unroll() -> int:
    """Unroll factor for the disparity/SGM scans.

    On a GPU every scan step is its own set of kernel launches, so
    unrolling amortises them (H100, d288 pair core at 1152^2: 147 ms at
    unroll 1, 50 ms at unroll 8); on the CPU test backend unrolling only
    multiplies compile and run time. Resolved at trace time.
    """
    return 8 if jax.default_backend() == "gpu" else 1


def _use_sgm_kernel(cfg: StereoConfig) -> bool:
    """Whether SGM runs as the Pallas (Triton) kernel: ``sgm_backend``
    "auto" takes it where the default backend is a GPU, "pallas" always
    (it cannot compile for the CPU, which then raises), "xla" never."""
    if cfg.sgm_backend == "auto":
        return jax.default_backend() == "gpu"
    return cfg.sgm_backend == "pallas"


class DisparityResult(NamedTuple):
    disparity: jnp.ndarray   # (H, W) float32, signed px
    valid: jnp.ndarray       # (H, W) bool — passed L/R consistency & masks
    cost: jnp.ndarray        # (H, W) float32 best aggregated cost
    disparity_right: jnp.ndarray  # (H, W) float32 right-image disparity
    # WTA uniqueness: (second best cost outside ±1 of the winner) − (best).
    # The confidence SGBM expresses as uniquenessRatio; low margin = flat or
    # bimodal cost curve (occlusion / fattening / weak texture).
    margin: jnp.ndarray | None = None
    # Independent cross-matcher estimate (band recovery);
    # None unless cfg.band_recover.
    check_disparity: jnp.ndarray | None = None
    # The cross-matcher's own WTA uniqueness margin (vertical mode only):
    # extra recovery evidence against correlated-fattening agreement.
    check_margin: jnp.ndarray | None = None


def census_transform(img: jnp.ndarray, window: int = 7):
    """Census transform into two uint32 planes (bit-exact vs numpy_ref)."""
    if window > 7 or window < 3 or window % 2 == 0:
        raise ValueError(
            f"census_window must be an odd value in [3, 7] (got {window}): "
            f"two uint32 planes hold at most 48 neighbour bits"
        )
    h, w = img.shape
    r = window // 2
    padded = jnp.pad(img, r, mode="edge")
    bits0 = jnp.zeros((h, w), jnp.uint32)
    bits1 = jnp.zeros((h, w), jnp.uint32)
    idx = 0
    for dy in range(window):
        for dx in range(window):
            if dy == r and dx == r:
                continue
            neigh = jax.lax.dynamic_slice(padded, (dy, dx), (h, w))
            bit = (neigh < img).astype(jnp.uint32)
            if idx < 24:
                bits0 = bits0 | (bit << jnp.uint32(idx))
            else:
                bits1 = bits1 | (bit << jnp.uint32(idx - 24))
            idx += 1
    return bits0, bits1


def _sliding_sum(padded: jnp.ndarray, k: int, axis: int,
                 out_len: int) -> jnp.ndarray:
    """Length-``k`` sliding sum along ``axis`` via log-doubling.

    ``out[..., i, ...] = sum_{j<k} padded[..., i+j, ...]``. A naive tap
    loop costs ``k-1`` adds per element; doubling partial windows
    (``s_2w[i] = s_w[i] + s_w[i+w]``) and combining the binary
    decomposition of ``k`` costs ``floor(log2 k) + popcount(k) - 1``
    (4 for the default block of 9). The matcher applies this per volume
    slice, so the add count is the box filter's entire cost."""
    sums = {1: padded}
    w = 1
    while 2 * w <= k:
        a = sums[w]
        n = a.shape[axis]
        sums[2 * w] = (jax.lax.slice_in_dim(a, 0, n - w, axis=axis)
                       + jax.lax.slice_in_dim(a, w, n, axis=axis))
        w *= 2
    acc = None
    off = 0
    for w in sorted(sums, reverse=True):
        while off + w <= k:
            sl = jax.lax.slice_in_dim(sums[w], off, off + out_len, axis=axis)
            acc = sl if acc is None else acc + sl
            off += w
    return acc


def _vertical_box(vol: jnp.ndarray, k: int) -> jnp.ndarray:
    """Vertical-only (edge-padded) mean over the H axis of a (D, H, W)
    volume — the aggregation of the vertical-support cross-checker, whose
    horizontal fattening radius must stay ~0."""
    r = k // 2
    p = jnp.pad(vol, ((0, 0), (r, r), (0, 0)), mode="edge")
    return _sliding_sum(p, k, 1, vol.shape[1]) / k


def _box_edge(img: jnp.ndarray, block: int) -> jnp.ndarray:
    """Edge-padded mean filter matching ``numpy_ref.box_aggregate_np``."""
    r = block // 2
    out = img
    for axis in (0, 1):
        pad_width = [(0, 0), (0, 0)]
        pad_width[axis] = (r, r)
        padded = jnp.pad(out, pad_width, mode="edge")
        out = _sliding_sum(padded, block, axis, out.shape[axis]) / block
    return out


def shift_rows(img: jnp.ndarray, shifts: jnp.ndarray, pad: int, fill,
               chunk: int = 1):
    """out(y, x) = img(y, x - shifts[...]) — the column warp behind the
    banded adaptive-range search (:mod:`pcmi_tpu.ops.stereo.banded`).

    ``shifts`` is int32, one of:

    * (H,) — one contiguous slice per row, no gathers;
    * (H, W) with ``chunk == 1`` — a per-pixel horizontal gather;
    * (H, W // chunk) with ``chunk > 1`` — one shift per ``chunk``-px
      span: H*W/chunk contiguous ``chunk``-element slices, which XLA
      lowers to a gather with ``chunk``-wide slices (lane-friendly).

    Matches the matcher's shift convention (``r_shift(x) = right(x - d)``
    via slice start ``pad - d``), so matching left against
    ``shift_rows(right, o)`` at local disparity ``dl`` compares against
    ``right(x - (o + dl))`` — global ``d = o + dl``.
    """
    h, w = img.shape
    padded = jnp.pad(img, ((0, 0), (pad, pad)), constant_values=fill)
    if shifts.ndim == 1:
        def take(row, s):
            return jax.lax.dynamic_slice_in_dim(row, pad - s, w)

        return jax.vmap(take)(padded, shifts)
    if chunk > 1:
        nc = w // chunk
        if nc * chunk != w or shifts.shape != (h, nc):
            raise ValueError(f"chunked shifts must be (H, W/chunk); got "
                             f"{shifts.shape} for W={w}, chunk={chunk}")
        starts = (pad + jnp.arange(nc, dtype=jnp.int32)[None, :] * chunk
                  - shifts)  # (H, nc)

        def take_row(prow, srow):
            sl = jax.vmap(
                lambda s: jax.lax.dynamic_slice(prow, (s,), (chunk,))
            )(srow)
            return sl.reshape(-1)

        return jax.vmap(take_row)(padded, starts)
    idx = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1) + pad - shifts
    return jnp.take_along_axis(padded, idx, axis=1)


def _shift_pack(right, valid_r, census_r, max_disp):
    """Pre-pad right-image planes so any signed shift is a dynamic slice
    (no gathers in the scan body). The signed search spans
    [-max_disp/2, max_disp/2), so half the width (+1 slack) suffices."""
    pad = max_disp // 2 + 1
    rp = jnp.pad(right, ((0, 0), (pad, pad)))
    vp = jnp.pad(valid_r, ((0, 0), (pad, pad)))
    c0 = jnp.pad(census_r[0], ((0, 0), (pad, pad)))
    c1 = jnp.pad(census_r[1], ((0, 0), (pad, pad)))
    return rp, vp, c0, c1, pad


def build_cost_volume(
    left: jnp.ndarray,
    right: jnp.ndarray,
    valid_l: jnp.ndarray,
    valid_r: jnp.ndarray,
    cfg: StereoConfig,
    row_shift: jnp.ndarray | None = None,
    row_shift_pad: int = 0,
    row_shift_chunk: int = 1,
) -> jnp.ndarray:
    """(D, H, W) float32 aggregated matching cost via scan over disparities.

    ``row_shift`` (the banded adaptive-range path) searches global
    disparity ``row_shift[...] + d`` at volume slice d: census planes are
    computed on the UNWARPED right view and shifted afterwards, so the
    per-pixel cost is bit-exactly the full-search cost at the composed
    disparity — a naive pre-warp would shear the right image's vertical
    structure and corrupt every census descriptor near offset ramps.
    ``row_shift_pad`` must bound ``max |row_shift|`` (static);
    ``row_shift_chunk`` is :func:`shift_rows`'s chunk width.
    """
    h, w = left.shape
    n_census = cfg.census_window**2 - 1
    census_l = census_transform(left, cfg.census_window)
    census_r = census_transform(right, cfg.census_window)
    if row_shift is not None:
        sp = row_shift_pad
        ck = row_shift_chunk
        right = shift_rows(right, row_shift, sp, 0.0, chunk=ck)
        valid_r = shift_rows(valid_r, row_shift, sp, False, chunk=ck)
        census_r = (
            shift_rows(census_r[0], row_shift, sp, jnp.uint32(0), chunk=ck),
            shift_rows(census_r[1], row_shift, sp, jnp.uint32(0), chunk=ck))
    rp, vp, c0p, c1p, pad = _shift_pack(right, valid_r, census_r, cfg.max_disp)

    def step(_, d):
        start = pad - d
        r = jax.lax.dynamic_slice_in_dim(rp, start, w, axis=1)
        v = jax.lax.dynamic_slice_in_dim(vp, start, w, axis=1)
        s0 = jax.lax.dynamic_slice_in_dim(c0p, start, w, axis=1)
        s1 = jax.lax.dynamic_slice_in_dim(c1p, start, w, axis=1)
        ham = (
            jax.lax.population_count(census_l[0] ^ s0)
            + jax.lax.population_count(census_l[1] ^ s1)
        ).astype(jnp.float32)
        census_cost = ham / n_census
        ad = jnp.minimum(jnp.abs(left - r), 0.5) / 0.5
        cost = (1.0 - cfg.ad_weight) * census_cost + cfg.ad_weight * ad
        cost = jnp.where(valid_l & v, cost, 1.0)
        # aggregate in f32, store in the volume dtype (cost_dtype)
        return None, _box_edge(cost, cfg.block_size).astype(_cost_dtype(cfg))

    # disp_stride > 1 searches every s-th disparity (volume slice i holds
    # d = d_min + i*s) — every D-proportional stage downstream halves
    ds = jnp.arange(0, cfg.max_disp, cfg.disp_stride,
                    dtype=jnp.int32) + cfg.min_disparity
    _, vol = jax.lax.scan(step, None, ds, unroll=_scan_unroll())
    return vol


def _sgm_scan(vol_t: jnp.ndarray, p1: float, p2: float, reverse: bool):
    """One SGM direction over the leading axis of ``vol_t`` (S, D, span).

    Recurrence (Hirschmüller 2008):
      L(p,d) = C(p,d) + min(L', L'[d±1]+P1, min L' + P2) - min L'
    """
    big = jnp.float32(1e9)

    def step(prev, c):
        m = jnp.min(prev, axis=0, keepdims=True)
        up = jnp.concatenate([jnp.full_like(prev[:1], big), prev[:-1]], axis=0)
        dn = jnp.concatenate([prev[1:], jnp.full_like(prev[:1], big)], axis=0)
        best = jnp.minimum(
            jnp.minimum(prev, m + p2),
            jnp.minimum(up + p1, dn + p1),
        )
        cur = c + best - m
        return cur, cur

    init = jnp.zeros_like(vol_t[0])  # (D, span)
    _, out = jax.lax.scan(step, init, vol_t, reverse=reverse, unroll=_scan_unroll())
    return out


def sgm_aggregate(vol: jnp.ndarray, cfg: StereoConfig,
                  dirs: str = "4") -> jnp.ndarray:
    """Semi-global aggregation of a (D, H, W) cost volume.

    ``dirs`` — "4" (L→R, R→L, T→B, B→T), "h" (the two horizontal paths
    only, at half the cost; used for the right-view volume whose sole
    consumer is the L/R consistency check — measured quality-neutral
    there), or "v" (the two vertical paths only; used by the
    vertical-support cross-checker, whose independence from horizontal
    fattening is the whole point).

    Dispatches to the GPU kernel per ``cfg.sgm_backend``
    (:func:`_use_sgm_kernel`); the scan formulation below is the
    reference it is exact against."""
    if _use_sgm_kernel(cfg):
        from pcmi_tpu.ops.stereo.pallas_kernels import sgm_aggregate_pallas

        return sgm_aggregate_pallas(vol, cfg.sgm_p1, cfg.sgm_p2, dirs=dirs)
    p1, p2 = cfg.sgm_p1, cfg.sgm_p2
    dt = vol.dtype
    vol = vol.astype(jnp.float32)  # scan path computes in f32 regardless
    horiz = None
    if dirs in ("4", "h"):
        # horizontal paths: scan over W with (D, H) state
        vol_w = jnp.transpose(vol, (2, 0, 1))  # (W, D, H)
        lr = _sgm_scan(vol_w, p1, p2, reverse=False)
        rl = _sgm_scan(vol_w, p1, p2, reverse=True)
        horiz = jnp.transpose(lr + rl, (1, 2, 0))  # (D, H, W)
        if dirs == "h":
            return (horiz / 2.0).astype(dt)
    # vertical paths: scan over H with (D, W) state
    vol_h = jnp.transpose(vol, (1, 0, 2))  # (H, D, W)
    tb = _sgm_scan(vol_h, p1, p2, reverse=False)
    bt = _sgm_scan(vol_h, p1, p2, reverse=True)
    vert = jnp.transpose(tb + bt, (1, 0, 2))  # (D, H, W)
    if dirs == "v":
        return (vert / 2.0).astype(dt)
    return ((horiz + vert) / cfg.sgm_paths).astype(dt)


def wta_disparity(vol: jnp.ndarray, d_min: int, with_margin: bool = False,
                  subpixel: bool = True, stride: int = 1):
    """Argmin over D + parabola sub-pixel (matches numpy_ref semantics).

    The best/prev/next costs are extracted with masked reductions over D,
    which XLA fuses with the argmin into sibling reductions.

    ``with_margin`` adds a fourth reduction computing the uniqueness margin
    (second-best cost at |d − best_d| > 1, minus best) and returns a
    3-tuple ``(disp, best, margin)``. ``subpixel=False`` skips the parabola
    (two of the volume passes) and returns integer disparities — enough for
    the right-view estimate feeding the L/R check.

    ``stride`` is the disparity spacing between volume slices
    (``StereoConfig.disp_stride``): slice i holds d = d_min + i*stride and
    the parabola interpolates at that spacing (offset scaled by stride).
    """
    D = vol.shape[0]
    best_d = jnp.argmin(vol, axis=0).astype(jnp.int32)  # (H, W)
    ds = jax.lax.broadcasted_iota(jnp.int32, vol.shape, 0)
    big = jnp.asarray(1e9, vol.dtype)
    # volumes may be stored bf16 (cost_dtype): reductions stream the stored
    # dtype, all 2D-plane arithmetic below happens in f32
    best = jnp.min(vol, axis=0).astype(jnp.float32)
    if subpixel:
        sel = ds == best_d[None]
        vol_up = jnp.concatenate([jnp.full_like(vol[:1], big), vol[:-1]],
                                 axis=0)
        vol_dn = jnp.concatenate([vol[1:], jnp.full_like(vol[:1], big)],
                                 axis=0)
        zero = jnp.zeros((), vol.dtype)
        prev = jnp.sum(jnp.where(sel, vol_up, zero),
                       axis=0, dtype=jnp.float32)
        nxt = jnp.sum(jnp.where(sel, vol_dn, zero),
                      axis=0, dtype=jnp.float32)
        denom = prev - 2 * best + nxt
        offset = jnp.where(
            (denom > 1e-9) & (best_d > 0) & (best_d < D - 1),
            0.5 * (prev - nxt) / jnp.maximum(denom, 1e-9),
            0.0,
        )
        disp = d_min + stride * (best_d.astype(jnp.float32)
                                 + jnp.clip(offset, -1.0, 1.0))
    else:
        disp = d_min + stride * best_d.astype(jnp.float32)
    if not with_margin:
        return disp, best
    away = jnp.abs(ds - best_d[None]) > 1
    second = jnp.min(jnp.where(away, vol, big), axis=0).astype(jnp.float32)
    return disp, best, second - best


def lr_consistency(
    disp_l: jnp.ndarray, disp_r: jnp.ndarray, thresh: float,
    d_min: int, d_max: int, stride: int = 1,
):
    """|dL(x) - dR(x - dL(x))| <= t (ref ``disparity.py:229-250``).

    Gather-free: the per-pixel shift ``x - round(dL)`` is resolved by
    scanning the *static* disparity range [d_min, d_max] and masking —
    each step is a dynamic slice of a padded plane (contiguous, fast)
    instead of a per-pixel gather. Disparities outside the range fail.

    ``stride > 1`` quantises the lookup shift to the search grid and scans
    every stride-th shift (half the passes at stride 2); the ≤0.5·stride px
    lookup quantisation only moves the right-disparity sample by ≤1 px,
    which the comparison threshold absorbs (callers widen it by
    0.5·(stride−1); the right field is smooth at that scale away from
    discontinuities, where the check fails anyway).
    """
    h, w = disp_l.shape
    pad = max(abs(d_min), abs(d_max)) + 1
    rp = jnp.pad(disp_r, ((0, 0), (pad, pad)),
                 constant_values=jnp.float32(1e9))
    d_round = jnp.round(disp_l / stride) * stride

    def step(acc, s):
        shifted = jax.lax.dynamic_slice_in_dim(rp, pad - s, w, axis=1)
        return acc + jnp.where(d_round == s, shifted, 0.0), None

    ds = jnp.arange(d_min, d_max + 1, stride, dtype=jnp.int32)
    dr, _ = jax.lax.scan(step, jnp.zeros_like(disp_l), ds, unroll=_scan_unroll())
    xs = jax.lax.broadcasted_iota(jnp.float32, (h, w), 1)
    x2 = xs - d_round
    inb = (x2 >= 0) & (x2 < w) & (d_round >= d_min) & (d_round <= d_max)
    return inb & (jnp.abs(disp_l - dr) <= thresh)


def derive_right_volume(vol: jnp.ndarray, d_min: int,
                        fill: float = 1.0, stride: int = 1) -> jnp.ndarray:
    """Right-view cost volume from the left one: C_R(y, x, d) = C_L(y, x+d, d).

    Exact for any cost aggregated by a spatially-invariant filter (the box
    aggregation commutes with the per-disparity shift), so the second
    matching direction costs one volume pass instead of a full rebuild of
    census + cost + aggregation. Out-of-range samples take ``fill`` — the
    invalid-cost ceiling (1.0) for raw volumes; callers shifting an
    SGM-AGGREGATED volume (``right_sgm="derived"``) must pass a value above
    any aggregated cost so padding never wins the right-view WTA. SGM does
    not commute with the shift exactly; shifting the aggregated volume is
    the standard single-volume approximation (libSGM / OpenCV CUDA SGM)."""
    D, h, w = vol.shape
    ds = jnp.arange(D, dtype=jnp.int32) * stride + d_min
    xs = jnp.arange(w, dtype=jnp.int32)[None, :] + ds[:, None]  # (D, W)
    idx = jnp.broadcast_to(jnp.clip(xs, 0, w - 1)[:, None, :], vol.shape)
    out = jnp.take_along_axis(vol, idx, axis=2)
    return jnp.where(((xs >= 0) & (xs < w))[:, None, :], out,
                     jnp.asarray(fill, vol.dtype))


@partial(jax.jit, static_argnames=("cfg", "aggregation", "row_shift_pad",
                                   "row_shift_chunk"))
def compute_disparity(
    left: jnp.ndarray,
    right: jnp.ndarray,
    valid_l: jnp.ndarray,
    valid_r: jnp.ndarray,
    cfg: StereoConfig = StereoConfig(),
    aggregation: str = "sgm",
    noise_ratio: jnp.ndarray | None = None,
    row_shift: jnp.ndarray | None = None,
    row_shift_pad: int = 0,
    row_shift_chunk: int = 1,
) -> DisparityResult:
    """Full two-direction dense matcher.

    ``aggregation`` is ``"box"`` (pure local, parity with numpy_ref) or
    ``"sgm"`` (adds 4-path semi-global smoothing before WTA). The right
    direction reuses the left boxed volume via :func:`derive_right_volume`
    (right-frame convention x1 = x2 + d, matching the L/R check).

    ``noise_ratio`` is the scene's SNR proxy
    (:func:`pcmi_tpu.ops.normalize.snr_ratio`) driving the noise-adaptive
    cross-matcher smoothing (``cfg.noise_adapt``); pass it in when already
    computed (``pair_core`` does), else it is derived from ``left`` here.
    """
    left = left.astype(jnp.float32)
    right = right.astype(jnp.float32)

    stride = cfg.disp_stride
    vol_l = build_cost_volume(left, right, valid_l, valid_r, cfg,
                              row_shift=row_shift,
                              row_shift_pad=row_shift_pad,
                              row_shift_chunk=row_shift_chunk)
    if aggregation == "sgm":
        agg_l = sgm_aggregate(vol_l, cfg)
        if cfg.right_sgm in ("derived", "diagonal"):
            # single-volume L/R: shift the aggregated left volume into the
            # right frame instead of paying a second full SGM (see
            # StereoConfig.right_sgm)
            agg_r = derive_right_volume(agg_l, cfg.min_disparity, fill=1e4,
                                        stride=stride)
        else:
            agg_r = sgm_aggregate(
                derive_right_volume(vol_l, cfg.min_disparity, stride=stride),
                cfg, dirs="h" if cfg.right_sgm == "horizontal" else "4")
    else:
        agg_l = vol_l
        agg_r = derive_right_volume(vol_l, cfg.min_disparity, stride=stride)
    disp_l, cost_l, margin = wta_disparity(agg_l, cfg.min_disparity,
                                           with_margin=True, stride=stride)
    # "diagonal" is the integer-WTA form of "derived" (OpenCV SGBM's disp2)
    sub_r = cfg.right_subpixel and cfg.right_sgm != "diagonal"
    disp_r, _ = wta_disparity(agg_r, cfg.min_disparity, subpixel=sub_r,
                              stride=stride)

    ok = lr_consistency(disp_l, disp_r, cfg.lr_threshold_eff,
                        d_min=cfg.min_disparity,
                        d_max=cfg.min_disparity + cfg.max_disp - 1,
                        stride=stride)

    check = None
    check_margin = None
    if cfg.band_recover:
        # Independent cross-matcher (used by pair_core's band-recovery
        # densification). Two modes:
        #   "census"   — small square census/block, purely local (no SGM):
        #     maximally independent, but uninformative at wide search
        #     (8-bit census over 144 candidates WTAs garbage minima).
        #   "vertical" — census 3 with VERTICAL-ONLY aggregation (k-row
        #     box + 2-path vertical SGM): its horizontal fattening radius
        #     is ~1 px, so where the main (horizontal-window) pass
        #     fattened a building edge sideways, this checker reports the
        #     background's true disparity and the agreement test fails —
        #     while staying informative at any search width. Square
        #     windows of any size agree with fattening (correlated
        #     support; measured on the D=288 scene).
        import dataclasses as _dc

        cl, cr = left, right
        if cfg.noise_adapt > 0:
            # noise-adaptive checker inputs: census bits flip under noise,
            # so blend toward a sigma=1 Gaussian smooth as the scene SNR
            # proxy rises (clean scenes keep the raw, independent checker)
            from pcmi_tpu.ops.filters import gaussian_filter
            from pcmi_tpu.ops.normalize import snr_ratio

            if noise_ratio is None:
                noise_ratio = snr_ratio(left, valid_l)
            t = cfg.noise_adapt * jnp.clip((noise_ratio - 0.5) / 0.5, 0.0, 1.0)
            cl = (1.0 - t) * left + t * gaussian_filter(left, sigma=1.0)
            cr = (1.0 - t) * right + t * gaussian_filter(right, sigma=1.0)
        if cfg.band_check_mode == "vertical":
            cfg_s = _dc.replace(cfg, block_size=1,
                                census_window=cfg.band_check_census)
            vol_s = build_cost_volume(cl, cr, valid_l, valid_r, cfg_s,
                                      row_shift=row_shift,
                                      row_shift_pad=row_shift_pad,
                                      row_shift_chunk=row_shift_chunk)
            vol_s = _vertical_box(vol_s, cfg.band_check_vbox)
            vol_s = sgm_aggregate(vol_s, cfg_s, dirs="v")
            check, _, check_margin = wta_disparity(
                vol_s, cfg.min_disparity, stride=stride, with_margin=True)
        else:
            cfg_s = _dc.replace(cfg, block_size=cfg.band_check_block,
                                census_window=cfg.band_check_census)
            vol_s = build_cost_volume(cl, cr, valid_l, valid_r, cfg_s,
                                      row_shift=row_shift,
                                      row_shift_pad=row_shift_pad,
                                      row_shift_chunk=row_shift_chunk)
            check, _ = wta_disparity(vol_s, cfg.min_disparity, stride=stride)

    return DisparityResult(
        disparity=disp_l,
        valid=ok & valid_l,
        cost=cost_l,
        disparity_right=disp_r,
        margin=margin,
        check_disparity=check,
        check_margin=check_margin,
    )


@partial(jax.jit, static_argnames=("cfg",))
def refine_disparity(
    result: DisparityResult,
    guide: jnp.ndarray,
    cfg: StereoConfig = StereoConfig(),
) -> DisparityResult:
    """Edge-aware refinement pass (the WLS stand-in, ref ``disparity.py:287-310``).

    Fills L/R-inconsistent pixels from confident neighbours with a masked
    guided filter, then re-smooths — ``wls_passes`` rounds like the
    reference's two WLS applications (``disparity.py:129-155``).
    """
    from pcmi_tpu.ops.filters import guided_filter, masked_guided_filter

    disp = result.disparity
    valid = result.valid
    # pass 1: fill low-confidence pixels from confident neighbours
    filled = masked_guided_filter(
        guide, disp, valid, radius=cfg.gf_radius, eps=cfg.gf_eps
    )
    disp = jnp.where(valid, disp, filled)
    # passes 2..n: edge-aware smoothing of the FILLED field (confident
    # pixels are restored afterwards). A second masked fill would be a
    # fixed point — only re-filtering the whole field does new work, which
    # is what the reference's second WLS application amounts to
    # (``disparity.py:129-155``).
    for _ in range(max(cfg.wls_passes - 1, 0)):
        smoothed = guided_filter(guide, disp, radius=cfg.gf_radius,
                                 eps=cfg.gf_eps)
        disp = jnp.where(valid, disp, smoothed)
    # post-refinement L/R recheck at the relaxed threshold (the reference's
    # second consistency gate after WLS, ``disparity.py:161``): filled
    # pixels that now agree with the right view are re-admitted
    readmit = lr_consistency(
        disp, result.disparity_right, cfg.lr_threshold_final_eff,
        d_min=cfg.min_disparity, d_max=cfg.min_disparity + cfg.max_disp - 1,
        stride=cfg.disp_stride,
    )
    return DisparityResult(
        disparity=disp,
        valid=result.valid | readmit,
        cost=result.cost,
        disparity_right=result.disparity_right,
        margin=result.margin,
        check_disparity=result.check_disparity,
    )
