"""Stereo matcher tests: JAX path vs CPU NumPy reference + ground truth.

Covers BASELINE.json config 1 (CPU NumPy parity) and the <=1 m height-RMSE
target on synthetic truth.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from pcmi_tpu.config import StereoConfig
from pcmi_tpu.ops.stereo import numpy_ref as nref
from pcmi_tpu.ops.stereo.matching import (
    census_transform,
    build_cost_volume,
    compute_disparity,
    refine_disparity,
    lr_consistency,
)


@pytest.fixture(scope="module")
def pair():
    """Small synthetic rectified pair with known integer-ish disparity."""
    rng = np.random.default_rng(3)
    h, w = 96, 128
    tex = rng.uniform(0, 1, (h, w + 64)).astype(np.float32)
    # smooth the texture slightly so sub-pixel interpolation is meaningful
    k = np.array([0.25, 0.5, 0.25], np.float32)
    for ax in (0, 1):
        tex = (
            np.take(tex, np.clip(np.arange(tex.shape[ax]) - 1, 0, None), axis=ax) * k[0]
            + tex * k[1]
            + np.take(
                tex,
                np.clip(np.arange(tex.shape[ax]) + 1, None, tex.shape[ax] - 1),
                axis=ax,
            )
            * k[2]
        )
    # piecewise-constant disparity field: background 2 px, raised block 8 px
    disp = np.full((h, w), 2.0, np.float32)
    disp[30:60, 40:90] = 8.0
    left = tex[:, 32 : 32 + w]
    # convention: right[x - d] == left[x]  =>  right[x] = tex[x + d + 32]
    xs = np.arange(w)[None, :] + disp + 32.0
    x0 = np.floor(xs).astype(int)
    t = xs - x0
    right = tex[np.arange(h)[:, None], np.clip(x0, 0, tex.shape[1] - 1)] * (1 - t) + tex[
        np.arange(h)[:, None], np.clip(x0 + 1, 0, tex.shape[1] - 1)
    ] * t
    right = right.astype(np.float32)
    return left, right, disp


CFG = StereoConfig(max_disp=32, block_size=7, census_window=5)


def test_census_parity(pair):
    left, _, _ = pair
    b0, b1 = census_transform(jnp.asarray(left), 5)
    n0, n1 = nref.census_transform_np(left, 5)
    np.testing.assert_array_equal(np.asarray(b0), n0)
    np.testing.assert_array_equal(np.asarray(b1), n1)


def test_cost_volume_parity(pair):
    left, right, _ = pair
    vl = np.ones_like(left, bool)
    vol = np.asarray(
        build_cost_volume(
            jnp.asarray(left), jnp.asarray(right), jnp.asarray(vl), jnp.asarray(vl), CFG
        )
    )
    cl = nref.census_transform_np(left, CFG.census_window)
    cr = nref.census_transform_np(right, CFG.census_window)
    for di in [0, 7, 16, 31]:
        d = CFG.min_disparity + di
        c = nref.matching_cost_np(
            left, right, vl, vl, d, cl, cr, CFG.ad_weight, CFG.census_window
        )
        c = nref.box_aggregate_np(c, CFG.block_size)
        np.testing.assert_allclose(vol[di], c, atol=2e-3)


def test_box_wta_matches_numpy_and_truth(pair):
    left, right, gt = pair
    vl = jnp.ones(left.shape, bool)
    res = compute_disparity(
        jnp.asarray(left), jnp.asarray(right), vl, vl, CFG, aggregation="box"
    )
    dl_np, dr_np, mask_np = nref.stereo_pipeline_np(
        left, right, np.ones_like(left, bool), np.ones_like(left, bool),
        CFG.max_disp, CFG.block_size, CFG.lr_threshold,
    )
    dj = np.asarray(res.disparity)
    vj = np.asarray(res.valid)
    # parity: disparities agree where both are valid
    agree = np.abs(dj - dl_np) <= 0.26
    assert agree[vj & mask_np].mean() > 0.97
    # truth: median error small in the interior of constant regions
    interior = np.zeros_like(gt, bool)
    interior[8:24, 8:120] = True  # background band
    err = np.abs(dj - gt)
    assert np.median(err[interior & vj]) < 0.35


def test_sgm_beats_box_on_truth(pair):
    left, right, gt = pair
    vl = jnp.ones(left.shape, bool)
    res_box = compute_disparity(
        jnp.asarray(left), jnp.asarray(right), vl, vl, CFG, aggregation="box"
    )
    res_sgm = compute_disparity(
        jnp.asarray(left), jnp.asarray(right), vl, vl, CFG, aggregation="sgm"
    )
    e_box = np.abs(np.asarray(res_box.disparity) - gt)
    e_sgm = np.abs(np.asarray(res_sgm.disparity) - gt)
    inner = np.zeros_like(gt, bool)
    inner[4:-4, 20:-4] = True
    bad_box = (e_box > 1.0)[inner].mean()
    bad_sgm = (e_sgm > 1.0)[inner].mean()
    assert bad_sgm <= bad_box + 0.01
    assert bad_sgm < 0.08


def test_lr_consistency_flags_occlusions(pair):
    left, right, gt = pair
    vl = jnp.ones(left.shape, bool)
    res = compute_disparity(
        jnp.asarray(left), jnp.asarray(right), vl, vl, CFG, aggregation="sgm"
    )
    v = np.asarray(res.valid)
    # occluded band left of the raised block (disparity jump 2->8) should be
    # partially invalidated; overall validity stays high
    assert v.mean() > 0.6
    err = np.abs(np.asarray(res.disparity) - gt)
    assert np.median(err[v]) < 0.35


def test_refine_fills_invalid(pair):
    left, right, gt = pair
    vl = jnp.ones(left.shape, bool)
    res = compute_disparity(
        jnp.asarray(left), jnp.asarray(right), vl, vl, CFG, aggregation="sgm"
    )
    ref = refine_disparity(res, jnp.asarray(left), CFG)
    err = np.abs(np.asarray(ref.disparity) - gt)
    inner = np.zeros_like(gt, bool)
    inner[4:-4, 20:-4] = True
    # filled field should stay close to truth almost everywhere
    assert np.quantile(err[inner], 0.9) < 1.5


def test_bf16_cost_volume_matches_f32(pair):
    """cost_dtype="bfloat16" must agree with f32 to sub-pixel tolerance.

    bf16 volume storage (StereoConfig.cost_dtype) halves the matcher's
    volume traffic; "auto" resolves to f32, so this is the explicit
    cross-dtype check that the quantisation stays below the matcher's own
    sub-pixel noise floor.
    """
    import dataclasses

    left, right, true_disp = pair
    v = jnp.ones(left.shape, bool)
    cfg32 = dataclasses.replace(CFG, cost_dtype="float32")
    cfg16 = dataclasses.replace(CFG, cost_dtype="bfloat16")
    r32 = compute_disparity(jnp.asarray(left), jnp.asarray(right), v, v, cfg32)
    r16 = compute_disparity(jnp.asarray(left), jnp.asarray(right), v, v, cfg16)
    both = np.asarray(r32.valid) & np.asarray(r16.valid)
    assert both.mean() > 0.5
    d32 = np.asarray(r32.disparity)[both]
    d16 = np.asarray(r16.disparity)[both]
    # integer WTA decisions should almost never flip; sub-pixel offsets may
    # wiggle within the parabola's own noise
    assert (np.abs(d32 - d16) <= 1.0).mean() > 0.995
    assert np.median(np.abs(d32 - d16)) < 0.25
    # validity masks mostly agree
    agree = (np.asarray(r32.valid) == np.asarray(r16.valid)).mean()
    assert agree > 0.95


def test_disp_stride_matches_full_search(pair):
    """disp_stride=2 (coarse-stride full-resolution search) must track the
    stride-1 matcher to within its own quantisation: the volume holds every
    2nd disparity and the parabola interpolates at spacing 2, so disparities
    should agree within ~1 px almost everywhere and the recovered field must
    still be accurate against ground truth."""
    import dataclasses

    left, right, gt = pair
    v = jnp.ones(left.shape, bool)
    cfg1 = dataclasses.replace(CFG, cost_dtype="float32")
    cfg2 = dataclasses.replace(CFG, cost_dtype="float32", disp_stride=2)
    r1 = compute_disparity(jnp.asarray(left), jnp.asarray(right), v, v, cfg1)
    r2 = compute_disparity(jnp.asarray(left), jnp.asarray(right), v, v, cfg2)
    both = np.asarray(r1.valid) & np.asarray(r2.valid)
    assert both.mean() > 0.5
    d1 = np.asarray(r1.disparity)[both]
    d2 = np.asarray(r2.disparity)[both]
    assert (np.abs(d1 - d2) <= 1.0).mean() > 0.98
    # strided matcher is still accurate in absolute terms
    err = np.abs(np.asarray(r2.disparity) - gt)[both]
    assert np.median(err) < 0.5
    # check disparity (band-recovery cross-matcher) decodes in real px units
    chk = np.asarray(r2.check_disparity)
    assert np.median(np.abs(chk - gt)[both]) < 2.0


def test_disp_stride_validation():
    import pytest as _pytest

    with _pytest.raises(ValueError):
        StereoConfig(disp_stride=3)


@pytest.mark.parametrize("shape", [(16, 24, 40), (20, 19, 33)])
@pytest.mark.parametrize("dirs", ["4", "h", "v"])
def test_sgm_aggregate_matches_numpy_ref(rng, shape, dirs):
    """XLA scans vs the NumPy recurrence, incl. shapes off any tile size."""
    from pcmi_tpu.ops.stereo.matching import sgm_aggregate

    vol = rng.uniform(0, 1, shape).astype(np.float32)
    cfg = StereoConfig(max_disp=32, sgm_backend="xla")
    got = np.asarray(sgm_aggregate(jnp.asarray(vol), cfg, dirs=dirs))
    want = nref.sgm_aggregate_np(vol, cfg.sgm_p1, cfg.sgm_p2, dirs=dirs)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("subpixel", [True, False])
@pytest.mark.parametrize("with_margin", [True, False])
def test_wta_disparity_matches_numpy_ref(rng, stride, subpixel,
                                         with_margin):
    from pcmi_tpu.ops.stereo.matching import wta_disparity

    vol = rng.uniform(0, 1, (12, 20, 24)).astype(np.float32)
    vol[0, :2] = 0.0     # argmin on the first slice: no parabola
    vol[-1, 2:4] = -1.0  # ... and on the last
    got = wta_disparity(jnp.asarray(vol), -6, with_margin=with_margin,
                        subpixel=subpixel, stride=stride)
    want = nref.wta_np(vol, -6, stride=stride, subpixel=subpixel,
                       with_margin=with_margin)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), w, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("fill", [1.0, 1e4])
def test_derive_right_volume_matches_numpy_shift(rng, stride, fill):
    """C_R(y, x, i) = C_L(y, x + d_i, i), ``fill`` off the canvas."""
    from pcmi_tpu.ops.stereo.matching import derive_right_volume

    d, h, w, d_min = 10, 6, 30, -8
    vol = rng.uniform(0, 1, (d, h, w)).astype(np.float32)
    want = np.full_like(vol, fill)
    for i in range(d):
        s = d_min + i * stride
        for x in range(w):
            if 0 <= x + s < w:
                want[i, :, x] = vol[i, :, x + s]
    got = derive_right_volume(jnp.asarray(vol), d_min, fill=fill,
                              stride=stride)
    np.testing.assert_array_equal(np.asarray(got), want)


def test_compute_disparity_diagonal_mode(rng):
    """right_sgm="diagonal" is "derived" with an integer right-view WTA."""
    from pcmi_tpu.ops.stereo.matching import wta_disparity

    left = rng.uniform(0, 1, (40, 64)).astype(np.float32)
    # shift columns by 3 for a plausibly matchable pair
    right = np.roll(left, -3, axis=1).astype(np.float32)
    v = jnp.ones((40, 64), bool)
    base = dict(block_size=5, census_window=5, max_disp=8,
                band_recover=False, sgm_backend="xla")
    cfg_diag = StereoConfig(right_sgm="diagonal", **base)
    cfg_der = StereoConfig(right_sgm="derived", **base)
    l, r = jnp.asarray(left), jnp.asarray(right)
    out_diag = compute_disparity(l, r, v, v, cfg_diag)
    out_der = compute_disparity(l, r, v, v, cfg_der)
    np.testing.assert_array_equal(np.asarray(out_diag.disparity),
                                  np.asarray(out_der.disparity))
    dr = np.asarray(out_diag.disparity_right)
    np.testing.assert_array_equal(dr, np.round(dr))  # integer WTA
    assert (np.abs(dr - np.asarray(out_der.disparity_right)) <= 1.0).all()
