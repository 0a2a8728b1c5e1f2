"""Multi-device tests on the 8-device virtual CPU mesh (conftest forces it)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import PartitionSpec as P

from pcmi_tpu.config import StereoConfig
from pcmi_tpu.parallel import (
    DATA_AXIS,
    TILE_AXIS,
    batched_pair_step,
    default_halo,
    halo_exchange_rows,
    make_mesh,
    sharded_disparity,
)
from pcmi_tpu.ops.stereo.matching import compute_disparity, refine_disparity


def test_eight_virtual_devices():
    assert jax.device_count() == 8


def test_multihost_helpers_single_process():
    from pcmi_tpu.parallel import initialize_multihost, make_multihost_mesh
    from pcmi_tpu.parallel.multihost import HOST_AXIS

    # no coordinator anywhere -> a no-op, not a crash
    assert initialize_multihost() is False
    mesh = make_multihost_mesh(data=2)
    assert mesh.axis_names == (HOST_AXIS, "data", "tile")
    assert mesh.shape[HOST_AXIS] == 1
    assert mesh.shape["data"] == 2 and mesh.shape["tile"] == 4
    with pytest.raises(ValueError):
        make_multihost_mesh(data=3)


def test_halo_exchange_rows_matches_slices():
    mesh = make_mesh(data=1, tile=8)
    x = jnp.arange(8 * 4 * 16, dtype=jnp.float32).reshape(32, 16)

    def per_shard(xl):
        return halo_exchange_rows(xl, 2)

    out = jax.shard_map(
        per_shard, mesh=mesh,
        in_specs=P(TILE_AXIS, None),
        out_specs=P(TILE_AXIS, None),
    )(x)
    out = np.asarray(out)  # (8 * 8, 16): each band became 4+2+2 rows
    xn = np.asarray(x)
    for band in range(8):
        got = out[band * 8:(band + 1) * 8]
        top = xn[band * 4 - 2: band * 4] if band > 0 else np.zeros((2, 16))
        bot = xn[(band + 1) * 4:(band + 1) * 4 + 2] if band < 7 else np.zeros((2, 16))
        want = np.concatenate([top, xn[band * 4:(band + 1) * 4], bot])
        np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def stereo_stack():
    rng = np.random.default_rng(5)
    h, w, b = 256, 160, 2
    cfg = StereoConfig(max_disp=16, block_size=5, census_window=5,
                       gf_radius=4, speckle_median_size=5)
    lefts, rights = [], []
    for k in range(b):
        tex = rng.uniform(0, 1, (h, w + 32)).astype(np.float32)
        for ax in (0, 1):
            tex = 0.5 * tex + 0.25 * np.roll(tex, 1, ax) + 0.25 * np.roll(tex, -1, ax)
        disp = np.full((h, w), 2.0 + k, np.float32)
        disp[40:80, 50:120] = 6.0
        left = tex[:, 16:16 + w]
        xs = np.arange(w)[None, :] + disp + 16
        x0 = np.floor(xs).astype(int)
        t = xs - x0
        right = (
            tex[np.arange(h)[:, None], np.clip(x0, 0, w + 31)] * (1 - t)
            + tex[np.arange(h)[:, None], np.clip(x0 + 1, 0, w + 31)] * t
        )
        lefts.append(left)
        rights.append(right.astype(np.float32))
    return np.stack(lefts), np.stack(rights), cfg


def test_sharded_disparity_matches_single_device(stereo_stack):
    lefts, rights, cfg = stereo_stack
    b, h, w = lefts.shape
    mesh = make_mesh(data=2, tile=4)
    valid = jnp.ones((b, h, w), bool)
    fn = sharded_disparity(mesh, cfg)
    disp_sh, valid_sh = fn(jnp.asarray(lefts), jnp.asarray(rights), valid, valid)

    # single-device reference
    refs = []
    for k in range(b):
        res = compute_disparity(
            jnp.asarray(lefts[k]), jnp.asarray(rights[k]),
            jnp.ones((h, w), bool), jnp.ones((h, w), bool), cfg, "sgm",
        )
        res = refine_disparity(res, jnp.asarray(lefts[k]), cfg)
        refs.append(np.asarray(res.disparity))
    ref = np.stack(refs)
    got = np.asarray(disp_sh)

    # interior rows (away from canvas borders, where halo zeros differ from
    # the unsharded borders) must agree to sub-pixel almost everywhere
    interior = slice(16, h - 16)
    close = np.abs(got[:, interior] - ref[:, interior]) <= 0.51
    assert close.mean() > 0.98


def test_batched_pair_step_compiles_and_runs(stereo_stack):
    lefts, rights, cfg = stereo_stack
    b, h, w = lefts.shape
    mesh = make_mesh(data=2, tile=4)
    step = batched_pair_step(mesh, cfg)
    rects = jnp.stack([jnp.asarray(lefts), jnp.asarray(rights)], axis=1)
    tri_M = jnp.tile(jnp.eye(3, 4)[None], (b, 1, 1))
    tri_b = jnp.zeros((b, 4))
    disp, valid, height = step(rects, tri_M, tri_b)
    assert disp.shape == (b, h, w)
    assert np.isfinite(np.asarray(disp)).all()
    # heights NaN exactly off the valid mask
    hn = np.asarray(height)
    vn = np.asarray(valid)
    assert np.isnan(hn[~vn]).all()


def test_batched_pair_step_banded_under_gspmd(stereo_stack):
    """The tile-adaptive banded matcher (coarse pass + per-pixel warp +
    narrow search) must compile and run under the dp x sp GSPMD sharding
    AND match its own single-device output."""
    import dataclasses

    from pcmi_tpu.pipelines.height_map import pair_core

    lefts, rights, cfg = stereo_stack
    b, h, w = lefts.shape
    cfg_b = dataclasses.replace(cfg, adapt_band_rows=32, adapt_band_cols=32,
                                adapt_local_disp=16)
    mesh = make_mesh(data=2, tile=4)
    step = batched_pair_step(mesh, cfg_b)
    rects = jnp.stack([jnp.asarray(lefts), jnp.asarray(rights)], axis=1)
    tri_M = jnp.tile(jnp.eye(3, 4)[None], (b, 1, 1))
    tri_b = jnp.zeros((b, 4))
    disp, valid, height = step(rects, tri_M, tri_b)
    assert disp.shape == (b, h, w)
    assert np.isfinite(np.asarray(disp)).all()
    # sharded vs single-device parity (same static cfg, same inputs)
    ref = pair_core(jnp.asarray(lefts[0]), jnp.asarray(rights[0]),
                    tri_M[0], tri_b[0], cfg_b)
    both = np.asarray(valid[0]) & np.asarray(ref.valid)
    delta = np.abs(np.asarray(disp[0]) - np.asarray(ref.disparity))[both]
    assert both.mean() > 0.2
    assert np.quantile(delta, 0.99) < 0.51, np.quantile(delta, 0.99)
