"""The GPU SGM kernel (Pallas, Triton route): interpret-mode parity with
the XLA scans on the CPU, the wrapper's padding and choice of kernel, and
the on-card checks (``gpu`` marker) that ``chip_smoke.py`` runs at full
width."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pcmi_tpu.config import StereoConfig
from pcmi_tpu.ops.stereo import matching
from pcmi_tpu.ops.stereo.pallas_kernels import (
    sgm_aggregate_pallas,
    sgm_scan_pair,
)

CFG = StereoConfig(max_disp=32, sgm_backend="xla")

# (D, H, W): power-of-two D, then D and both spatial extents off the
# kernel's power-of-two tile and its 32-lane block
SHAPES = [(16, 24, 64), (20, 19, 33)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dirs", ["4", "h", "v"])
def test_sgm_kernel_interpret_matches_scan(rng, shape, dirs):
    vol = jnp.asarray(rng.uniform(0, 1, shape).astype(np.float32))
    got = sgm_aggregate_pallas(vol, CFG.sgm_p1, CFG.sgm_p2, dirs=dirs,
                               interpret=True)
    want = matching.sgm_aggregate(vol, CFG, dirs=dirs)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("reverse", [False, True])
def test_sgm_scan_pair_directions(rng, reverse):
    """Output index 0 is the forward path along axis 1, index 1 the
    reverse one, each the scan's own recurrence."""
    d, s, lanes = 12, 17, 40
    vol = jnp.asarray(rng.uniform(0, 1, (d, s, lanes)).astype(np.float32))
    got = sgm_scan_pair(vol, CFG.sgm_p1, CFG.sgm_p2, interpret=True)
    assert got.shape == (2, d, s, lanes)
    want = matching._sgm_scan(jnp.transpose(vol, (1, 0, 2)), CFG.sgm_p1,
                              CFG.sgm_p2, reverse=reverse)
    np.testing.assert_array_equal(np.asarray(got[int(reverse)]),
                                  np.asarray(jnp.transpose(want, (1, 0, 2))))


def test_sgm_kernel_keeps_volume_dtype(rng):
    vol = jnp.asarray(rng.uniform(0, 1, (8, 12, 16))).astype(jnp.bfloat16)
    got = sgm_aggregate_pallas(vol, CFG.sgm_p1, CFG.sgm_p2, interpret=True)
    want = matching.sgm_aggregate(vol, CFG)
    assert got.dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(got, np.float32),
                                  np.asarray(want, np.float32))


def test_sgm_kernel_under_vmap(rng):
    """The sharded matcher vmaps the matcher over pairs."""
    vol = jnp.asarray(rng.uniform(0, 1, (2, 12, 20, 24)).astype(np.float32))
    got = jax.vmap(lambda v: sgm_aggregate_pallas(
        v, CFG.sgm_p1, CFG.sgm_p2, interpret=True))(vol)
    want = jax.vmap(lambda v: matching.sgm_aggregate(v, CFG))(vol)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("platform", ["cpu", "gpu"])
@pytest.mark.parametrize("backend", ["auto", "xla", "pallas"])
def test_sgm_backend_choice(monkeypatch, platform, backend):
    """"auto" takes the kernel only where the default backend is a GPU."""
    monkeypatch.setattr(matching.jax, "default_backend", lambda: platform)
    expect = backend == "pallas" or (backend == "auto" and platform == "gpu")
    assert matching._use_sgm_kernel(StereoConfig(sgm_backend=backend)) \
        is expect


def test_sgm_backend_pallas_refuses_cpu(rng):
    """A forced kernel does not fall back to interpret mode on the CPU."""
    vol = jnp.asarray(rng.uniform(0, 1, (8, 12, 16)).astype(np.float32))
    with pytest.raises(Exception, match="interpret"):
        matching.sgm_aggregate(vol, StereoConfig(sgm_backend="pallas"))


@pytest.mark.parametrize("value", ["mosaic", "triton", ""])
def test_sgm_backend_validation(value):
    with pytest.raises(ValueError, match="sgm_backend"):
        StereoConfig(sgm_backend=value)


@pytest.mark.gpu
def test_sgm_kernel_on_gpu(gpu_device):
    from pcmi_tpu.ops.stereo.gpu_checks import check_sgm_kernel

    res = check_sgm_kernel(20, 96, 160, reps=1)
    assert res["ok"], res


@pytest.mark.gpu
def test_pair_core_kernel_matches_scans_on_gpu(gpu_device, rng):
    from pcmi_tpu.pipelines.height_map import pair_core

    left = rng.uniform(0, 1, (96, 128)).astype(np.float32)
    right = np.roll(left, -3, axis=1)
    M = jnp.asarray(np.eye(3, 4), jnp.float32)
    b = jnp.zeros(4, jnp.float32)
    cfg = StereoConfig(max_disp=32, block_size=5, census_window=5)
    outs = [pair_core(left, right, M, b,
                      dataclasses.replace(cfg, sgm_backend=be))
            for be in ("pallas", "xla")]
    np.testing.assert_array_equal(np.asarray(outs[0].disparity),
                                  np.asarray(outs[1].disparity))


@pytest.mark.gpu
def test_rpc_projection_on_gpu(gpu_device):
    from pcmi_tpu.geometry.synthetic import aoi_lonlat_ranges, make_stereo_scene
    from pcmi_tpu.ops.stereo.gpu_checks import check_rpc_projection

    scene = make_stereo_scene(seed=0, out_shape=(256, 256),
                              ground_shape=(320, 320))
    res = check_rpc_projection(scene.rpcs, *aoi_lonlat_ranges(scene),
                               (0.0, 50.0), n=1 << 16)
    assert res["ok"], res


def test_sgm_kernel_under_shard_map(monkeypatch, rng):
    """The halo-exchange matcher runs the kernel per row band."""
    import functools

    from pcmi_tpu.ops.stereo import pallas_kernels
    from pcmi_tpu.parallel import make_mesh, sharded_disparity

    monkeypatch.setattr(pallas_kernels, "sgm_aggregate_pallas",
                        functools.partial(pallas_kernels.sgm_aggregate_pallas,
                                          interpret=True))
    left = jnp.asarray(rng.uniform(0, 1, (1, 128, 64)).astype(np.float32))
    right = jnp.roll(left, -2, axis=2)
    valid = jnp.ones(left.shape, bool)
    base = dict(max_disp=16, block_size=5, census_window=5, gf_radius=3,
                speckle_median_size=5)
    mesh = make_mesh(data=1, tile=4, devices=jax.devices()[:4])
    got, _ = sharded_disparity(mesh, StereoConfig(sgm_backend="pallas",
                                                  **base), halo=24)(
        left, right, valid, valid)
    want, _ = sharded_disparity(mesh, StereoConfig(sgm_backend="xla", **base),
                                halo=24)(left, right, valid, valid)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
