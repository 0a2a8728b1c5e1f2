"""Worker process for the 2-process mesh smoke test (test_multihost_dcn.py).

Each process owns 4 virtual CPU devices; together they form the
(host=2, data=2, tile=2) mesh. Runs (a) a psum over every mesh axis
and (b) a real stereo pair-step whose batch is sharded over host x data —
the multi-AOI/multi-date scale-out path (SURVEY §2.8, BASELINE config 5).
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=4"
    ).strip()

import jax  # noqa: E402

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402


def main() -> None:
    process_id = int(sys.argv[1])
    coordinator = sys.argv[2]

    from pcmi_tpu.parallel.multihost import (
        HOST_AXIS,
        initialize,
        make_multihost_mesh,
    )

    assert initialize(coordinator_address=coordinator, num_processes=2,
                      process_id=process_id)
    assert jax.process_count() == 2, jax.process_count()
    assert jax.device_count() == 8, jax.device_count()

    mesh = make_multihost_mesh(data=2, tile=2)
    assert mesh.axis_names == (HOST_AXIS, "data", "tile")
    assert mesh.devices.shape == (2, 2, 2)

    # (a) collective across processes: psum over every axis must count devices
    def _count():
        # axis_index makes the summand device-varying (VMA-clean psum)
        one = jnp.where(jax.lax.axis_index(HOST_AXIS) >= 0, 1.0, 0.0)
        one = jax.lax.pvary(one, ("data", "tile"))
        return jax.lax.psum(one, (HOST_AXIS, "data", "tile"))

    total = jax.jit(jax.shard_map(
        _count, mesh=mesh, in_specs=(), out_specs=P()))()
    np.testing.assert_allclose(np.asarray(jax.device_get(total)), 8.0)

    # (b) pair-step over hosts: stereo batch sharded (host x data), canvas
    # rows over tile with halo exchange — the production multi-host layout
    from pcmi_tpu.config import StereoConfig
    from pcmi_tpu.ops.stereo.matching import compute_disparity
    from pcmi_tpu.parallel.halo import halo_exchange_rows

    cfg = StereoConfig(max_disp=16, block_size=5, census_window=5,
                       margin_undefined=2, band_recover=False)
    h, w, bsz, halo = 32, 64, 4, 8

    def per_shard(left, right):
        def single(l, r):
            le = halo_exchange_rows(l, halo, axis_name="tile")
            re_ = halo_exchange_rows(r, halo, axis_name="tile")
            v = jnp.ones(le.shape, bool)
            res = compute_disparity(le, re_, v, v, cfg, aggregation="sgm")
            return res.disparity[halo:-halo], res.valid[halo:-halo]

        return jax.vmap(single)(left, right)

    spec = P((HOST_AXIS, "data"), "tile", None)
    fn = jax.jit(jax.shard_map(
        per_shard, mesh=mesh, in_specs=(spec, spec), out_specs=(spec, spec)))

    rng = np.random.default_rng(0)
    glob = rng.uniform(0, 1, (bsz, h, w)).astype(np.float32)
    shift = np.roll(glob, 3, axis=2)
    sharding = NamedSharding(mesh, spec)

    def make(arr):
        return jax.make_array_from_callback(
            arr.shape, sharding, lambda idx: arr[idx])

    disp, ok = fn(make(glob), make(shift))
    jax.block_until_ready((disp, ok))
    assert disp.shape == (bsz, h, w)
    # the constant 3-px shift must be recovered on consistent pixels
    d = np.asarray(jax.device_get(
        jax.jit(lambda x: x, out_shardings=NamedSharding(mesh, P()))(disp)))
    o = np.asarray(jax.device_get(
        jax.jit(lambda x: x, out_shardings=NamedSharding(mesh, P()))(ok)))
    inner = o[:, 4:-4, 20:-20]
    err = np.abs(d[:, 4:-4, 20:-20] + 3.0)[inner]  # left-right sign: d=-3
    frac = float((err <= 1.0).mean()) if inner.any() else 0.0
    assert frac > 0.9, frac

    print(f"WORKER{process_id} OK psum=8 pair-step frac={frac:.3f}",
          flush=True)


if __name__ == "__main__":
    main()
