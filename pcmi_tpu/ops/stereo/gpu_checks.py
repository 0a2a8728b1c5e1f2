"""On-card checks of the GPU kernels against their plain references.

Each check runs the kernel as compiled for the card (never interpret
mode) beside the XLA formulation it replaces, and returns the largest
difference with the tolerance it is held to, plus both times. The
``gpu``-marked tests call them at small widths; ``chip_smoke.py`` calls
them at the widths the pipeline runs.
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp
import numpy as np

# The kernel evaluates the recurrence in the scan's own operation order,
# so it is expected to be bit-exact; the bound leaves room for a float
# reassociation XLA may apply inside the fused direction sums.
SGM_ATOL = 1e-5
# Pixels: float32 RPC evaluation against the float64 host projection.
RPC_ATOL_PX = 0.05


def _median_ms(fn, *args, reps: int = 5) -> float:
    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e3


def check_sgm_kernel(d: int, h: int, w: int, seed: int = 0,
                     reps: int = 5) -> dict:
    """SGM kernel vs ``matching.sgm_aggregate``'s XLA scans on a random
    (d, h, w) cost volume, for every ``dirs`` the matcher uses."""
    import dataclasses

    from pcmi_tpu.config import StereoConfig
    from pcmi_tpu.ops.stereo.matching import sgm_aggregate
    from pcmi_tpu.ops.stereo.pallas_kernels import sgm_aggregate_pallas

    cfg = dataclasses.replace(StereoConfig(), sgm_backend="xla")
    vol = jax.random.uniform(jax.random.PRNGKey(seed), (d, h, w),
                             jnp.float32)
    out = {"shape": [d, h, w], "atol": SGM_ATOL}
    for dirs in ("4", "h", "v"):
        kern = jax.jit(lambda v, dirs=dirs: sgm_aggregate_pallas(
            v, cfg.sgm_p1, cfg.sgm_p2, dirs=dirs))
        ref = jax.jit(lambda v, dirs=dirs: sgm_aggregate(v, cfg, dirs=dirs))
        diff = float(jnp.max(jnp.abs(kern(vol) - ref(vol))))
        out[f"max_abs_diff_{dirs}"] = diff
        out[f"kernel_ms_{dirs}"] = _median_ms(kern, vol, reps=reps)
        out[f"xla_ms_{dirs}"] = _median_ms(ref, vol, reps=reps)
    out["ok"] = all(out[f"max_abs_diff_{k}"] <= SGM_ATOL
                    for k in ("4", "h", "v"))
    return out


def check_rpc_projection(rpcs, lon_range, lat_range, h_range,
                         n: int = 1 << 20, seed: int = 0) -> dict:
    """Device ``RPCCamera.project`` vs the float64 host ``project_np`` at
    ``n`` random points of the AOI box, for every camera in ``rpcs``."""
    rng = np.random.default_rng(seed)
    lon = rng.uniform(*lon_range, n).astype(np.float32)
    lat = rng.uniform(*lat_range, n).astype(np.float32)
    hgt = rng.uniform(*h_range, n).astype(np.float32)
    worst = 0.0
    for cam in rpcs:
        col, row = jax.jit(cam.project)(jnp.asarray(lon), jnp.asarray(lat),
                                        jnp.asarray(hgt))
        # the reference sees the same float32-quantised geodetics
        col_np, row_np = cam.project_np(lon, lat, hgt)
        worst = max(worst,
                    float(np.max(np.abs(np.asarray(col, np.float64) - col_np))),
                    float(np.max(np.abs(np.asarray(row, np.float64) - row_np))))
    return {"points": n, "cameras": len(rpcs), "max_abs_px": worst,
            "atol_px": RPC_ATOL_PX, "ok": worst <= RPC_ATOL_PX}
