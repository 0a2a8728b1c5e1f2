"""Smoke test of the stereo -> height -> DSM path on one GPU.

    python chip_smoke.py           # phases (a) cli, (b) aoi, (c) kernels
    python chip_smoke.py --four    # phase (d) only: the 4-GPU mesh paths

Phases, all through the entry points a user calls:

(a) cli     ``pcmi_tpu.cli.main`` runs ``height-map --demo`` and
            ``fuse --demo`` into a temporary directory; the products must
            exist.
(b) aoi     ``StreamingAOIPipeline.run`` over the MAX_DISP=288 AOI
            (seed 3, 5 views, 10 pairs, ~1152^2 rectified canvases,
            ``disp_stride=2``). One strict pair is scored against the
            synthetic truth and must hold its <=1 m height-RMSE gate; the
            fused DSM's RMSE and completeness are printed, not asserted.
(c) kernels every GPU kernel, compiled for the card, against its plain
            reference at D=144 and D=288 on 1152^2 volumes; the device
            RPC projection against the float64 host projection; the pair
            core with the SGM kernel against the XLA scans.
(d) four    the halo-exchange matcher (tile=4), the GSPMD batched pair
            step (data=2, tile=2) and the sharded DSM update on a 4-GPU
            mesh, each against the same call on one GPU.

Every phase prints its compile and run seconds. The last line of standard
output is one JSON object, ``{"ok": true, "device": {...}}``; any failure
raises and exits non-zero, and so does a run where JAX finds no GPU.
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

H_RANGE = (0.0, 48.0)
VIEWS = ((25.0, 80.0), (35.0, 250.0), (30.0, 160.0), (20.0, 20.0),
         (28.0, 305.0))
# share of pixels that must agree within 0.51 px between a mesh result and
# the same call on one card (tests/test_parallel.py)
MESH_CLOSE_FRAC = 0.98


class _CompileClock:
    """Sums XLA backend-compile durations (tracing counts as run time:
    nested jit traces report overlapping durations)."""

    EVENTS = ("/jax/core/compile/backend_compile_duration",)

    def __init__(self):
        import jax

        self.total = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, event, duration, **_):
        if event in self.EVENTS:
            self.total += duration


@contextlib.contextmanager
def phase(name: str, clock: _CompileClock, results: dict):
    print(f"[{name}] start", flush=True)
    c0, t0 = clock.total, time.perf_counter()
    info: dict = {}
    yield info
    wall = time.perf_counter() - t0
    comp = clock.total - c0
    info.update(compile_s=round(comp, 3), run_s=round(wall - comp, 3))
    results[name] = info
    print(f"[{name}] compile {comp:.3f} s, run {wall - comp:.3f} s: "
          f"{json.dumps(info)}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def d288_scene(out_shape=(896, 896), ground_shape=(768, 768), seed=3,
               views=VIEWS):
    """The MAX_DISP=288 AOI: fine GSD, steep convergence, tall buildings."""
    from pcmi_tpu.geometry.synthetic import make_stereo_scene

    return make_stereo_scene(
        seed=seed, out_shape=out_shape, ground_shape=ground_shape, gsd=0.2,
        h_range=H_RANGE, views=views,
        terrain_kwargs=dict(terrain_fraction=0.6, building_size_px=(50, 125),
                            building_h_m=(8.0, 18.0)))


def d288_config(**stereo):
    from pcmi_tpu.config import PipelineConfig, RectifyConfig, StereoConfig

    return PipelineConfig(
        stereo=StereoConfig(block_size=9, census_window=5, margin_undefined=8,
                            disp_stride=2, **stereo),
        rectify=RectifyConfig(height_range=H_RANGE))


def rectified_pairs(scene, cfg, pairs):
    """Pairs rectified onto one common canvas (-1 = no data), their
    triangulation operators, and the stereo config of the whole AOI."""
    import jax.numpy as jnp

    from pcmi_tpu.geometry.rectify import triangulation_operator
    from pcmi_tpu.geometry.synthetic import aoi_lonlat_ranges
    from pcmi_tpu.pipelines.height_map import HeightMapPipeline, _rectify_pair

    pipe = HeightMapPipeline(cfg)
    all_pairs = list(itertools.combinations(range(len(scene.images)), 2))
    geoms = {p: pipe.build_geometry(
        scene.rpcs[p[0]], scene.rpcs[p[1]], *aoi_lonlat_ranges(scene),
        scene.images[p[0]].shape, scene.images[p[1]].shape)
        for p in all_pairs}
    scfg = pipe.stereo_cfg_for(list(geoms.values()))
    hc = max(g.out_shape[0] for g in geoms.values())
    wc = max(g.out_shape[1] for g in geoms.values())
    out = []
    for i, j in pairs:
        g = geoms[(i, j)]
        ra, rb = _rectify_pair(scene.images[i], scene.images[j],
                               jnp.asarray(g.H1, jnp.float32),
                               jnp.asarray(g.H2, jnp.float32), g.out_shape)
        pad = ((0, hc - g.out_shape[0]), (0, wc - g.out_shape[1]))
        M, b = triangulation_operator(g)
        out.append((jnp.pad(ra, pad, constant_values=-1.0),
                    jnp.pad(rb, pad, constant_values=-1.0), M, b))
    return out, scfg


# --------------------------------------------------------------------- (a)
def phase_cli(info: dict) -> None:
    from pcmi_tpu.cli import main as cli_main

    expect = {"height-map": ("height.tif", "disparity.tif", "cloud.ply",
                             "dsm.tif"),
              "fuse": ("dsm.tif", "fused_cloud.ply")}
    with tempfile.TemporaryDirectory() as tmp:
        for cmd, files in expect.items():
            outdir = os.path.join(tmp, cmd)
            t0 = time.perf_counter()
            rc = cli_main([cmd, "--demo", "--output", outdir])
            info[f"{cmd}_s"] = round(time.perf_counter() - t0, 3)
            if rc != 0:
                raise RuntimeError(f"cli {cmd} exited {rc}")
            missing = [f for f in files
                       if not os.path.getsize(os.path.join(outdir, f))]
            if missing:
                raise RuntimeError(f"cli {cmd}: empty products {missing}")
            info[f"{cmd}_products"] = list(files)


# --------------------------------------------------------------------- (b)
def phase_aoi(info: dict, scene=None, n_pairs: int = 10,
              band_rows: int = 256, grid_cell: float = 0.6) -> None:
    import dataclasses

    from pcmi_tpu.geometry.pairs import ImageMeta
    from pcmi_tpu.geometry.synthetic import aoi_lonlat_ranges
    from pcmi_tpu.pipelines.evaluation import (
        evaluate_pair_accuracy,
        grid_truth,
    )
    from pcmi_tpu.pipelines.streaming import StreamingAOIPipeline

    scene = scene if scene is not None else d288_scene()
    cfg = d288_config()
    # every C(5, 2) pair enters: their convergence reaches 59.8 degrees
    cfg = cfg.replace(pairs=dataclasses.replace(
        cfg.pairs, n_pairs=n_pairs, max_convergence_deg=60.0))
    metas = [ImageMeta(i, inc, az, date=20.0 * i)
             for i, (inc, az) in enumerate(VIEWS[:len(scene.images)])]
    lon_r, lat_r = aoi_lonlat_ranges(scene)
    pipe = StreamingAOIPipeline(cfg, band_rows=band_rows)
    runs = []
    for _ in range(2):  # cold (compiles), then warm
        t0 = time.perf_counter()
        out = pipe.run(scene.images, scene.rpcs, metas, lon_r, lat_r,
                       grid_cell=grid_cell, min_pairs=2)
        runs.append(time.perf_counter() - t0)
    info.update(pairs=out["pairs"], tiles=out["tiles"],
                max_disp=out["stereo_cfg"]["max_disp"],
                disp_stride=out["stereo_cfg"]["disp_stride"],
                aoi_cold_s=round(runs[0], 3), aoi_warm_s=round(runs[1], 3))
    if out["pairs"] != n_pairs:
        raise RuntimeError(f"AOI selected {out['pairs']} pairs, not {n_pairs}")

    # fused DSM vs cell-centre truth: printed, not gated (known to miss)
    dsm = np.asarray(out["dsm"])
    tt, inb = grid_truth(scene, out["origin"], out["cell"], dsm.shape)
    filled = np.isfinite(dsm) & inb
    err = dsm[filled] - tt[filled]
    info["fused_rmse_m"] = float(np.sqrt(np.mean(err ** 2)))
    info["fused_completeness_bbox"] = float(filled.sum() / max(inb.sum(), 1))

    # one strict pair of the AOI, scored against the truth: the gate
    scfg = type(cfg.stereo)(**out["stereo_cfg"])
    score = evaluate_pair_accuracy(scene, cfg, view_idx=(0, 1),
                                   stereo_cfg=scfg)
    info["strict_pair_rmse_m"] = score["rmse_m"]
    info["strict_pair_completeness"] = score["completeness"]
    info["gate_strict_rmse_le_1m"] = bool(score["rmse_m"] <= 1.0)
    if not info["gate_strict_rmse_le_1m"]:
        raise RuntimeError(f"strict pair RMSE {score['rmse_m']:.4f} m > 1 m")


# --------------------------------------------------------------------- (c)
def phase_kernels(info: dict, widths=((144, 1152, 1152), (288, 1152, 1152)),
                  scene=None) -> None:
    import dataclasses

    import jax

    from pcmi_tpu.geometry.synthetic import aoi_lonlat_ranges
    from pcmi_tpu.ops.stereo.gpu_checks import (
        check_rpc_projection,
        check_sgm_kernel,
    )
    from pcmi_tpu.pipelines.height_map import pair_core

    info["default_matmul_precision"] = str(
        jax.config.jax_default_matmul_precision)
    info["geometry_matmul_precision"] = "HIGHEST"
    for d, h, w in widths:
        res = check_sgm_kernel(d, h, w)
        info[f"sgm_D{d}"] = res
        if not res["ok"]:
            raise RuntimeError(f"SGM kernel off its reference: {res}")

    scene = scene if scene is not None else d288_scene()
    rpc = check_rpc_projection(scene.rpcs, *aoi_lonlat_ranges(scene),
                               H_RANGE)
    info["rpc_projection"] = rpc
    if not rpc["ok"]:
        raise RuntimeError(f"RPC projection off the float64 host: {rpc}")

    # end to end: the pair core with the kernel vs with the XLA scans,
    # alternated, on the AOI's first pair
    ((r1, r2, M, b),), scfg = rectified_pairs(scene, d288_config(), [(0, 1)])
    configs = {"d288_s2": scfg,
               "d144_s1": dataclasses.replace(scfg, max_disp=144,
                                              disp_stride=1)}
    for name, c in configs.items():
        times = {"pallas": [], "xla": []}
        outs = {}
        for backend in ("xla", "pallas", "pallas", "xla"):
            cb = dataclasses.replace(c, sgm_backend=backend)
            outs[backend] = jax.block_until_ready(pair_core(r1, r2, M, b, cb))
            for _ in range(5):
                t0 = time.perf_counter()
                jax.block_until_ready(pair_core(r1, r2, M, b, cb))
                times[backend].append(time.perf_counter() - t0)
        same = bool(np.array_equal(np.asarray(outs["pallas"].valid),
                                   np.asarray(outs["xla"].valid)))
        diff = float(np.max(np.abs(np.asarray(outs["pallas"].disparity)
                                   - np.asarray(outs["xla"].disparity))))
        info[f"pair_core_{name}"] = {
            "canvas": list(r1.shape), "max_disp": c.max_disp,
            "disp_stride": c.disp_stride,
            "kernel_ms": float(np.median(times["pallas"])) * 1e3,
            "xla_ms": float(np.median(times["xla"])) * 1e3,
            "max_abs_disparity_diff": diff, "valid_equal": same}
        if diff > 0.01 or not same:
            raise RuntimeError(f"pair core differs with the kernel: {name}")


# --------------------------------------------------------------------- (d)
def _close_frac(got, ref, rows=slice(None)):
    got = np.asarray(got)[..., rows, :]
    ref = np.asarray(ref)[..., rows, :]
    return float((np.abs(got - ref) <= 0.51).mean())


def phase_four(info: dict, scene=None, n_devices: int = 4) -> None:
    import jax
    import jax.numpy as jnp

    from pcmi_tpu.ops.normalize import normalise_image
    from pcmi_tpu.parallel import (
        batched_pair_step,
        make_mesh,
        sharded_disparity,
    )
    from pcmi_tpu.parallel.fusion_sharded import sharded_dsm_update
    from pcmi_tpu.pipelines.height_map import pair_core

    devs = jax.devices()
    if len(devs) < n_devices:
        raise RuntimeError(f"need {n_devices} devices, have {len(devs)}")
    one = make_mesh(data=1, tile=1, devices=devs[:1])
    scene = scene if scene is not None else d288_scene()
    prepared, scfg = rectified_pairs(scene, d288_config(), [(0, 1), (0, 2)])
    info["canvas"] = list(prepared[0][0].shape)
    info["max_disp"] = scfg.max_disp

    # 1) halo-exchange matcher over 4 row bands
    r1, r2, _, _ = prepared[0]
    n1 = normalise_image(r1, r1 >= 0)[0][None]
    n2 = normalise_image(r2, r2 >= 0)[0][None]
    v1, v2 = (r1 >= 0)[None], (r2 >= 0)[None]
    h = n1.shape[1]
    mesh_t = make_mesh(data=1, tile=n_devices, devices=devs[:n_devices])
    d4, _ = sharded_disparity(mesh_t, scfg)(n1, n2, v1, v2)
    d1, _ = sharded_disparity(one, scfg)(n1, n2, v1, v2)
    frac = _close_frac(d4, d1, slice(16, h - 16))
    info["halo_matcher_tile4_close_frac"] = frac
    if frac <= MESH_CLOSE_FRAC:
        raise RuntimeError(f"halo matcher: {frac:.4f} of pixels close")

    # 2) GSPMD pair step: pairs over data=2, row bands over tile=2
    rects = jnp.stack([jnp.stack([p[0], p[1]]) for p in prepared])
    tri_M = jnp.stack([p[2] for p in prepared])
    tri_b = jnp.stack([p[3] for p in prepared])
    mesh_dt = make_mesh(data=2, tile=n_devices // 2,
                        devices=devs[:n_devices])
    disp, valid, height = batched_pair_step(mesh_dt, scfg)(rects, tri_M,
                                                           tri_b)
    fracs = []
    for k, (a, b_, M, bb) in enumerate(prepared):
        ref = pair_core(jax.device_put(a, devs[0]), jax.device_put(b_, devs[0]),
                        M, bb, scfg)
        fracs.append(_close_frac(disp[k], ref.disparity))
    info["gspmd_pair_step_close_frac"] = fracs
    if min(fracs) <= MESH_CLOSE_FRAC:
        raise RuntimeError(f"GSPMD pair step: {fracs} of pixels close")

    # 3) sharded DSM update: the pair's points in 4 blocks, psum-merged
    ref0 = pair_core(prepared[0][0], prepared[0][1], prepared[0][2],
                     prepared[0][3], scfg, with_plane=False)
    xyz = np.asarray(ref0.xyz).reshape(-1, 3)
    wts = np.asarray(ref0.valid).reshape(-1).astype(np.float32)
    n = (xyz.shape[0] // n_devices) * n_devices
    xy = jnp.asarray(xyz[:n, :2].reshape(n_devices, -1, 2))
    z = jnp.asarray(np.nan_to_num(xyz[:n, 2]).reshape(n_devices, -1))
    w = jnp.asarray(wts[:n].reshape(n_devices, -1))
    cell = 0.6
    x0, y0 = np.floor(np.nanmin(xyz[:, :2], axis=0))
    ny = int(np.ceil((np.nanmax(xyz[:, 1]) - y0) / cell)) + 1
    nx = int(np.ceil((np.nanmax(xyz[:, 0]) - x0) / cell)) + 1
    args = ((float(x0), float(y0)), cell, (ny, nx))
    mesh_all = make_mesh(data=1, tile=n_devices, devices=devs[:n_devices])
    acc4 = sharded_dsm_update(mesh_all, *args, robust_sigma=3.0)(xy, z, w)
    acc1 = sharded_dsm_update(one, *args, robust_sigma=3.0)(xy, z, w)
    filled = np.asarray(acc1.wsum) > 0
    m4 = np.asarray(acc4.vsum) / np.maximum(np.asarray(acc4.wsum), 1e-12)
    m1 = np.asarray(acc1.vsum) / np.maximum(np.asarray(acc1.wsum), 1e-12)
    if not filled.any():
        raise RuntimeError("sharded DSM update: no cell received points")
    close = float((np.abs(m4 - m1)[filled] <= 1e-3).mean())
    info["dsm_update_cells"] = int(filled.sum())
    info["dsm_update_close_frac"] = close
    if close <= MESH_CLOSE_FRAC:
        raise RuntimeError(f"sharded DSM update: {close:.4f} of cells close")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-GPU mesh phase")
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"no GPU: JAX found {devices[0].platform} devices",
              file=sys.stderr)
        return 2

    from pcmi_tpu.utils.compile_cache import enable_compile_cache

    print("compile cache:", enable_compile_cache(), flush=True)
    clock = _CompileClock()
    results: dict = {}
    if args.four:
        with phase("four", clock, results) as info:
            phase_four(info)
    else:
        scene = d288_scene()
        with phase("cli", clock, results) as info:
            phase_cli(info)
        with phase("aoi", clock, results) as info:
            phase_aoi(info, scene=scene)
        with phase("kernels", clock, results) as info:
            phase_kernels(info, scene=scene)
    stats = devices[0].memory_stats() or {}
    print("peak_bytes_in_use:", stats.get("peak_bytes_in_use"), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
