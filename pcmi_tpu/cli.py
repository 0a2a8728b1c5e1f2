"""Headless CLI — the primary entry point the reference never had.

The reference is launchable only through the napari GUI (``viewer.py:400``,
SURVEY §7 step 6 calls this out as a weakness). Here every component runs
headless over TIFF inputs:

    python -m pcmi_tpu list
    python -m pcmi_tpu run saliency --input scene.tif --output out/
    python -m pcmi_tpu run stitching --input a.tif --input2 b.tif --output out/
    python -m pcmi_tpu height-map --demo --output out/        # synthetic scene
    python -m pcmi_tpu fuse --demo --output out/              # multi-day fusion
    python -m pcmi_tpu bench

Config overrides use dotted keys: ``--set stereo.max_disp=128``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def _load_image(path: str) -> np.ndarray:
    from pcmi_tpu.io.raster import read_tiff

    return np.asarray(read_tiff(path), np.float32)


def _save_layers(layers, outdir: str) -> list:
    import re

    from pcmi_tpu.io.raster import write_tiff

    os.makedirs(outdir, exist_ok=True)
    written = []
    for data, params, kind in layers:
        # sanitise: error-layer names embed exception text, which routinely
        # contains '/' and other path-hostile characters
        name = re.sub(r"[^A-Za-z0-9._-]+", "_",
                      str(params.get("name", kind)))[:128] or kind
        arr = np.asarray(data)
        if kind in ("image", "labels") and arr.ndim in (2, 3):
            path = os.path.join(outdir, f"{name}.tif")
            write_tiff(path, arr.astype(np.float32))
        else:
            path = os.path.join(outdir, f"{name}.json")
            with open(path, "w", encoding="utf-8") as fh:
                json.dump(np.asarray(data).tolist(), fh)
        written.append(path)
    return written


def _parse_overrides(pairs):
    out = {}
    for p in pairs or []:
        key, _, val = p.partition("=")
        try:
            out[key] = json.loads(val)
        except json.JSONDecodeError:
            out[key] = val
    return out


_DEMO_VIEWS = ((10.0, 80.0), (20.0, 250.0), (16.0, 170.0))


def _demo_scene(cfg):
    from pcmi_tpu.geometry.synthetic import aoi_lonlat_ranges, make_stereo_scene

    scene = make_stereo_scene(
        seed=1, out_shape=(512, 512), ground_shape=(640, 640),
        h_range=cfg.rectify.height_range,
        views=_DEMO_VIEWS,
    )
    return scene, aoi_lonlat_ranges(scene)


def _load_stack(args, cfg):
    """Shared --images/--demo dispatch for fuse/stream.

    Returns ``(images, rpcs, metas, lon_r, lat_r)`` or ``None`` after
    printing a usage/diagnostic message (caller exits 2).
    """
    from pcmi_tpu.geometry.pairs import ImageMeta

    if getattr(args, "images", None):
        if not getattr(args, "kml", None):
            print("--images requires --kml AOI", file=sys.stderr)
            return None
        from pcmi_tpu.pipelines.ingest import (
            discover_acquisitions,
            prepare_aoi_stack,
        )

        acqs = discover_acquisitions(args.images)
        if not acqs:
            print(f"no usable acquisitions in {args.images}", file=sys.stderr)
            return None
        images, rpcs, metas, lon_r, lat_r = prepare_aoi_stack(
            acqs, kml_path=args.kml)
        if len(images) < 2:
            print("fewer than two acquisitions intersect the AOI",
                  file=sys.stderr)
            return None
        return images, rpcs, metas, lon_r, lat_r
    if args.demo:
        scene, (lon_r, lat_r) = _demo_scene(cfg)
        metas = [ImageMeta(i, inc, az, date=30.0 * i)
                 for i, (inc, az) in enumerate(_DEMO_VIEWS)]
        return scene.images, scene.rpcs, metas, lon_r, lat_r
    print("need --demo or --images DIR --kml FILE", file=sys.stderr)
    return None


def cmd_list(args) -> int:
    from pcmi_tpu import registry

    for name in registry.available():
        print(name)
    fails = registry.failures()
    if fails:
        print("\nunavailable:", file=sys.stderr)
        for name, err in fails.items():
            print(f"  {name}: {err.splitlines()[-1]}", file=sys.stderr)
    return 0


def cmd_run(args) -> int:
    from pcmi_tpu import registry

    try:
        plugin = registry.create(args.plugin)
    except KeyError as exc:
        print(exc.args[0], file=sys.stderr)
        return 2
    image = _load_image(args.input)
    kwargs = {}
    if args.input2:
        kwargs["image2"] = _load_image(args.input2)
    failed = False
    try:
        layers = plugin.run(image, **kwargs)
    except Exception as exc:  # degrade like the reference's error layer
        # (ref viewer.py:384-387 returns an error-named placeholder layer)
        layers = [(np.zeros((8, 8), np.float32),
                   {"name": f"ERROR {plugin.name}: {exc}"}, "image")]
        print(f"error: {exc}", file=sys.stderr)
        failed = True
    for path in _save_layers(layers, args.output):
        print(path)
    # a placeholder layer is NOT a product: headless callers need the
    # failure in the exit status
    return 1 if failed else 0


def cmd_height_map(args) -> int:
    """Single-pair flagship: sources -> rectify -> disparity -> height.

    Accepts the same sources as ``fuse``: ``--demo`` or real
    ``--images DIR --kml FILE`` acquisitions ingested through
    ``prepare_aoi_stack`` (the reference flow ``widget.py:98-147`` ->
    ``disparity/plugin.py:36-243``). The best-convergence pair is
    selected with the reference's Facciolo heuristic; products are the
    canvas-space height/disparity rasters, the point cloud, and a
    georeferenced north-up DSM GeoTIFF.
    """
    from pcmi_tpu.config import PipelineConfig, from_flat_overrides
    from pcmi_tpu.geometry.pairs import select_pairs, take_pairs
    from pcmi_tpu.io.raster import write_ply, write_tiff
    from pcmi_tpu.pipelines.height_map import (
        HeightMapPipeline,
        product_point_cloud,
    )

    cfg = from_flat_overrides(PipelineConfig(), _parse_overrides(args.set))
    stack = _load_stack(args, cfg)
    if stack is None:
        return 2
    images, rpcs, metas, lon_r, lat_r = stack
    cands = take_pairs(select_pairs(metas, cfg.pairs), 1)
    if not cands:  # no geometrically valid pair: best-ranked late bloomer
        cands = select_pairs(metas, cfg.pairs)[:1]
    pair = cands[0]
    i, j = pair.i, pair.j

    pipe = HeightMapPipeline(cfg)
    geom = pipe.build_geometry(rpcs[i], rpcs[j], lon_r, lat_r,
                               images[i].shape, images[j].shape)
    product = pipe.process_pair(images[i], images[j], geom)
    os.makedirs(args.output, exist_ok=True)
    write_tiff(os.path.join(args.output, "height.tif"),
               np.asarray(product.height))
    write_tiff(os.path.join(args.output, "disparity.tif"),
               np.asarray(product.disparity))
    pts, w = product_point_cloud(product)
    keep = np.asarray(w) > 0
    pts = np.asarray(pts)[keep]
    wts = np.asarray(w)[keep].astype(np.float32)
    write_ply(os.path.join(args.output, "cloud.ply"), pts, pts[:, 2])

    # Georeferenced product: grid the pair's points to a north-up DSM
    # (the reference's per-pair napari points layer becomes a GeoTIFF).
    dsm_shape = None
    if len(pts):
        import jax.numpy as jnp

        from pcmi_tpu.pipelines.streaming import (
            StreamingDSM,
            dsm_finalize,
            dsm_update,
        )

        cell = 2.0
        x0 = float(np.floor(pts[:, 0].min()))
        y0 = float(np.floor(pts[:, 1].min()))
        nx = max(int(np.ceil((pts[:, 0].max() - x0) / cell)) + 1, 1)
        ny = max(int(np.ceil((pts[:, 1].max() - y0) / cell)) + 1, 1)
        acc = StreamingDSM(wsum=jnp.zeros((ny, nx)),
                           vsum=jnp.zeros((ny, nx)),
                           vsq=jnp.zeros((ny, nx)))
        acc = dsm_update(acc, jnp.asarray(pts[:, :2]),
                         jnp.asarray(pts[:, 2]), jnp.asarray(wts),
                         (x0, y0), cell, (ny, nx), robust_sigma=3.0)
        dsm, _ = dsm_finalize(acc)
        _write_north_up(os.path.join(args.output, "dsm.tif"), dsm,
                        (x0, y0), cell)
        dsm_shape = [ny, nx]

    valid = np.asarray(product.valid)
    print(json.dumps({
        "pair": [metas[i].name or str(i), metas[j].name or str(j)],
        "convergence_deg": round(pair.convergence_deg, 2),
        "canvas": list(geom.out_shape),
        "valid_fraction": float(valid.mean()),
        "points": int(keep.sum()),
        "dsm_shape": dsm_shape,
    }))
    return 0


def _write_north_up(path: str, img: "np.ndarray",
                    origin_min_xy, cell: float) -> None:
    """Write a grid whose row 0 sits at min-y as a north-up GeoTIFF.

    GeoTIFF's raster→model transform is Y = Y0 - row*ScaleY with ScaleY
    positive; GDAL/QGIS warn on (and by default abs()) a negative ScaleY.
    So flip rows, anchor the tiepoint at the max-y outer corner, and keep
    sy positive — matching write_tiff's documented convention.
    """
    from pcmi_tpu.io.raster import write_tiff

    x0, y0 = origin_min_xy
    ny = img.shape[0]
    write_tiff(path, np.ascontiguousarray(img[::-1]),
               geo={"origin": (float(x0), float(y0) + ny * float(cell)),
                    "scale": (float(cell), float(cell))})


def cmd_fuse(args) -> int:
    from pcmi_tpu.config import PipelineConfig, from_flat_overrides
    from pcmi_tpu.geometry.pairs import ImageMeta
    from pcmi_tpu.io.raster import write_ply
    from pcmi_tpu.pipelines.multiday import MultiDayFusion

    cfg = from_flat_overrides(PipelineConfig(), _parse_overrides(args.set))
    stack = _load_stack(args, cfg)
    if stack is None:
        return 2
    images, rpcs, metas, lon_r, lat_r = stack
    fusion = MultiDayFusion(cfg)
    fused = fusion.run(images, rpcs, metas, lon_r, lat_r,
                       points_per_pair=1 << 16, with_kmeans=True,
                       grid_cell=2.0)
    os.makedirs(args.output, exist_ok=True)
    _write_north_up(os.path.join(args.output, "dsm.tif"),
                    np.asarray(fused.dsm), fused.grid_origin,
                    fused.grid_cell)
    keep = np.asarray(fused.weights) > 0
    pts = np.asarray(fused.points)[keep]
    write_ply(os.path.join(args.output, "fused_cloud.ply"), pts, pts[:, 2])
    print(json.dumps({
        "dsm_shape": list(np.asarray(fused.dsm).shape),
        "points": int(keep.sum()),
        "icp_rmse": [float(x) for x in np.asarray(fused.icp_rmse)],
    }))
    return 0


def _write_hillshade(path: str, dsm: np.ndarray, cell: float) -> None:
    """Shaded-relief PNG of a DSM (the at-a-glance product check)."""
    from pcmi_tpu.utils.visualize import save_image

    z = np.nan_to_num(dsm, nan=float(np.nanmin(dsm) if np.isfinite(dsm).any() else 0))
    gy, gx = np.gradient(z, cell)
    az, alt = np.radians(315.0), np.radians(45.0)
    slope = np.arctan(np.hypot(gx, gy))
    aspect = np.arctan2(-gx, gy)
    shade = (np.sin(alt) * np.cos(slope)
             + np.cos(alt) * np.sin(slope) * np.cos(az - aspect))
    shade = np.where(np.isfinite(dsm), shade, np.nan)
    save_image(path, shade)


def cmd_stream(args) -> int:
    """Streaming whole-AOI pipeline (BASELINE configs 3-4)."""
    from pcmi_tpu.config import PipelineConfig, from_flat_overrides
    from pcmi_tpu.geometry.pairs import ImageMeta
    from pcmi_tpu.pipelines.streaming import StreamingAOIPipeline

    cfg = from_flat_overrides(PipelineConfig(), _parse_overrides(args.set))
    stack = _load_stack(args, cfg)
    if stack is None:
        return 2
    images, rpcs, metas, lon_r, lat_r = stack
    out = StreamingAOIPipeline(cfg).run(images, rpcs, metas, lon_r, lat_r,
                                        grid_cell=1.0)
    os.makedirs(args.output, exist_ok=True)
    _write_north_up(os.path.join(args.output, "dsm.tif"),
                    np.asarray(out["dsm"], np.float32),
                    out["origin"], out["cell"])
    _write_north_up(os.path.join(args.output, "n_pairs.tif"),
                    np.asarray(out["n_pairs_per_cell"], np.float32),
                    out["origin"], out["cell"])
    _write_hillshade(os.path.join(args.output, "hillshade.png"),
                     out["dsm"], out["cell"])
    print(json.dumps({
        "dsm_shape": list(out["dsm"].shape), "pairs": out["pairs"],
        "tiles": out["tiles"],
        "filled": float(np.isfinite(out["dsm"]).mean()),
    }))
    return 0


def cmd_bench(args) -> int:
    # bench.py lives at the repo root, which is only importable when cwd
    # happens to be the root — load it by path instead
    import importlib.util

    import pcmi_tpu

    root = os.path.dirname(os.path.dirname(os.path.abspath(pcmi_tpu.__file__)))
    path = os.path.join(root, "bench.py")
    if not os.path.exists(path):
        print(f"bench.py not found at {path} (source checkout required)",
              file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("pcmi_bench", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="pcmi_tpu", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    sub.add_parser("list", help="list available plugins")

    rp = sub.add_parser("run", help="run a plugin over a TIFF")
    rp.add_argument("plugin")
    rp.add_argument("--input", required=True)
    rp.add_argument("--input2")
    rp.add_argument("--output", default="out")

    for name in ("height-map", "fuse", "stream"):
        p = sub.add_parser(name)
        p.add_argument("--demo", action="store_true",
                       help="use the synthetic ground-truth scene")
        p.add_argument("--images", help="directory of NTF/TIFF acquisitions")
        p.add_argument("--kml", help="AOI polygon (with --images)")
        p.add_argument("--output", default="out")
        p.add_argument("--set", action="append",
                       help="config override, e.g. stereo.max_disp=128")

    sub.add_parser("bench", help="run the standard benchmark")

    args = ap.parse_args(argv)
    from pcmi_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    return {
        "list": cmd_list,
        "run": cmd_run,
        "height-map": cmd_height_map,
        "fuse": cmd_fuse,
        "stream": cmd_stream,
        "bench": cmd_bench,
    }[args.cmd](args)


if __name__ == "__main__":
    raise SystemExit(main())
