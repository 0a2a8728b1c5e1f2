"""Typed configuration for every pipeline stage.

The reference scatters its tunables across module constants
(``members/rafael/disparity/constants.py:1-64``) and per-engine default dicts
(``members/marcin/models/satdiff.py:24-55``). Here every stage gets a frozen
dataclass so configs are hashable (usable as jit static args), serialisable,
and overridable from the CLI.

Default values mirror the reference's published envelope where one exists:
``MAX_DISP=288`` rounded to a multiple of 16, SGBM block 15, WLS λ=8000 σ=1.0,
margin-dilation 24 (reference ``constants.py:54-64``), N=10 pairs
(``constants.py:5``), convergence-angle window 5°..45° with incidence ≤ 40°
(``pair_selector.py:84-95``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class StereoConfig:
    """Dense stereo matching envelope.

    The disparity search is signed, ``[-max_disp // 2, max_disp // 2)``,
    matching the reference SGBM setup (``minDisparity=-MAX_DISP/2``,
    ``numDisparities=MAX_DISP`` at reference ``disparity.py:265-267``).
    """

    max_disp: int = 288              # total search width, multiple of 16
    block_size: int = 15             # matching window (cost aggregation)
    # Semi-global aggregation penalties. OpenCV SGBM uses P1=8*c*b^2 and
    # P2=32*c*b^2 on 8-bit costs; ours are expressed relative to a unit-scale
    # census/AD cost.
    sgm_p1: float = 0.03
    sgm_p2: float = 0.48
    sgm_paths: int = 4               # L->R, R->L, T->B, B->T
    # SGM implementation: "auto" runs the Pallas (Triton) kernel where the
    # default backend is a GPU and the XLA scans elsewhere; "pallas" and
    # "xla" force one (the kernel does not compile for the CPU).
    sgm_backend: str = "auto"
    # Right-view disparity for the L/R consistency check:
    #   "horizontal" (default) — SGM on the derived right cost volume with
    #   the two HORIZONTAL paths only. The right view's sole consumer is
    #   the L/R check; measured quality-neutral vs the full 4-path right
    #   matcher (±0.01 m RMSE on synthetic truth) at half the second SGM's
    #   cost.
    #   "full" — 4-path SGM on the derived right volume (the analogue of
    #   cv2.ximgproc.createRightMatcher's full second pass).
    #   "derived" — WTA over the LEFT aggregated volume shifted to the
    #   right frame (C_R(y,x,d) = C_L(y,x+d,d)); the standard single-volume
    #   trick (libSGM / OpenCV CUDA SGM), cheapest but the check loses
    #   independence: +0.0-0.25 m RMSE measured.
    #   "diagonal" — "derived" with an integer right-view WTA (OpenCV
    #   SGBM's own disp2 recipe). The aggregate-derived right view loses
    #   the check's independence and raises RMSE on the synthetic headline
    #   scene, so "horizontal" stays the default.
    right_sgm: str = "horizontal"
    # Sub-pixel parabola for the right-view WTA: off by default — the L/R
    # check tolerates integer right disparities (|dL - dR| <= 1.5 px) and
    # the parabola costs two extra full-volume passes.
    right_subpixel: bool = False
    # Strided grid for the radiometric median/MAD estimate inside pair_core
    # (1 = exact full-canvas sort; 2 = 4x less sort work, statistically
    # identical bounds on megapixel canvases).
    norm_subsample: int = 2
    # Coarse-to-fine matching: full search at half resolution + a local
    # residual window at full resolution. ~5x less cost-volume/SGM work at
    # reference scale (MAX_DISP=288); off by default (full search).
    hierarchical: bool = False
    hierarchical_local_disp: int = 16
    # Edge-aware refinement standing in for the WLS post-filter
    # (reference disparity.py:287-310): fast guided filter.
    gf_radius: int = 9
    gf_eps: float = 1e-3
    wls_passes: int = 2              # reference runs the WLS filter twice
    lr_threshold: float = 1.5        # L/R consistency in px (ref disparity.py:157)
    lr_threshold_final: float = 3.0  # post-refinement threshold (ref :161)
    margin_undefined: int = 24       # invalid-mask dilation (ref constants.py:64)
    cost_type: str = "census_ad"     # census hamming + abs-diff mix
    # Storage dtype of the (D, H, W) cost/aggregation volumes — the
    # matcher's memory traffic is dominated by streaming these, so bf16
    # halves the memory-bound stages. All arithmetic (box aggregation, SGM
    # recurrence state, WTA parabola) stays float32; only the stored
    # volumes quantise (~0.4% of a unit-scale cost). "auto" is float32.
    cost_dtype: str = "auto"
    census_window: int = 7           # census transform window (<=7 for 48-bit)
    ad_weight: float = 0.3           # weight of AD term vs census term
    # Blunder gates (post-matching validity). Foreground-fattening /
    # occlusion blunders concentrate in bands around disparity
    # discontinuities; invalidating those bands per pair is standard MVS
    # practice — multi-date fusion restores coverage from other pairs.
    speckle_median_size: int = 13    # separable median window for the gate
    speckle_threshold: float = 1.5   # max |disp - median| in px
    edge_grad_threshold: float = 0.8 # |∇median-disp| above this = discontinuity
    edge_dilation: int = 6           # half-width of the invalidated band (px)
    photo_threshold: float = 0.1     # max photoconsistency residual [0, 1]
    # The photo threshold is a FLOOR: the gate adapts upward to
    # photo_adapt_factor x the median residual of LR-consistent pixels, so
    # noisy or cross-date-mismatched imagery (where even perfect matches
    # carry a large residual) does not lose completeness to a fixed bound.
    # 0 disables adaptation.
    photo_adapt_factor: float = 3.0
    # Global WTA uniqueness gate: matches whose best aggregated cost is not
    # at least min_margin below the best cost >1 px away are rejected as
    # unreliable (flat/bimodal cost curve — bland texture, repetitive
    # patterns). The reference runs SGBM with uniquenessRatio=0 and leans on
    # WLS confidence instead (disparity.py:269,287-310); a margin gate is
    # the volume-native equivalent. 0 disables.
    min_margin: float = 0.03
    # Band recovery (densification): re-admit discontinuity-band pixels whose
    # match survives three independent checks — agreement with a small-window
    # (census 3 / block 3, no SGM) cross-matcher, a WTA cost-uniqueness
    # margin, and a tightened photoconsistency bound. Recovers most of the
    # ~25% of observable pixels the edge-band gate would discard while
    # rejecting foreground-fattening blunders (the reference densifies with
    # its second WLS pass instead, ``disparity.py:129-155``).
    band_recover: bool = True
    # Window 3 keeps the checker's fattening radius and smoothness bias
    # maximally independent of the main (block 9 + SGM) pass — window 5
    # measurably admits correlated junk on steep-convergence fine-GSD
    # scenes (the reference's MAX_DISP=288 regime); noise robustness comes
    # from the ADAPTIVE input smoothing below instead of a bigger window.
    band_check_census: int = 3       # census window of the cross-matcher
    band_check_block: int = 3        # block size of the cross-matcher
    band_agree_threshold: float = 0.5   # max |disp - cross-check| in px
    band_margin_threshold: float = 0.12 # min (2nd best - best) aggregated cost
    band_photo_factor: float = 0.6   # photo bound = factor * photo_threshold
    # Cross-checker mode: "census" (small square window, no SGM — maximal
    # independence, but uninformative at wide search widths) or
    # "vertical" (census 3 + band_check_vbox-row vertical box + 2-path
    # vertical SGM — ~1 px horizontal fattening radius, informative at
    # any width; the right checker for the MAX_DISP=288 regime).
    band_check_mode: str = "census"
    band_check_vbox: int = 9         # vertical aggregation rows ("vertical")
    # Extra recovery evidence ("vertical" mode): the checker's own WTA
    # uniqueness margin must exceed this. 0 disables.
    band_check_margin: float = 0.0
    # Exclude a thin strip ON the disparity-edge line from recovery:
    # mixed (anti-aliased) pixels straddling a depth edge match
    # consistently in both views yet triangulate to an intermediate
    # height — evidence gates cannot catch them (measured: they pass
    # photo/margin/cross-check). Radius in px; 0 disables.
    band_core_excl: int = 0
    # Pre-match Gaussian smoothing of the normalised inputs (px sigma).
    # The low-texture lever: at per-pixel SNR ~ 1 raw census bits are
    # noise, but the surface signal survives at lower frequency —
    # smoothing trades resolution for matchability (LR-only coverage on
    # the lowtex family: ~2% raw -> ~65% of the observable at sigma 1.5,
    # median |height error| ~0.3-0.5 m). 0 disables.
    presmooth_sigma: float = 0.0
    # Per-pair validity profile:
    #   "strict" — the full blunder-gate cascade (speckle, edge band,
    #     photo, uniqueness, band recovery): the single-pair product.
    #   "lr"     — L/R consistency only. For MULTI-DATE fusion inputs:
    #     the per-pixel gates that protect a single-pair product throw
    #     away most low-texture coverage (their thresholds sit below the
    #     matcher noise there), while the cross-pair consistency mask
    #     (dsm_finalize_multi mad_max) rejects blunders with the
    #     redundancy a single pair does not have.
    gate_profile: str = "strict"
    # Noise-adaptive recovery: a per-scene SNR proxy (Immerkaer noise
    # estimate over high-pass signal, both medians on the valid strided
    # grid) drives three continuous adaptations, all traced (no recompile):
    #   * the cross-matcher inputs blend toward a sigma=1 Gaussian smooth
    #     as the ratio rises (census bits flip under noise; smoothing keeps
    #     recovery alive on noisy/cross-date imagery),
    #   * the agree threshold widens by up to +noise_agree_widen px,
    #   * the band-margin bar ramps up by +noise_margin_ramp as the ratio
    #     approaches 1 (SNR ~ 1: bland surfaces — recovery evidence is
    #     untrustworthy, only the strict gated lane should pass).
    # Calibrated on the six synthetic scene families (clean ~0.5,
    # cross-date ~0.7, 4x noise ~0.75, low-texture ~1.0). 0 disables.
    noise_adapt: float = 1.0         # master scale; 0 = off
    noise_agree_widen: float = 1.0   # px of extra agree slack at ratio>=1
    noise_margin_ramp: float = 0.3   # extra band margin as ratio -> 1
    # Coarse disparity stride: search every s-th disparity at FULL image
    # resolution (volume slice i holds d = d_min + i*s), so every
    # D-proportional stage (cost volume, SGM, WTA, right view, L/R check,
    # photoconsistency) does 1/s of the work. Unlike the pyramid matcher
    # (hierarchical.py) there is no base warp and no texture stretch — the
    # failure mode that sank coarse-to-fine at discontinuities. Sub-pixel
    # recovery: parabola at spacing s, whose larger quantisation the
    # consistency thresholds absorb (see *_eff properties). 1 = exact.
    disp_stride: int = 1
    # Tile-adaptive disparity range (ops.stereo.banded): a 1/scale coarse
    # pass centers an ``adapt_local_disp``-wide window per
    # ``adapt_band_rows x adapt_band_cols`` tile (bilinearly interpolated
    # to a smooth per-pixel warp of the right view), and the
    # full-resolution matcher searches only that window — typically 2x
    # narrower than the geometric envelope on steep scenes.
    # adapt_band_rows=0 disables (full ``max_disp`` search);
    # adapt_band_cols=0 means full-width row bands (ONLY appropriate when
    # disparity barely varies along x — real terrain varies as much along
    # x as y, so 2D tiles are the default choice). Composes with
    # ``disp_stride`` (the stride then samples the LOCAL window).
    adapt_band_rows: int = 0
    adapt_band_cols: int = 64
    adapt_local_disp: int = 96       # local window width (multiple of 16)
    adapt_coarse_scale: int = 4      # coarse-pass downsample factor
    # Warp granularity: the right view shifts by one offset per
    # adapt_warp_chunk-px span (contiguous chunk slices instead of a
    # per-pixel gather). Must divide the canvas width; canvases are padded
    # to 128 (TilingConfig.pad_multiple).
    adapt_warp_chunk: int = 64

    def __post_init__(self):
        object.__setattr__(self, "max_disp", _round_up(int(self.max_disp), 16))
        if self.census_window > 7 or self.census_window < 3 \
                or self.census_window % 2 == 0:
            raise ValueError("census_window must be odd and within [3, 7]")
        if self.sgm_paths != 4:
            raise ValueError("only 4-path SGM (L/R/T/B) is implemented")
        if self.cost_type != "census_ad":
            raise ValueError(f"unknown cost_type {self.cost_type!r}")
        # tri-state strings: a typo must not silently buy the most
        # expensive fallback branch (e.g. right_sgm="horiz" → full 4-path)
        if self.right_sgm not in ("horizontal", "full", "derived",
                                  "diagonal"):
            raise ValueError(f"unknown right_sgm {self.right_sgm!r} "
                             "(expected horizontal/full/derived/diagonal)")
        if self.sgm_backend not in ("auto", "pallas", "xla"):
            raise ValueError(f"unknown sgm_backend {self.sgm_backend!r}")
        if self.cost_dtype not in ("auto", "bfloat16", "float32"):
            raise ValueError(f"unknown cost_dtype {self.cost_dtype!r}")
        if self.disp_stride not in (1, 2, 4):
            raise ValueError(f"disp_stride must be 1, 2 or 4, "
                             f"got {self.disp_stride!r}")
        if self.max_disp % self.disp_stride:
            raise ValueError("max_disp must be a multiple of disp_stride")
        if self.adapt_band_rows:
            if self.hierarchical:
                raise ValueError(
                    "adapt_band_rows and hierarchical are exclusive "
                    "search-reduction strategies")
            if self.adapt_local_disp % 16 or self.adapt_local_disp <= 0:
                raise ValueError("adapt_local_disp must be a positive "
                                 "multiple of 16")
            if self.adapt_local_disp % self.disp_stride:
                raise ValueError(
                    "adapt_local_disp must be a multiple of disp_stride")
            if self.adapt_local_disp > self.max_disp:
                raise ValueError(
                    "adapt_local_disp wider than the max_disp envelope")
            if self.adapt_coarse_scale not in (2, 4, 8):
                raise ValueError("adapt_coarse_scale must be 2, 4 or 8")
            if self.adapt_band_rows % self.adapt_coarse_scale:
                raise ValueError(
                    "adapt_band_rows must be a multiple of adapt_coarse_scale")
            if self.adapt_band_cols % self.adapt_coarse_scale:
                raise ValueError(
                    "adapt_band_cols must be a multiple of adapt_coarse_scale")
            if self.adapt_warp_chunk <= 0:
                raise ValueError("adapt_warp_chunk must be positive")
        if self.band_check_mode not in ("census", "vertical"):
            raise ValueError(f"unknown band_check_mode "
                             f"{self.band_check_mode!r}")
        if self.gate_profile not in ("strict", "lr"):
            raise ValueError(f"unknown gate_profile {self.gate_profile!r}")

    @property
    def min_disparity(self) -> int:
        return -self.max_disp // 2

    @property
    def num_disparities(self) -> int:
        return self.max_disp

    # Strided search quantises both WTA estimates to a disp_stride-px grid;
    # each consistency comparison can move by up to 0.5*(s-1) px per side
    # from quantisation alone, so the pixel thresholds widen by that much
    # to keep the REJECTION power aimed at genuine mismatches, not grid
    # noise (at the default stride 1 these equal the raw thresholds).
    @property
    def lr_threshold_eff(self) -> float:
        return self.lr_threshold + 0.5 * (self.disp_stride - 1)

    @property
    def lr_threshold_final_eff(self) -> float:
        return self.lr_threshold_final + 0.5 * (self.disp_stride - 1)

    @property
    def band_agree_threshold_eff(self) -> float:
        return self.band_agree_threshold + 0.5 * (self.disp_stride - 1)


@dataclass(frozen=True)
class RectifyConfig:
    """Affine-camera epipolar rectification (replaces ASP ``stereo -t rpc``).

    The probe grid samples the RPC cameras over the AOI x height range to fit
    affine cameras and the affine fundamental matrix; this is the in-memory,
    jittable replacement for the external Ames Stereo Pipeline call at
    reference ``processing.py:12-18,61-83``.
    """

    probe_grid: Tuple[int, int, int] = (8, 8, 5)   # lon x lat x height samples
    height_range: Tuple[float, float] = (0.0, 50.0)  # ref constants.py:25 H_RANGE
    interp_order: int = 1            # bilinear warps (the only implemented order)

    def __post_init__(self):
        if self.interp_order != 1:
            raise ValueError("only bilinear (interp_order=1) warps are implemented")


@dataclass(frozen=True)
class PairSelectionConfig:
    """Multi-date pair selection heuristics (ref ``pair_selector.py:72-99``)."""

    n_pairs: int = 10                # ref constants.py:5
    min_convergence_deg: float = 5.0
    max_convergence_deg: float = 45.0
    max_incidence_deg: float = 40.0


@dataclass(frozen=True)
class FusionConfig:
    """Multi-day point-cloud fusion (the capability the reference README
    advertises at ``README.md:17`` but never implements — see SURVEY §2.2)."""

    kmeans_clusters: int = 64
    kmeans_iters: int = 20
    knn_k: int = 8
    knn_sigma: float = 3.0           # MAD multiples for outlier rejection
    grid_cell: float = 0.5           # height-map gridding cell (px units)
    icp_iters: int = 10
    icp_subsample: int = 8192


@dataclass(frozen=True)
class TilingConfig:
    """Fixed-shape spatial tiling (jit/pjit discipline).

    The reference tiles everywhere ad hoc (saliency 512 px tiles, SAHI 640 px
    slices, TILE_SIZE=1000 constant at ``constants.py:27``); here tiling is one
    first-class mechanism with halo exchange for sharded stereo.
    """

    tile: int = 1024
    halo: int = 160                  # >= max_disp/2 + block for stereo tiles
    pad_multiple: int = 128          # canvas alignment (fixed jit shapes)


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh axes for pjit/shard_map scale-out."""

    data_axis: str = "data"          # stereo pairs / dates
    tile_axis: str = "tile"          # spatial tiles (halo-exchanged)
    data: int = 1
    tile: int = 1


@dataclass(frozen=True)
class PipelineConfig:
    """Top-level flagship pipeline config."""

    stereo: StereoConfig = StereoConfig()
    rectify: RectifyConfig = RectifyConfig()
    pairs: PairSelectionConfig = PairSelectionConfig()
    fusion: FusionConfig = FusionConfig()
    tiling: TilingConfig = TilingConfig()
    mesh: MeshConfig = MeshConfig()
    height_percentiles: Tuple[float, float] = (2.0, 98.0)  # ref plugin.py:181-191
    ground_percentile: float = 2.0
    # Blunder-gate thresholds in PHYSICAL units. The pixel-denominated
    # StereoConfig gates (speckle_threshold px, edge_grad_threshold px/px)
    # only make sense at one disparity gain; steep-convergence / fine-GSD
    # geometries have gains of 5+ px/m, where ordinary terrain slopes would
    # read as "discontinuities" in pixel units and the edge-band gate would
    # swallow the whole frame. ``HeightMapPipeline.stereo_cfg_for`` converts
    # these to pixels via the geometry's actual gain; the defaults reproduce
    # the pixel defaults exactly at the 1.2 px/m gain they were tuned at.
    speckle_threshold_m: float = 1.0      # max |disp - median| (metres height)
    edge_step_m: float = 0.5              # height step/px that reads as an edge
    metric_gates: bool = True             # False = use raw pixel thresholds

    def replace(self, **kw) -> "PipelineConfig":
        return dataclasses.replace(self, **kw)


def from_flat_overrides(base: PipelineConfig, overrides: dict) -> PipelineConfig:
    """Apply ``{"stereo.max_disp": 192, ...}`` style overrides (CLI surface)."""
    grouped: dict = {}
    for key, value in overrides.items():
        if "." in key:
            section, field = key.split(".", 1)
            grouped.setdefault(section, {})[field] = value
        else:
            grouped[key] = value
    updates = {}
    for section, value in grouped.items():
        current = getattr(base, section)
        if isinstance(value, dict) and dataclasses.is_dataclass(current):
            updates[section] = dataclasses.replace(current, **value)
        else:
            updates[section] = value
    return dataclasses.replace(base, **updates)
