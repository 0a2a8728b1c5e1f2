"""Multi-scene accuracy harness (fast CPU subset).

Every scene family must pass the ≤1 m height-RMSE gate with the PRODUCTION
fast paths on (right_subpixel=False, norm_subsample=2,
right_sgm="horizontal" — the StereoConfig defaults): no fast path is
accepted on the single scene it was tuned on. This is the per-commit
regression subset of the full-size sweep.
"""

import pytest

from pcmi_tpu.config import PipelineConfig, RectifyConfig, StereoConfig
from pcmi_tpu.geometry.synthetic import SCENE_FAMILIES, make_family_scene
from pcmi_tpu.pipelines.evaluation import evaluate_pair_accuracy

H_RANGE = (0.0, 40.0)

# identical stereo/rectify config for every family => one compiled
# pair_core executable serves all six parametrisations
CFG = PipelineConfig(
    stereo=StereoConfig(block_size=9, census_window=5, margin_undefined=8),
    rectify=RectifyConfig(height_range=H_RANGE),
)

# Per-family completeness floors. lowtex is a per-pixel-SNR ~ 1 scene: the
# CPU reference matcher (SGBM-class) scores 5.4 m RMSE at 64% completeness
# on it — dense accuracy is physically unavailable, so the noise-adaptive
# gates switch band recovery off (StereoConfig.noise_margin_ramp) and keep
# only high-margin pixels: sparse but ACCURATE, with coverage recovered by
# multi-day fusion. noisy runs 4x the default sensor noise; 0.45 reflects
# the honest single-pair yield there.
MIN_COMPLETENESS = {"lowtex": 0.02, "noisy": 0.45}


@pytest.mark.parametrize("family", sorted(SCENE_FAMILIES))
def test_family_accuracy(family):
    scene = make_family_scene(family, seed=11, out_shape=(320, 320),
                              ground_shape=(448, 448), h_range=H_RANGE)
    score = evaluate_pair_accuracy(scene, CFG)
    assert score["rmse_m"] <= 1.0, f"{family}: RMSE {score['rmse_m']:.3f} m"
    assert abs(score["bias_m"]) <= 0.5, f"{family}: bias {score['bias_m']:+.3f} m"
    min_c = MIN_COMPLETENESS.get(family, 0.5)
    assert score["completeness"] >= min_c, (
        f"{family}: completeness {score['completeness']:.3f} < {min_c}")
