"""User-facing pipeline components.

Names resolve lazily (PEP 562): importing one pipeline, e.g. the stereo
path, does not import the Flax-backed imagery components beside it.
"""

import importlib

_EXPORTS = {
    "HeightMapExtractor": "height_map",
    "HeightMapPipeline": "height_map",
    "PairProduct": "height_map",
    "pair_core": "height_map",
    "product_point_cloud": "height_map",
    "required_max_disp": "height_map",
    "FusedCloud": "multiday",
    "MultiDayFusion": "multiday",
    "fused_consistency_dsm": "multiday",
    "StreamingAOIPipeline": "streaming",
    "AOISpec": "sweep",
    "MultiAOISweep": "sweep",
    "SaliencyDetector": "saliency",
    "RestorationEngine": "restoration",
    "RestorationPlugin": "restoration",
    "ImageStitcher": "stitching",
    "ImageStitchingPlugin": "stitching",
    "OBIAClassifier": "landuse",
    "LandUseClassificationPlugin": "landuse",
    "ObjectDetector": "detection",
    "ObjectAnnotationPlugin": "detection",
    "InpaintingPlugin": "superres",
    "SuperResolutionPlugin": "superres",
    "EnhancementProcessor": "generative",
    "ImageRestorationProcessor": "generative",
    "RestorationGenerativePlugin": "generative",
    "StitchingProcessor": "generative",
    "available_engines": "generative",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{module}"), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
