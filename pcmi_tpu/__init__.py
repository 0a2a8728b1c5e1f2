"""pcmi_tpu — JAX 3D point-cloud / multi-day satellite imagery framework.

A from-scratch JAX/XLA/Pallas rebuild of the capability surface of
``rafael-alani/3d-point-cloud-multiday-imagery`` (a napari plugin host whose
flagship is a multi-day WV3 stereo -> disparity -> height-map -> 3D point
cloud pipeline; see reference ``README.md:1`` and
``members/rafael/disparity/``).

Design principles (accelerator-first, not a port):

* All compute paths are jittable JAX; the SGM recurrence has a Pallas
  kernel for the GPU.
* Geometry (RPC cameras, epipolar rectification) is closed-form math in JAX,
  replacing the reference's external GDAL / Ames Stereo Pipeline binaries
  (reference ``preprocessing.py:7-96``, ``processing.py:12-18``).
* Data flows through memory as fixed-shape batched arrays with validity
  masks, replacing the reference's filesystem bus (``data/TEMP`` layout,
  reference ``constants.py:36-49``).
* Scale-out is a ``jax.sharding.Mesh`` with ``shard_map`` halo exchange over
  spatial tiles and data parallelism over stereo pairs / acquisition dates.

Import layout::

    pcmi_tpu.interface   plugin contract (layer tuples, reference interface.py)
    pcmi_tpu.config      typed dataclass configs
    pcmi_tpu.geometry    RPC cameras, rectification, triangulation, pairs
    pcmi_tpu.ops         shared array ops + stereo kernels
    pcmi_tpu.models      Flax models (U-Nets, GAN, DIP, diffusion, detection)
    pcmi_tpu.pipelines   user-facing components (height-map, fusion, ...)
    pcmi_tpu.parallel    mesh / sharding / halo-exchange utilities
    pcmi_tpu.io          raster + point-cloud I/O (host side)
    pcmi_tpu.utils       profiling, logging, checkpointing
"""

__version__ = "0.1.0"

from pcmi_tpu.interface import Layer, LayerParams, LayerType, SatellitePlugin

__all__ = [
    "Layer",
    "LayerParams",
    "LayerType",
    "SatellitePlugin",
    "__version__",
]
