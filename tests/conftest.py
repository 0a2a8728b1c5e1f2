"""Test harness: an 8-device virtual CPU mesh unless the caller says otherwise.

The reference has no test suite (SURVEY §4); this framework tests every
kernel against NumPy references and validates multi-device sharding on a
virtual CPU mesh. ``JAX_PLATFORMS`` defaults to ``cpu``; a caller that sets
it (``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`` on the card)
keeps its choice. Tests that need the card carry the ``gpu`` marker and
take the ``gpu_device`` fixture, which skips where there is none.

XLA flags must be set before the first ``import jax`` in the test process.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", False)

from pcmi_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

# the stereo/pipeline graphs are large; caching their executables makes
# repeat suite runs dominated by execution only
enable_compile_cache()

import numpy as np  # noqa: E402
import pytest  # noqa: E402

try:
    import flax  # noqa: E402,F401
except ImportError:
    # the learned imagery components need the optional `models` extra;
    # where it is absent (the GPU machine) their modules are not collected
    collect_ignore = ["test_detector.py", "test_dp_training.py",
                      "test_generative.py", "test_misc.py", "test_models.py",
                      "test_quality_gates.py"]


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test where JAX sees none."""
    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip("needs a GPU: run `JAX_PLATFORMS=cuda python -m pytest "
                    "-m gpu tests/` on the card")
    return gpus[0]


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Free compiled executables at module teardown.

    Late test modules would otherwise hold every executable the earlier
    modules compiled, and the allocator pressure slows the big stereo
    executables several-fold. Cross-module executable reuse is rare
    (modules use distinct canvas/config combinations), so clearing at
    module boundaries trades nothing for bounded memory."""
    yield
    jax.clear_caches()
