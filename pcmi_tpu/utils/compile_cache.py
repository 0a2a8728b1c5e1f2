"""One place that decides where JAX keeps its persistent compile cache.

``JAX_COMPILATION_CACHE_DIR``, when set, is the cache: JAX reads it
itself and nothing here overrides it. Otherwise the cache lives at the
fixed path ``<checkout>/.jax_cache``, so repeated runs of one checkout hit
the same entries (the directory is part of the cache key).
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable_compile_cache(min_compile_secs: float = 1.0) -> str:
    """Turn the persistent compile cache on; returns its directory."""
    import jax

    path = os.environ.get(ENV_VAR)
    if not path:
        path = DEFAULT_DIR
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_secs)
    return path
