"""What running on a new machine depends on: the compile-cache location,
the main path's imports, and the GPU smoke script's refusal to run
without a GPU."""

import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra)
    return env


@pytest.mark.parametrize("env_dir", [False, True])
def test_compile_cache_location(monkeypatch, tmp_path, env_dir):
    import jax

    from pcmi_tpu.utils import compile_cache

    before = jax.config.jax_compilation_cache_dir
    try:
        if env_dir:
            monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path))
            jax.config.update("jax_compilation_cache_dir", str(tmp_path))
            assert compile_cache.enable_compile_cache() == str(tmp_path)
            # the variable's directory stands; nothing in code replaces it
            assert jax.config.jax_compilation_cache_dir == str(tmp_path)
        else:
            monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
            path = compile_cache.enable_compile_cache()
            assert path == os.path.join(REPO, ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


@pytest.mark.parametrize("module", ["pcmi_tpu.pipelines.streaming",
                                    "pcmi_tpu.cli"])
def test_main_path_imports_no_model_stack(module):
    """The stereo path must import on a machine without flax/orbax."""
    code = (f"import sys, {module}; "
            "bad = sorted({m.split('.')[0] for m in sys.modules} "
            "& {'flax', 'orbax', 'tifffile'}); print(bad); "
            "sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], env=_env(),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_refuses_cpu(tmp_path, alone):
    """No GPU (or no repository beside it): non-zero exit, no result line."""
    script = os.path.join(REPO, "chip_smoke.py")
    env = _env(JAX_PLATFORMS="cpu")
    if alone:
        script = shutil.copy(script, tmp_path / "chip_smoke.py")
        env["PYTHONPATH"] = ""
    proc = subprocess.run([sys.executable, str(script)], env=env,
                          cwd=str(tmp_path), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
