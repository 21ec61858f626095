"""Where the package points JAX's persistent compilation cache.

With ``JAX_COMPILATION_CACHE_DIR`` set, JAX reads it and the package sets
nothing; otherwise the cache lives at a fixed ``<checkout>/.jax_cache``.
"""
import os
import subprocess
import sys
from pathlib import Path

import audiorenderingv2

ROOT = Path(__file__).resolve().parents[1]


def test_env_var_set_means_package_sets_nothing():
    env = {"JAX_COMPILATION_CACHE_DIR": "/somewhere/else"}
    assert audiorenderingv2._compile_cache_dir(env) is None


def test_default_is_fixed_dir_in_checkout():
    path = audiorenderingv2._compile_cache_dir({})
    assert path == audiorenderingv2.DEFAULT_COMPILE_CACHE_DIR
    assert Path(path) == ROOT / ".jax_cache"


def _cache_dir_in_fresh_process(env_value):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    if env_value is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_value
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run(
        [sys.executable, "-c",
         "import audiorenderingv2, jax; "
         "print(jax.config.jax_compilation_cache_dir)"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120,
        check=True)
    return out.stdout.strip().splitlines()[-1]


def test_process_with_env_var_uses_it(tmp_path):
    assert _cache_dir_in_fresh_process(str(tmp_path)) == str(tmp_path)


def test_process_without_env_var_uses_checkout_dir():
    assert _cache_dir_in_fresh_process(None) == str(ROOT / ".jax_cache")
