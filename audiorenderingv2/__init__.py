"""audiorenderingv2 — differentiable acoustic renderer in JAX.

A from-scratch JAX/XLA re-design of the capability surface of
sgrazi/AudioRenderingV2 (real-time geometric-acoustics auralization:
scene -> sound-ray path tracing -> binaural impulse response -> FFT
convolution -> audio), extended with end-to-end differentiability and
multi-device scaling over jax.sharding meshes.
"""

__version__ = "0.1.0"

import os as _os

# The persistent compile cache's default home: a fixed directory inside the
# checkout (listed in .gitignore), so repeat processes hit the same entries.
DEFAULT_COMPILE_CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".jax_cache")


def _compile_cache_dir(environ=_os.environ) -> str | None:
    """Where this package points JAX's persistent compile cache: None when
    ``JAX_COMPILATION_CACHE_DIR`` is set (JAX reads it itself and nothing
    else is set here), else :data:`DEFAULT_COMPILE_CACHE_DIR`."""
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return DEFAULT_COMPILE_CACHE_DIR


def _enable_compile_cache():
    path = _compile_cache_dir()
    if path is None:
        return
    import jax

    jax.config.update("jax_compilation_cache_dir", path)


_enable_compile_cache()

from . import constants
from .config import Config, MaterialSpec, PathtracerParams, RendererParams, SceneParams, load_config, parse_config
from .core.tracer_ref import TraceParams
from .core.tracer import TracerOptions, SceneArrays, scene_to_arrays, trace_ir
from .scene import Scene, build_scene, load_scene

__all__ = [
    "constants",
    "Config", "MaterialSpec", "PathtracerParams", "RendererParams",
    "SceneParams", "load_config", "parse_config",
    "TraceParams", "TracerOptions", "SceneArrays", "scene_to_arrays",
    "trace_ir", "Scene", "build_scene", "load_scene",
]
