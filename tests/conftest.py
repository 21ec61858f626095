"""Test configuration: the CPU with an 8-device virtual mesh by default.

The suite runs on the CPU so it is deterministic, runs anywhere, and can
exercise multi-device sharding without a GPU. ``JAX_PLATFORMS`` is only
defaulted here, so tests marked ``gpu`` run on the card when it is set:

    JAX_PLATFORMS=cuda,cpu python -m pytest tests -m gpu

Whether a GPU is present is decided inside the ``gpu_device`` fixture, never
while a module is imported, so every pytest-xdist worker collects the same
tests.
"""
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()


@pytest.fixture
def gpu_device():
    """The first GPU; skips the test where JAX sees none."""
    import jax

    try:
        gpus = jax.devices("gpu")
    except RuntimeError:
        gpus = []
    if not gpus:
        pytest.skip("needs a GPU: run `JAX_PLATFORMS=cuda,cpu python -m "
                    "pytest tests -m gpu` on a machine with one")
    return gpus[0]
