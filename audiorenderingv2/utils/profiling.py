"""Profiling helpers.

Replaces the reference's ad-hoc std::chrono prints (AudioRenderer.cpp:495-518,
595-660) with structured timers and optional jax.profiler traces.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import jax


@dataclass
class Timer:
    """Accumulating named wall-clock timer; call in a with-block."""

    name: str
    times: list = field(default_factory=list)

    @contextlib.contextmanager
    def measure(self, sync: jax.Array | None = None):
        t0 = time.perf_counter()
        yield
        if sync is not None:
            jax.block_until_ready(sync)
        self.times.append(time.perf_counter() - t0)

    @property
    def last_ms(self) -> float:
        return self.times[-1] * 1000.0 if self.times else 0.0

    @property
    def median_ms(self) -> float:
        if not self.times:
            return 0.0
        s = sorted(self.times)
        return s[len(s) // 2] * 1000.0


@contextlib.contextmanager
def trace(log_dir: str):
    """jax.profiler trace context — inspect with TensorBoard/XProf."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def rays_per_second(n_rays: int, seconds: float) -> float:
    return n_rays / seconds if seconds > 0 else 0.0


def require_gpus(n: int = 1) -> list:
    """The first ``n`` GPUs JAX sees; raises SystemExit naming the missing
    device otherwise, so a measurement never falls back to the CPU."""
    try:
        gpus = jax.devices("gpu")
    except RuntimeError:
        gpus = []
    if len(gpus) < n:
        raise SystemExit(
            f"needs {n} GPU(s), JAX found {len(gpus)} "
            f"(default backend: {jax.default_backend()})")
    return gpus[:n]


def gpu_card_info() -> list[str]:
    """``name, power.limit`` of each card, as nvidia-smi reports them."""
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return [line.strip() for line in out.splitlines() if line.strip()]
