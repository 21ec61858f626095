"""Experimentation / measurement harness.

The counterpart of the reference's experimentation mode
(main.cpp:531-626 + Experimentation.cpp:20-41 + Utils.cpp:34-85): run N
timed render+convolve rounds, report average/median stage times, and measure
Monte-Carlo noise as the mean / stddev / coefficient-of-variation of the IR
peak across rounds. The reference needed this statistical check because its
clock-seeded RNG made every run different; here rounds use independent
deterministic keys, so the CoV measures true MC variance reproducibly.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import jax
import numpy as np


@dataclass
class StageStats:
    times_ms: list = field(default_factory=list)

    def add(self, seconds: float) -> None:
        self.times_ms.append(seconds * 1000.0)

    @property
    def average(self) -> float:
        return float(np.mean(self.times_ms)) if self.times_ms else 0.0

    @property
    def median(self) -> float:
        return float(np.median(self.times_ms)) if self.times_ms else 0.0


@dataclass
class ExperimentResults:
    """Stage timings + IR-peak Monte-Carlo statistics."""

    rounds: int
    render: StageStats
    convolute: StageStats
    convolute_process: StageStats
    ir_peaks: np.ndarray

    @property
    def peak_mean(self) -> float:
        return float(np.mean(self.ir_peaks))

    @property
    def peak_stddev(self) -> float:
        return float(np.std(self.ir_peaks))

    @property
    def peak_cov(self) -> float:
        """Coefficient of variation of the IR peak across rounds
        (Utils.cpp:34-64)."""
        m = self.peak_mean
        return self.peak_stddev / m if m else 0.0

    def summary(self) -> str:
        return "\n".join([
            f"rounds: {self.rounds}",
            f"avg render time: {self.render.average:.2f} ms",
            f"median render time: {self.render.median:.2f} ms",
            f"avg convolute time: {self.convolute.average:.2f} ms",
            f"median convolute time: {self.convolute.median:.2f} ms",
            f"avg convolute process time: {self.convolute_process.average:.2f} ms",
            f"median convolute process time: {self.convolute_process.median:.2f} ms",
            f"IR peak mean: {self.peak_mean:.6e}",
            f"IR peak stddev: {self.peak_stddev:.6e}",
            f"IR peak coefficient of variation: {self.peak_cov:.4f}",
        ])


def run_experiment(renderer, samples: np.ndarray | None = None,
                   rounds: int = 100, warmup: int = 1) -> ExperimentResults:
    """Time ``rounds`` render(+convolve) cycles on a renderer.

    ``samples``: optional mono signal; when given, each round also times the
    file convolution. The reference reports "convolute" (device compute,
    timed around the CUDA kernels, kernels.cu:404-435) separately from
    "convolute process" (the whole host call including PCIe staging and
    normalization, main.cpp:566-621 / AudioRenderer.cpp:663-718). The same
    split here: ``convolute`` times one jitted convolve+checksum dispatch
    on pre-staged device arrays, while ``convolute_process`` times the
    full ``convolve_audio_file`` python call — host→device upload,
    compute, device→host ``np.asarray``.
    """
    render = StageStats()
    convolute = StageStats()
    convolute_process = StageStats()
    peaks = []

    samples_dev = None
    if samples is not None:
        samples_dev = jax.device_put(np.asarray(samples, np.float32))

    for i in range(-warmup, rounds):
        t0 = time.perf_counter()
        ir = jax.block_until_ready(renderer.render())
        t_render = time.perf_counter() - t0

        t_conv = t_proc = 0.0
        if samples is not None:
            # Full host-side process (the reference's "convolute process"):
            # includes staging both ways and any dump-to-file work.
            t0 = time.perf_counter()
            out = renderer.convolve_audio_file(samples)
            t_proc = time.perf_counter() - t0
            del out
            # Device compute only (the reference's "convolute"): inputs are
            # already device-resident; ONE dispatch computes convolve +
            # checksum inside the jitted program and fetches a single float.
            t0 = time.perf_counter()
            s_check = renderer.convolve_audio_file_device_checksum(
                samples_dev)
            t_conv = time.perf_counter() - t0
            assert np.isfinite(s_check)
        if i >= 0:
            render.add(t_render)
            if samples is not None:
                convolute.add(t_conv)
                convolute_process.add(t_proc)
            peaks.append(float(np.max(np.abs(ir))))

    return ExperimentResults(rounds=rounds, render=render, convolute=convolute,
                             convolute_process=convolute_process,
                             ir_peaks=np.asarray(peaks))
