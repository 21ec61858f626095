"""AudioRenderer — the user-facing render/convolve facade.

The counterpart of the reference's AudioRenderer host pipeline
(AudioRenderer.h:24-54, AudioRenderer.cpp). Where the reference manages an
OptiX context, module, SBT, and GAS — rebuilding accel + SBT on every
emitter/receiver move (AudioRenderer.cpp:466-486) — this renderer owns only:

  * device scene arrays (built once per scene; the receiver is an analytic
    parameter, so pose changes never touch geometry),
  * a jit-compiled trace+histogram function keyed on the static trace
    parameters (recompiled only when e.g. max_bounces changes),
  * the jit-compiled convolution ops.

Public surface mirrors the reference renderer: render(), convolve_audio_file
(convoluteAudioFile), convolve_live_input (convoluteLiveInput), setter pairs
(setEmitterPosInOptix / setSphereCenterInOptix / setThresholds / setBasePower /
set_hrtf_absorption_rate / setMonoOutput), and full_render_cycle().
"""
from __future__ import annotations

import dataclasses
import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np

from . import constants
from .core.tracer import TracerOptions, render_ir, scene_to_arrays
from .core.tracer_ref import TraceParams
from .ops import convolve
from .scene import Scene


@functools.partial(jax.jit, static_argnames=("sample_rate",))
def _stereo_conv_sum(samples_dev, ir_stereo, sample_rate):
    """convolve + reduce in ONE compiled program (one scalar back)."""
    return jnp.sum(convolve.convolve_file_stereo(samples_dev, ir_stereo,
                                                 sample_rate))


@functools.partial(jax.jit, static_argnames=("sample_rate", "band_edges",
                                             "banded_fn"))
def _banded_conv_sum(samples_dev, ir_banded, sample_rate, band_edges,
                     banded_fn):
    return jnp.sum(banded_fn(samples_dev, ir_banded, sample_rate,
                             band_edges))


class AudioRenderer:
    """Renders binaural impulse responses and convolves audio with them.

    Args:
      scene: host-side Scene (absorptions already resolved).
      ir_seconds: IR length in seconds (renderer_parameters.ir_length_in_seconds).
      sample_rate: audio sample rate; IR bin rate equals it.
      n_rays: rays per render (the reference's rays.x*y*z launch grid).
      base_power, energy_threshold, max_bounces, hrtf_absorption_rate,
      is_mono: pathtracer parameters (config.json:27-37).
      opts: tracer performance options.
      seed: RNG seed; each render() folds a draw counter into the key, so
        repeated renders are independent but the sequence is reproducible.
    """

    def __init__(
        self,
        scene: Scene,
        ir_seconds: int,
        sample_rate: int,
        n_rays: int,
        *,
        base_power: float = 100.0,
        energy_threshold: float = 0.0,
        max_bounces: int = 10,
        hrtf_absorption_rate: float = constants.DEFAULT_HRTF_ABSORPTION,
        is_mono: bool = False,
        opts: TracerOptions | None = None,
        seed: int = 0,
        band_edges: tuple = (250.0, 1000.0, 4000.0),
    ):
        self.n_rays = int(n_rays)
        self.opts = opts if opts is not None else TracerOptions()
        self.scene = scene
        self.sc = scene_to_arrays(scene, self.opts.tri_chunk)
        # Banded absorption ([T, n_bands]) switches the whole pipeline to
        # per-band IRs + filterbank auralization.
        n_bands = (scene.absorption.shape[1]
                   if scene.absorption.ndim == 2 else 1)
        self.band_edges = tuple(band_edges)
        self.params = TraceParams(
            sample_rate=int(sample_rate),
            ir_length=int(ir_seconds) * int(sample_rate),
            base_power=float(base_power),
            energy_threshold=float(energy_threshold),
            max_bounces=int(max_bounces),
            hrtf_absorption_rate=float(hrtf_absorption_rate),
            is_mono=bool(is_mono),
            n_bands=n_bands,
        )
        self.emitter_pos = np.zeros(3, np.float32)
        self.receiver_pos = np.zeros(3, np.float32)
        self.receiver_yaw_deg = 0.0
        self._pose_dev = None  # staged device pose (see _pose_args)
        self._key = jax.random.PRNGKey(seed)
        self._draws = 0
        self._ir: np.ndarray | None = None
        self._ir_dev = None  # last IR as a device array (avoids re-staging
        #                      the host copy on every convolve dispatch)
        self._fns: dict = {}
        # Debug dumps mirroring the reference's one-shot flags
        # (AudioRenderer.cpp:525-567, 720-744; config write_first_* keys).
        self.write_ir_to_file_flag = False
        self.write_output_to_file_flag = False
        self.dump_dir = "."
        # Serializes full_render_cycle against concurrent audio pulls, the
        # role of the reference's output_buffer_mutex (AudioRenderer.cpp:790).
        self.lock = threading.RLock()

    # ------------------------------------------------------------- setters
    def set_emitter_pos(self, pos) -> None:
        """Reference setEmitterPosInOptix (AudioRenderer.cpp:752-756) — here
        just a parameter store; no accel rebuild exists to trigger."""
        self.emitter_pos = np.asarray(pos, np.float32)
        self._pose_dev = None

    def set_receiver(self, pos, yaw_deg: float) -> None:
        """Reference placeReceiver + setSphereCenterInOptix
        (OptixModel.cpp:153-157, AudioRenderer.cpp:758-762)."""
        self.receiver_pos = np.asarray(pos, np.float32)
        self.receiver_yaw_deg = float(yaw_deg)
        self._pose_dev = None

    def set_thresholds(self, energy_threshold: float, max_bounces: int) -> None:
        self.params = dataclasses.replace(
            self.params, energy_threshold=float(energy_threshold),
            max_bounces=int(max_bounces))

    def set_base_power(self, base_power: float) -> None:
        self.params = dataclasses.replace(self.params, base_power=float(base_power))

    def set_hrtf_absorption_rate(self, rate: float) -> None:
        self.params = dataclasses.replace(self.params, hrtf_absorption_rate=float(rate))

    def set_mono_output(self, is_mono: bool) -> None:
        self.params = dataclasses.replace(self.params, is_mono=bool(is_mono))

    # ------------------------------------------------------------- render
    def _render_fn(self, fold_inside: bool):
        """Jit-compiled trace for the current static params/opts.

        ``fold_inside=True`` is the product path: the per-draw
        ``fold_in(base_key, draws)`` runs INSIDE the compiled program, so
        one render is ONE dispatch instead of dispatch + eager fold_in.
        ``False`` keeps the explicit-key signature for callers that supply
        their own key (its stream is pinned by tests).
        """
        cache_key = (self.params, self.opts, self.n_rays, fold_inside)
        fn = self._fns.get(cache_key)
        if fn is None:
            params, opts, n_rays = self.params, self.opts, self.n_rays
            # The scene is CLOSED OVER, not passed: jit bakes the arrays
            # into the executable as constants (the scene never changes for
            # a renderer instance; a new scene means a new AudioRenderer).
            sc = self.sc

            def body(key, emitter, rec_pos, yaw_deg):
                ir = render_ir(sc, key, n_rays, emitter, rec_pos, yaw_deg,
                               params, opts)
                if params.is_mono:
                    # addIRs fold: both ears carry the sum (kernels.cu:519-536).
                    ir = jnp.broadcast_to(jnp.sum(ir, axis=0, keepdims=True), ir.shape)
                return ir

            if fold_inside:
                @jax.jit
                def fn(base_key, draws, emitter, rec_pos, yaw_deg):
                    return body(jax.random.fold_in(base_key, draws),
                                emitter, rec_pos, yaw_deg)
            else:
                fn = jax.jit(body)
            if len(self._fns) >= 8:
                # Each cached executable carries its own baked scene
                # constants; bound the cache (FIFO) so a parameter sweep
                # over set_thresholds/set_base_power cannot accumulate
                # scene copies without limit.
                self._fns.pop(next(iter(self._fns)))
            self._fns[cache_key] = fn
        return fn

    def _pose_args(self):
        """Device-resident (emitter, receiver, yaw) — re-staged only when a
        setter moved them, not on every render."""
        if self._pose_dev is None:
            self._pose_dev = (jnp.asarray(self.emitter_pos),
                              jnp.asarray(self.receiver_pos),
                              jnp.float32(self.receiver_yaw_deg))
        return self._pose_dev

    def render(self, key: jax.Array | None = None) -> np.ndarray:
        """Trace a fresh IR; returns float32 [2, ir_length] (left, right)."""
        if key is None:
            # Same stream as fold_in(self._key, draws) eagerly — the fold
            # just runs inside the compiled program (one dispatch total).
            ir = self._render_fn(True)(
                self._key, np.uint32(self._draws), *self._pose_args())
            self._draws += 1
        else:
            ir = self._render_fn(False)(key, *self._pose_args())
        self._ir_dev = ir  # device-resident copy for the convolve paths
        self._ir = np.asarray(ir)
        if self.write_ir_to_file_flag:
            self.dump_ir()
            self.write_ir_to_file_flag = False  # one-shot, like the reference
        return self._ir

    def _ir_device(self):
        """The current IR as a device array — the render's own output when
        available, so convolve dispatches do not re-upload the host copy."""
        if self._ir_dev is not None:
            return self._ir_dev
        return jnp.asarray(self._ir)

    @property
    def ir(self) -> np.ndarray | None:
        """Last rendered IR, [2, ir_length]."""
        return self._ir

    def dump_ir(self, prefix: str = "output_ir") -> tuple[str, str]:
        """Write the current IR as one-value-per-line text files, the
        reference's debug-dump format consumed by the plotting utils
        (AudioRenderer.cpp:525-567; utils/printIR.py)."""
        import os

        if self._ir is None:
            raise RuntimeError("render() an IR first")
        paths = []
        for name, channel in (("left", self._ir[0]), ("right", self._ir[1])):
            path = os.path.join(self.dump_dir, f"{prefix}_{name}.txt")
            np.savetxt(path, channel, fmt="%.9g")
            paths.append(path)
        return tuple(paths)

    # --------------------------------------------------------- convolution
    def convolve_audio_file(self, samples: np.ndarray) -> np.ndarray:
        """Convolve a full signal with the current IR.

        Mirrors convoluteAudioFile (AudioRenderer.cpp:663-745): overlap-add
        per 1 s segment, /(ir_length/2) normalization, output truncated to
        the input length. Returns float32 [2, L].
        """
        if self._ir is None:
            raise RuntimeError("render() an IR first")
        if self._ir.ndim == 3:  # banded IR -> filterbank auralization
            from .ops import filterbank

            out = np.asarray(filterbank.convolve_file_banded(
                jnp.asarray(samples, jnp.float32), self._ir_device(),
                self.params.sample_rate, self.band_edges))
        else:
            out = np.asarray(convolve.convolve_file_stereo(
                jnp.asarray(samples, jnp.float32), self._ir_device(),
                self.params.sample_rate))
        if self.write_output_to_file_flag:
            import os

            for name, channel in (("left", out[0]), ("right", out[1])):
                np.savetxt(os.path.join(self.dump_dir,
                                        f"output_convolute_{name}.txt"),
                           channel, fmt="%.9g")
            self.write_output_to_file_flag = False
        return out

    def convolve_audio_file_device(self, samples_dev) -> jnp.ndarray:
        """Device-only convolution: pre-staged device samples in, device
        array out (no ``np.asarray`` copy, no dump-file side effects).

        The measurement path for the reference's "convolute" timer, which
        wraps only the CUDA kernels (kernels.cu:404-435) — as opposed to
        ``convolve_audio_file``, whose end-to-end cost is the reference's
        "convolute process" (AudioRenderer.cpp:663-718). Used by
        experiment.run_experiment to report the two as distinct numbers.
        """
        if self._ir is None:
            raise RuntimeError("render() an IR first")
        if self._ir.ndim == 3:
            from .ops import filterbank

            return filterbank.convolve_file_banded(
                samples_dev, self._ir_device(),
                self.params.sample_rate, self.band_edges)
        return convolve.convolve_file_stereo(
            samples_dev, self._ir_device(), self.params.sample_rate)

    def convolve_audio_file_device_checksum(self, samples_dev) -> float:
        """Single-dispatch convolution returning a scalar checksum.

        The sum is computed INSIDE the jitted program, so one dispatch
        covers convolve + reduce and only a scalar comes back to the host.
        """
        if self._ir is None:
            raise RuntimeError("render() an IR first")
        if self._ir.ndim == 3:
            from .ops import filterbank

            return float(_banded_conv_sum(
                samples_dev, self._ir_device(),
                self.params.sample_rate, self.band_edges,
                filterbank.convolve_file_banded))
        return float(_stereo_conv_sum(samples_dev, self._ir_device(),
                                      self.params.sample_rate))

    def convolve_live_input(self, block: np.ndarray, ring_buffer) -> None:
        """Convolve one live input block and accumulate into ``ring_buffer``.

        Mirrors convoluteLiveInput (AudioRenderer.cpp:593-660): the block is
        zero-padded to ir_length, circularly convolved with both ears,
        normalized, interleaved LRLR and added to the ring buffer whose
        accumulate/drain semantics match CircularBuffer.h.
        """
        if self._ir is None:
            raise RuntimeError("render() an IR first")
        n = self.params.ir_length
        block = np.asarray(block, np.float32)
        if block.shape[0] > n:
            raise ValueError("live block longer than the IR")
        padded = np.zeros(n, np.float32)
        padded[: block.shape[0]] = block
        if self._ir.ndim == 3:
            from .ops import filterbank

            out = filterbank.convolve_live_banded(
                jnp.asarray(padded), self._ir_device(),
                self.params.sample_rate, self.band_edges)
        else:
            out = convolve.convolve_live(jnp.asarray(padded),
                                         self._ir_device())
        inter = np.asarray(convolve.interleave_stereo(out[0], out[1]))
        ring_buffer.add(inter)

    # ---------------------------------------------------------- full cycle
    def full_render_cycle(self, receiver_pos, receiver_yaw_deg: float,
                          samples: np.ndarray) -> np.ndarray:
        """Move the listener, re-render, convolve — the reference's
        full_render_cycle under its output-buffer mutex
        (AudioRenderer.cpp:790-798). Returns the stereo output [2, L].

        Emits one structured log record per cycle (utils.logging) — the
        replacement for the reference's "Time taken by Optix" prints
        (AudioRenderer.cpp:513-518), off until the logger is configured."""
        import time as _time

        from .utils.logging import get_logger

        with self.lock:
            t0 = _time.perf_counter()
            self.set_receiver(receiver_pos, receiver_yaw_deg)
            self.render()
            t_render = _time.perf_counter() - t0
            out = self.convolve_audio_file(samples)
            get_logger().event(
                "full_render_cycle",
                render_ms=round(t_render * 1e3, 3),
                convolve_ms=round((_time.perf_counter() - t0 - t_render)
                                  * 1e3, 3),
                receiver=list(np.asarray(receiver_pos, dtype=float)),
                yaw_deg=float(receiver_yaw_deg))
            return out
