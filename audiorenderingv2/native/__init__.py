"""ctypes bindings for the native C++ runtime (native/ at the repo root).

The reference's runtime around the GPU compute is native C++ (RtAudio device
I/O, CircularBuffer, thread orchestration — main.cpp:40-161). This package
binds this package's C++ equivalents:

  * NativeRingBuffer — accumulate/drain ring buffer (CircularBuffer.h
    semantics), C++ implementation of streaming.RingBuffer.
  * NativeAudioEngine — the RtAudio-equivalent streaming pump: a dedicated
    C++ thread drains interleaved blocks from the ring at the sample-rate
    cadence (or free-running offline) into a float64 sink file.

The shared library is built on demand with `make -C native` (g++); all
functionality has pure-Python fallbacks, so the native layer is an
accelerant, not a hard dependency.
"""
from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

import numpy as np

_REPO_ROOT = Path(__file__).resolve().parents[2]
_NATIVE_DIR = _REPO_ROOT / "native"
_LIB_PATH = _NATIVE_DIR / "libar2native.so"

_lib = None


def _load(build: bool = True):
    global _lib
    if _lib is not None:
        return _lib
    if not _LIB_PATH.exists() and build:
        try:
            subprocess.run(["make", "-C", str(_NATIVE_DIR)], check=True,
                           capture_output=True, timeout=120)
        except (subprocess.SubprocessError, FileNotFoundError):
            return None
    if not _LIB_PATH.exists():
        return None
    lib = ctypes.CDLL(str(_LIB_PATH))
    dptr = ctypes.POINTER(ctypes.c_double)
    lib.ar2_ring_create.restype = ctypes.c_void_p
    lib.ar2_ring_create.argtypes = [ctypes.c_size_t]
    lib.ar2_ring_destroy.argtypes = [ctypes.c_void_p]
    lib.ar2_ring_add.argtypes = [ctypes.c_void_p, dptr, ctypes.c_size_t]
    lib.ar2_ring_get_and_reset.argtypes = [ctypes.c_void_p, dptr, ctypes.c_size_t]
    lib.ar2_engine_create.restype = ctypes.c_void_p
    lib.ar2_engine_create.argtypes = [
        ctypes.c_size_t, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,
        ctypes.c_char_p, ctypes.c_int]
    lib.ar2_engine_destroy.argtypes = [ctypes.c_void_p]
    lib.ar2_engine_add.argtypes = [ctypes.c_void_p, dptr, ctypes.c_size_t]
    lib.ar2_engine_start.argtypes = [ctypes.c_void_p]
    lib.ar2_engine_stop.argtypes = [ctypes.c_void_p]
    lib.ar2_engine_drain_ticks.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    lib.ar2_engine_frames_streamed.restype = ctypes.c_uint64
    lib.ar2_engine_frames_streamed.argtypes = [ctypes.c_void_p]
    lib.ar2_engine_underruns.restype = ctypes.c_uint64
    lib.ar2_engine_underruns.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def available() -> bool:
    """True if the native library is present or buildable."""
    return _load() is not None


def _as_dptr(x: np.ndarray):
    return x.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


class NativeRingBuffer:
    """C++ accumulate/drain ring buffer; drop-in for streaming.RingBuffer."""

    def __init__(self, capacity: int):
        lib = _load()
        if lib is None:
            raise RuntimeError("native library unavailable (g++/make missing?)")
        self._lib = lib
        self._h = lib.ar2_ring_create(capacity)
        self.capacity = int(capacity)

    def add(self, values: np.ndarray) -> None:
        values = np.ascontiguousarray(values, np.float64)
        if values.shape[0] > self.capacity:
            raise ValueError("more values than capacity")
        self._lib.ar2_ring_add(self._h, _as_dptr(values), values.shape[0])

    def get_and_reset(self, n: int) -> np.ndarray:
        if n > self.capacity:
            raise ValueError("more values than capacity")
        out = np.empty(n, np.float64)
        self._lib.ar2_ring_get_and_reset(self._h, _as_dptr(out), n)
        return out

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.ar2_ring_destroy(self._h)
            self._h = None


class NativeAudioEngine:
    """The RtAudio-equivalent streaming pump (see module docstring).

    ``realtime=True`` paces ticks at the wall-clock sample rate (the live
    auralization mode); ``realtime=False`` free-runs for offline drains.
    The sink is raw little-endian float64 interleaved frames.
    """

    def __init__(self, sink_path: str, *, ring_capacity: int,
                 sample_rate: int, channels: int = 2,
                 frames_per_buffer: int = 256, realtime: bool = False):
        lib = _load()
        if lib is None:
            raise RuntimeError("native library unavailable (g++/make missing?)")
        self._lib = lib
        self._h = lib.ar2_engine_create(
            ring_capacity, sample_rate, channels, frames_per_buffer,
            str(sink_path).encode(), 1 if realtime else 0)
        if not self._h:
            raise RuntimeError(f"cannot open sink {sink_path}")
        self.channels = channels
        self.frames_per_buffer = frames_per_buffer
        self.ring_capacity = int(ring_capacity)

    def add(self, values: np.ndarray) -> None:
        values = np.ascontiguousarray(values, np.float64)
        if values.shape[0] > self.ring_capacity:
            # The C++ Add wraps silently past a full ring, stacking later
            # samples onto earlier slots; mirror NativeRingBuffer's guard.
            raise ValueError(f"{values.shape[0]} values exceed the ring "
                             f"capacity {self.ring_capacity}")
        self._lib.ar2_engine_add(self._h, _as_dptr(values), values.shape[0])

    def start(self) -> None:
        self._lib.ar2_engine_start(self._h)

    def stop(self) -> None:
        self._lib.ar2_engine_stop(self._h)

    def drain_ticks(self, ticks: int) -> None:
        """Synchronously stream ``ticks`` buffers (offline mode). No-op
        while start()ed — the pacing thread owns the sink then; stop()
        first."""
        self._lib.ar2_engine_drain_ticks(self._h, ticks)

    @property
    def frames_streamed(self) -> int:
        return int(self._lib.ar2_engine_frames_streamed(self._h))

    @property
    def underruns(self) -> int:
        return int(self._lib.ar2_engine_underruns(self._h))

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.ar2_engine_destroy(self._h)
            self._h = None

    def __del__(self):
        self.close()
