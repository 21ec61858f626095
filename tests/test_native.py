"""Native C++ runtime: ring buffer semantics parity + streaming engine."""
import numpy as np
import pytest

from audiorenderingv2 import native
from audiorenderingv2.streaming import RingBuffer

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native toolchain unavailable")


def test_native_ring_matches_python():
    rng = np.random.default_rng(0)
    py = RingBuffer(37)
    nat = native.NativeRingBuffer(37)
    for _ in range(50):
        n = int(rng.integers(1, 37))
        vals = rng.normal(size=n)
        py.add(vals)
        nat.add(vals)
        m = int(rng.integers(1, 37))
        np.testing.assert_allclose(nat.get_and_reset(m), py.get_and_reset(m))


def test_engine_offline_stream(tmp_path):
    sink = tmp_path / "out.f64"
    eng = native.NativeAudioEngine(str(sink), ring_capacity=1024,
                                   sample_rate=16000, channels=2,
                                   frames_per_buffer=64, realtime=False)
    block = np.arange(256, dtype=np.float64)
    eng.add(block)
    eng.drain_ticks(2)  # 2 * 64 frames * 2 ch = 256 samples
    assert eng.frames_streamed == 128
    eng.close()
    data = np.fromfile(sink, dtype="<f8")
    np.testing.assert_allclose(data, block)


def test_engine_realtime_thread(tmp_path):
    import time

    sink = tmp_path / "live.f64"
    eng = native.NativeAudioEngine(str(sink), ring_capacity=65536,
                                   sample_rate=16000, channels=2,
                                   frames_per_buffer=256, realtime=True)
    eng.add(np.ones(32768))
    eng.start()
    time.sleep(0.25)
    eng.stop()
    # ~0.25s at 16 kHz ≈ 4000 frames; generous bounds for CI jitter
    assert 1000 < eng.frames_streamed < 16000
    streamed = eng.frames_streamed
    eng.close()
    data = np.fromfile(sink, dtype="<f8")
    assert len(data) == streamed * 2
    assert (data[: min(len(data), 32768)] == 1.0).all()
