"""Ring buffer + re-render policy semantics (CircularBuffer.h, main.cpp:470-498)."""
import numpy as np
import pytest

from audiorenderingv2 import streaming
from audiorenderingv2.streaming import ReRenderPolicy, RingBuffer, ListenerTrajectory, TrajectoryPoint


def test_ring_add_does_not_advance():
    rb = RingBuffer(8)
    rb.add(np.ones(4))
    rb.add(np.ones(4) * 2)  # stacks on the same region
    out = rb.get_and_reset(4)
    np.testing.assert_allclose(out, 3.0)
    # region was zeroed and head advanced
    np.testing.assert_allclose(rb.get_and_reset(4), 0.0)


def test_ring_overlap_accumulation():
    """The live convolution tail pattern: add ir-length output, drain a
    block, next add overlaps the remaining tail."""
    rb = RingBuffer(12)
    rb.add(np.arange(8, dtype=float))        # [0..7]
    out1 = rb.get_and_reset(4)               # drains 0..3, head=4
    np.testing.assert_allclose(out1, [0, 1, 2, 3])
    rb.add(np.ones(8))                       # stacks on 4..11
    out2 = rb.get_and_reset(4)               # (4..7 leftovers) + 1
    np.testing.assert_allclose(out2, [5, 6, 7, 8])


def test_ring_wraparound():
    rb = RingBuffer(6)
    rb.get_and_reset(4)  # advance head to 4
    rb.add(np.array([1.0, 2.0, 3.0, 4.0]))  # wraps: idx 4,5,0,1
    out = rb.get_and_reset(4)
    np.testing.assert_allclose(out, [1, 2, 3, 4])


def test_policy_triggers():
    p = ReRenderPolicy(distance_threshold=2.0, angle_threshold=5.0, settle_seconds=1.0)
    assert p.should_render(0.0, np.zeros(3), 0.0)  # first call always renders
    assert not p.should_render(0.1, np.array([1.0, 0, 0]), 1.0)  # small move
    assert p.should_render(0.2, np.array([3.0, 0, 0]), 1.0)      # > 2 m
    assert not p.should_render(0.3, np.array([3.1, 0, 0]), 1.0)
    assert p.should_render(0.4, np.array([3.1, 0, 0]), 8.0)      # > 5 deg turn
    # settle timer: small motion then 1 s of stillness
    assert not p.should_render(0.5, np.array([3.2, 0, 0]), 8.0)
    assert p.should_render(1.6, np.array([3.2, 0, 0]), 8.0)


def test_trajectory_interpolation():
    traj = ListenerTrajectory([
        TrajectoryPoint(0.0, np.array([0.0, 0, 0]), 0.0),
        TrajectoryPoint(2.0, np.array([4.0, 0, 0]), 90.0),
    ])
    pos, yaw = traj.at(1.0)
    np.testing.assert_allclose(pos, [2.0, 0, 0])
    assert yaw == 45.0
    pos, yaw = traj.at(5.0)
    np.testing.assert_allclose(pos, [4.0, 0, 0])


def test_settle_fires_after_motion_stops_not_after_it_starts():
    """Slow continuous drift must NOT trigger the settle re-render until the
    listener actually stops (main.cpp:470-498 semantics)."""
    p = ReRenderPolicy(distance_threshold=5.0, angle_threshold=90.0,
                       settle_seconds=1.0)
    assert p.should_render(0.0, np.zeros(3), 0.0)
    # drift 0.1 m every 0.2 s for 3 s: always moving, always sub-threshold
    t, x = 0.0, 0.0
    for i in range(15):
        t += 0.2
        x += 0.1
        assert not p.should_render(t, np.array([x, 0, 0]), 0.0), f"fired at t={t}"
    # stop moving: settle fires ~1 s later, not before
    assert not p.should_render(t + 0.5, np.array([x, 0, 0]), 0.0)
    assert p.should_render(t + 1.1, np.array([x, 0, 0]), 0.0)


def test_settle_does_not_fire_at_rendered_pose():
    p = ReRenderPolicy(settle_seconds=1.0)
    assert p.should_render(0.0, np.zeros(3), 0.0)
    # jiggle then return exactly to the rendered pose: nothing to re-render
    assert not p.should_render(0.2, np.array([0.1, 0, 0]), 0.0)
    assert not p.should_render(0.4, np.zeros(3), 0.0)
    assert not p.should_render(2.0, np.zeros(3), 0.0)


def test_async_render_worker():
    """The detached-worker runtime: requests coalesce, latest output swaps in
    (main.cpp:40-67 semantics)."""
    import audiorenderingv2 as ar
    from audiorenderingv2 import testing
    from audiorenderingv2.renderer import AudioRenderer
    from audiorenderingv2.streaming import AsyncRenderWorker

    v, t = testing.box_room((10.0, 8.0, 9.0))
    scene = testing.scene_from_arrays(v, t, 0.3)
    r = AudioRenderer(scene, ir_seconds=1, sample_rate=8000, n_rays=256,
                      base_power=3.62, max_bounces=4,
                      opts=ar.TracerOptions(block_size=256, tri_chunk=128))
    samples = np.random.default_rng(0).normal(size=8000).astype(np.float32)
    w = AsyncRenderWorker(r, samples)
    try:
        assert w.latest is None
        w.request([2.0, 0.0, 1.0], 0.0)
        w.wait_idle()
        first = w.latest
        assert first is not None and first.shape == (2, 8000)
        w.request([1.0, 1.0, -1.0], 45.0)
        w.wait_idle()
        assert w.renders == 2
        assert not np.array_equal(w.latest, first)
    finally:
        w.close()


def test_live_duplex_rerender_under_stream(tmp_path):
    """End-to-end live-duplex runtime: AsyncRenderWorker re-renders on a
    moving pose WHILE LiveConvolver + the native engine stream blocks —
    renderer lock + ring concurrency together (main.cpp:99-135, 470-498).

    Asserts: zero NaNs in the streamed output, bounded underruns, and the
    is_rendering silence guard (main.cpp:111, 128-132): blocks processed
    while a render is in flight are pure silence."""
    import audiorenderingv2 as ar
    from audiorenderingv2 import native, testing
    from audiorenderingv2.renderer import AudioRenderer
    from audiorenderingv2.streaming import AsyncRenderWorker, LiveConvolver

    v, t = testing.box_room((10.0, 8.0, 9.0))
    scene = testing.scene_from_arrays(v, t, 0.3)
    r = AudioRenderer(scene, ir_seconds=1, sample_rate=8000, n_rays=512,
                      base_power=3.62, max_bounces=6,
                      opts=ar.TracerOptions(block_size=512, tri_chunk=128))
    r.set_receiver(np.array([2.0, 0.0, 1.0], np.float32), 0.0)
    r.render()  # initial IR so the stream has something to convolve

    worker = AsyncRenderWorker(r, samples=None)
    conv = LiveConvolver(r, volume=1.0, render_guard=worker)
    engine = None
    if native.available():
        engine = native.NativeAudioEngine(
            str(tmp_path / "sink.f64"), ring_capacity=1 << 20,
            sample_rate=8000, channels=2, frames_per_buffer=256,
            realtime=False)

    block = 1024
    rng = np.random.default_rng(3)
    mic = rng.normal(size=block * 24).astype(np.float32) * 0.1
    poses = [([2.0, 0.0, 1.0], 0.0), ([-2.0, 0.5, -1.0], 45.0),
             ([0.0, 1.0, 2.0], 120.0)]
    silent, outputs = 0, []
    try:
        for i in range(24):
            if i % 8 == 1:  # listener moved: kick a background re-render
                worker.request(*poses[(i // 8) % len(poses)])
            out = conv.process_block(mic[i * block:(i + 1) * block])
            assert out.shape == (2 * block,)
            assert np.isfinite(out).all()
            if conv.silenced_blocks > silent:
                silent = conv.silenced_blocks
                assert not out.any()  # guard means SILENCE, not stale audio
            outputs.append(out)
            if engine is not None:
                engine.add(out)
                engine.drain_ticks(block // 256)
        worker.wait_idle()
        assert worker.renders >= 1  # re-renders really happened mid-stream
        inter = np.concatenate(outputs)
        assert np.isfinite(inter).all()
        assert (inter != 0).any()  # the stream carried audio, too
        if engine is not None:
            # The pump keeps up: every all-zero tick is explained by a
            # guard-silenced block (intentional silence while rendering,
            # which the engine cannot distinguish from starvation).
            assert engine.underruns <= conv.silenced_blocks * (block // 256)
            assert engine.frames_streamed > 0
    finally:
        worker.close()
        if engine is not None:
            engine.close()


def test_auralizer_async_mode():
    import audiorenderingv2 as ar
    from audiorenderingv2 import testing
    from audiorenderingv2.renderer import AudioRenderer
    from audiorenderingv2.streaming import Auralizer

    v, t = testing.box_room((10.0, 8.0, 9.0))
    scene = testing.scene_from_arrays(v, t, 0.3)
    r = AudioRenderer(scene, ir_seconds=1, sample_rate=8000, n_rays=256,
                      base_power=3.62, max_bounces=4,
                      opts=ar.TracerOptions(block_size=256, tri_chunk=128))
    traj = ListenerTrajectory([
        TrajectoryPoint(0.0, np.array([2.0, 0.0, 1.0], np.float32), 0.0),
        TrajectoryPoint(1.0, np.array([-2.0, 0.0, -1.0], np.float32), 90.0),
    ])
    samples = np.random.default_rng(1).normal(size=8000).astype(np.float32) * 0.1
    aur = Auralizer(r, traj, ReRenderPolicy(2.0, 5.0, 1.0),
                    chunk_seconds=0.25, async_render=True)
    out = aur.run(samples)
    assert out.shape == (2, 8000)
    assert np.isfinite(out).all()
    assert (out != 0).any()
    assert aur.renders >= 2  # initial + at least one movement re-render


def test_policy_settle_fires_after_first_interval_move():
    """Motion in the FIRST inter-query interval must arm the settle timer
    (r5 review fix: the first query now seeds query-to-query tracking)."""
    p = streaming.ReRenderPolicy(distance_threshold=2.0,
                                 angle_threshold=5.0, settle_seconds=1.0)
    assert p.should_render(0.0, np.zeros(3), 0.0)  # initial render
    # a 1 m (sub-threshold) move right after, then stillness
    assert not p.should_render(0.5, np.array([1.0, 0.0, 0.0]), 0.0)
    assert not p.should_render(1.0, np.array([1.0, 0.0, 0.0]), 0.0)
    # settle timer (1 s after motion stopped being observed) fires
    assert p.should_render(1.6, np.array([1.0, 0.0, 0.0]), 0.0)


def test_async_worker_surfaces_render_failure():
    """A render-thread exception reaches the caller through wait_idle
    instead of being swallowed (r5 review fix)."""
    class Boom:
        lock = __import__("threading").RLock()

        def full_render_cycle(self, pos, yaw, samples):
            raise RuntimeError("kaboom")

    w = streaming.AsyncRenderWorker(Boom(), samples=np.zeros(8, np.float32))
    w.request(np.zeros(3), 0.0)
    with pytest.raises(RuntimeError, match="render worker failed"):
        w.wait_idle(timeout=10.0)
    w.close()
