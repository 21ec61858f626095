"""BASELINE config #3: full-room scene, 1M rays, 8 bounces, real-time
moving-listener auralization (scripted trajectory + re-render policy).

Usage: python examples/demo_3_realtime.py [walkthrough.wav]
"""
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax

import audiorenderingv2 as ar
from audiorenderingv2 import testing
from audiorenderingv2.io import wav as wav_io
from audiorenderingv2.renderer import AudioRenderer
from audiorenderingv2.streaming import (Auralizer, ListenerTrajectory,
                                            ReRenderPolicy, TrajectoryPoint)

REF_SCENE = "/root/reference/assets/models/3D_U.obj"
REF_WAV = "/root/reference/assets/sound_samples/guitar_sample_16k.wav"


def main(out_path="demo_walkthrough.wav"):
    mats = [ar.MaterialSpec(n, a) for n, a in
            [("Amarillo", 0.1), ("Luz", 0.3), ("Rojo", 0.2)]]
    if Path(REF_SCENE).exists():
        scene = ar.load_scene(REF_SCENE, mats)
    else:
        v, t = testing.box_room((20.0, 10.0, 14.0))
        scene = testing.scene_from_arrays(v, t, 0.25)

    n_rays = 50_000 if jax.default_backend() == "cpu" else 1_000_000
    renderer = AudioRenderer(scene, ir_seconds=2, sample_rate=16000,
                             n_rays=n_rays, base_power=3.62, max_bounces=8)

    if Path(REF_WAV).exists():
        audio = wav_io.read_wav(REF_WAV)
        samples = audio.mono()[: 16000 * 10]
    else:
        rng = np.random.default_rng(0)
        samples = (rng.normal(size=16000 * 10) * 0.1).astype(np.float32)

    # Walk across the room over 10 s while turning.
    traj = ListenerTrajectory([
        TrajectoryPoint(0.0, np.array([2.5, 9.9, 0.0], np.float32), 0.0),
        TrajectoryPoint(5.0, np.array([0.0, 5.0, 2.0], np.float32), 90.0),
        TrajectoryPoint(10.0, np.array([-3.0, 2.0, -2.0], np.float32), 200.0),
    ])
    aur = Auralizer(renderer, traj,
                    ReRenderPolicy(distance_threshold=2.0, angle_threshold=5.0))
    # Warm up the jit caches (compile is a one-time startup cost, like the
    # reference's OptiX pipeline build) so the timing measures steady state.
    t0 = time.time()
    renderer.full_render_cycle(np.asarray(traj.points[0].position), 0.0, samples)
    print(f"startup (compile + first render): {time.time() - t0:.1f}s")
    t0 = time.time()
    out = aur.run(samples)
    wall = time.time() - t0
    audio_s = len(samples) / 16000
    print(f"auralized {audio_s:.1f}s with {aur.renders} IR renders "
          f"({n_rays} rays each) in {wall:.1f}s wall "
          f"-> {'REAL-TIME' if wall < audio_s else f'{wall/audio_s:.1f}x slower than RT'}")
    peak = np.abs(out).max()
    wav_io.write_wav(out_path, out / peak if peak > 0 else out, 16000)
    print(f"wrote {out_path}")


if __name__ == "__main__":
    main(*sys.argv[1:])
