"""Large-scene render throughput through the AudioRenderer facade.

The reference's OptiX hardware BVH makes scene size nearly free
(AudioRenderer.cpp:95-218); the XLA tracer tests every triangle, so this
scene is where intersection cost dominates. Workload: 1M rays x 32 bounces
in a procedural "office" scene (box room + grid of icosphere obstacles) at
a configurable triangle count.

Usage: python benchmarks/large_scene.py [n_tris_target] [n_rays] [bounces]
"""
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax

from audiorenderingv2 import testing
from audiorenderingv2.renderer import AudioRenderer


def office_scene(n_tris_target: int):
    """Box room + a grid of icosphere obstacles totalling ~n_tris_target."""
    room = (40.0, 12.0, 40.0)
    bv, bt = testing.box_room(room)
    verts = [bv]
    tris = [bt]
    n = len(bt)
    base = len(bv)
    rng = np.random.default_rng(7)
    # each subdiv-2 icosphere is 320 tris
    k = max(1, (n_tris_target - n) // 320)
    side = int(np.ceil(np.sqrt(k)))
    i = 0
    for gx in range(side):
        for gz in range(side):
            if i >= k:
                break
            cx = -room[0] / 2 + (gx + 0.5) * room[0] / side
            cz = -room[2] / 2 + (gz + 0.5) * room[2] / side
            cy = rng.uniform(-room[1] / 2 + 1.5, room[1] / 2 - 1.5)
            sv, st = testing.icosphere(radius=0.9, center=(cx, cy, cz),
                                       subdivisions=2)
            verts.append(sv)
            tris.append(st + base)
            base += len(sv)
            n += len(st)
            i += 1
    v = np.vstack(verts)
    t = np.vstack(tris)
    absorb = np.full(len(t), 0.3, np.float32)
    return testing.scene_from_arrays(v, t, absorb)


def main():
    target = int(sys.argv[1]) if len(sys.argv) > 1 else 20000
    n_rays = int(sys.argv[2]) if len(sys.argv) > 2 else 1_000_000
    bounces = int(sys.argv[3]) if len(sys.argv) > 3 else 32

    dev = jax.devices()[0]
    scene = office_scene(target)
    print(f"device: {dev}; scene: {scene.n_triangles} tris, "
          f"{n_rays} rays, {bounces} bounces", flush=True)
    r = AudioRenderer(scene, ir_seconds=2, sample_rate=16000, n_rays=n_rays,
                      base_power=3.62, max_bounces=bounces,
                      hrtf_absorption_rate=0.9)
    r.set_receiver(np.array([6.0, 1.0, -8.0], np.float32), 0.0)
    t0 = time.time()
    ir = jax.block_until_ready(r.render())
    print(f"compile+first: {time.time()-t0:.1f}s  ir sum="
          f"{float(np.asarray(ir).sum()):.4e} "
          f"nz={(np.asarray(ir) != 0).sum()}", flush=True)
    times = []
    for i in range(3):
        t0 = time.time()
        jax.block_until_ready(r.render())
        times.append(time.time() - t0)
    dt = float(np.median(times))
    print(json.dumps({"metric": "large_scene_rays_per_s",
                      "tris": int(scene.n_triangles),
                      "n_rays": n_rays, "bounces": bounces,
                      "seconds": dt, "value": n_rays / dt,
                      "renders_per_s": 1.0 / dt}))


if __name__ == "__main__":
    main()
