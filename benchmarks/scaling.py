"""1 -> N device scaling curve for the sharded renderer.

Runs the shard_map ray-parallel render on meshes of 1, 2, 4, ... devices
and reports throughput + parallel efficiency. On GPUs this measures
scaling over NVLink/NCCL; on a single-host CPU run (AR2_FORCE_CPU_MESH=8) it
validates the code path and the collective structure, with efficiency
numbers that reflect host-core contention rather than the interconnect.

Usage:
  python benchmarks/scaling.py                  # real devices
  AR2_FORCE_CPU_MESH=8 python benchmarks/scaling.py
"""
import json
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

if os.environ.get("AR2_FORCE_CPU_MESH"):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                               " --xla_force_host_platform_device_count=" +
                               os.environ["AR2_FORCE_CPU_MESH"]).strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
else:
    import jax

import numpy as np

import audiorenderingv2 as ar
from audiorenderingv2 import testing
from audiorenderingv2.parallel import make_ray_mesh, render_ir_sharded


def main():
    devices = jax.devices()
    on_cpu = devices[0].platform == "cpu"
    v, t = testing.box_room((14.0, 9.0, 11.0))
    scene = testing.scene_from_arrays(v, t, 0.3)
    sc = ar.scene_to_arrays(scene, 128)
    params = ar.TraceParams(sample_rate=16000, ir_length=32000,
                            base_power=3.62,
                            max_bounces=8 if on_cpu else 50)
    opts = ar.TracerOptions(block_size=4096, tri_chunk=128)
    rays_per_device = 8192 if on_cpu else 1_000_000

    results = []
    n = 1
    while n <= len(devices):
        mesh = make_ray_mesh(devices[:n])
        n_rays = rays_per_device * n  # weak scaling: constant work per device

        @jax.jit  # one compiled program: eager shard_map dispatches op by op
        def render(key):
            return render_ir_sharded(sc, key, n_rays, np.zeros(3, np.float32),
                                     np.array([4.0, 2.0, -3.0], np.float32),
                                     0.0, params, opts, mesh=mesh)

        key = jax.random.PRNGKey(0)
        jax.block_until_ready(render(key))  # compile
        times = []
        for i in range(3):
            t0 = time.time()
            jax.block_until_ready(render(jax.random.fold_in(key, i)))
            times.append(time.time() - t0)
        dt = min(times)
        rate = n_rays / dt
        results.append({"devices": n, "n_rays": n_rays, "seconds": dt,
                        "rays_per_s": rate})
        print(f"{n} device(s): {n_rays:.1e} rays in {dt*1000:.0f} ms "
              f"-> {rate:.3e} rays/s", flush=True)
        n *= 2

    base = results[0]["rays_per_s"]
    for r in results:
        r["efficiency"] = r["rays_per_s"] / (base * r["devices"])
        print(f"{r['devices']} device(s): weak-scaling efficiency "
              f"{r['efficiency']*100:.1f}%")
    out = Path(__file__).parent / f"scaling_results_{devices[0].platform}.json"
    payload = {
        "platform": devices[0].platform,
        "device_kind": devices[0].device_kind,
        "results": results,
    }
    if devices[0].platform == "cpu":
        payload["caveat"] = (
            "Virtual CPU devices share one host's physical cores: the "
            "efficiency column measures core CONTENTION, not the sharding "
            "design. It validates that the sharded program compiles, runs, "
            "and stays numerically correct at N devices — real scaling "
            "curves require N real devices.")
    out.write_text(json.dumps(payload, indent=2))
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
