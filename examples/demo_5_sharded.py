"""BASELINE config #5: multi-source multi-listener scene, rays sharded over
a device mesh (16M rays on GPUs; scaled down automatically on the CPU).

Usage:
  python examples/demo_5_sharded.py              # real devices
  AR2_FORCE_CPU_MESH=8 python examples/demo_5_sharded.py   # 8 virtual devices
"""
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
from audiorenderingv2 import multi, testing
from audiorenderingv2.parallel import make_ray_mesh, render_ir_sharded


def main():
    devices = jax.devices()
    mesh = make_ray_mesh()
    print(f"mesh: {mesh.devices.size} x {devices[0].platform} devices")

    v, t = testing.box_room((24.0, 12.0, 18.0))
    sv, st = testing.icosphere(radius=2.0, center=(6.0, -2.0, 4.0), subdivisions=2)
    verts = np.vstack([v, sv])
    tris = np.vstack([t, st + len(v)])
    absorption = np.concatenate([np.full(len(t), 0.2, np.float32),
                                 np.full(len(st), 0.7, np.float32)])
    scene = testing.scene_from_arrays(verts, tris, absorption)
    sc = ar.scene_to_arrays(scene, 512)

    on_cpu = devices[0].platform == "cpu"
    n_rays_total = 16_384 if on_cpu else 16_000_000
    n_rays = (n_rays_total // mesh.devices.size) * mesh.devices.size
    params = ar.TraceParams(sample_rate=16000, ir_length=32000,
                            base_power=3.62, max_bounces=8)
    opts = ar.TracerOptions(tri_chunk=512, block_size=2048)

    # single-pair sharded render + timing
    t0 = time.time()
    ir = render_ir_sharded(sc, jax.random.PRNGKey(0), n_rays,
                           np.zeros(3, np.float32),
                           np.array([8.0, 3.0, -5.0], np.float32), 30.0,
                           params, opts, mesh=mesh)
    ir = jax.block_until_ready(ir)
    wall = time.time() - t0
    print(f"sharded render: {n_rays:.2e} rays over {mesh.devices.size} devices "
          f"in {wall:.1f}s (incl. compile) -> IR sum {float(np.asarray(ir).sum()):.3e}")

    # multi-source x multi-listener matrix on the same mesh
    emitters = np.array([[0.0, 0.0, 0.0], [-6.0, 3.0, 5.0]], np.float32)
    receivers = np.array([[8.0, 3.0, -5.0], [2.0, -4.0, 6.0]], np.float32)
    yaws = np.array([30.0, -45.0])
    pair_rays = max(mesh.devices.size * 256, n_rays // 16)
    pair_rays = (pair_rays // mesh.devices.size) * mesh.devices.size
    irs = multi.render_ir_matrix(sc, jax.random.PRNGKey(1), emitters,
                                 receivers, yaws, pair_rays, params, opts,
                                 mesh=mesh)
    print(f"IR matrix {irs.shape} (sources x listeners x ears x bins), "
          f"finite={bool(np.isfinite(irs).all())}")


if __name__ == "__main__":
    main()
