"""Product-level workloads on the device.

The reference's product loop is a walkthrough: the listener moves, the
re-render policy fires (move > 2 m / turn > 5 deg / 1 s settle,
main.cpp:470-498), a detached worker re-renders while the audio callback
keeps streaming (silence while the first render is pending,
main.cpp:128-132). Its single-pair limitation (LaunchParams.h:20-43) is
exceeded by the multi-pose matrix. This bench times both end-to-end:

  walkthrough   Auralizer.run along a recorded trajectory at the full
                reference workload over a 14 x 9 x 11 m box room (1M
                rays/render, 2 s IR, 16 kHz, a seeded noise source):
                sustained renders/s, wall time vs audio time (real-time
                factor), renders fired
  duplex        paced LiveConvolver blocks while an AsyncRenderWorker
                re-renders: silenced-block count (the reference's
                is_rendering guard) + p50/p95 block latency
  matrix        render_ir_matrix S x L pairs, pair-batched vmap path:
                pairs/s and rays/s aggregate

Writes benchmarks/results/product_bench.json and prints progress.
"""
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax

import audiorenderingv2 as ar
from audiorenderingv2 import multi, streaming, testing
from audiorenderingv2.renderer import AudioRenderer

# CI-size override for CPU smoke runs (keeps chip runs at full scale).
N_RAYS = int(os.environ.get("AR2_PB_RAYS", 1_000_000))
N_RAYS_MATRIX = int(os.environ.get("AR2_PB_RAYS_MATRIX", 250_000))

OUT = Path(__file__).parent / "results" / "product_bench.json"
report = {}


def load_scene():
    v, t = testing.box_room((14.0, 9.0, 11.0))
    return testing.scene_from_arrays(v, t, 0.3)


def make_renderer(n_rays=N_RAYS):
    return AudioRenderer(load_scene(), ir_seconds=2, sample_rate=16000,
                         n_rays=n_rays, base_power=3.62, max_bounces=100,
                         hrtf_absorption_rate=0.9)


def walkthrough():
    print("== walkthrough ==", flush=True)
    r = make_renderer()
    # 20 s walk through the room: pose keyframes inside the scene
    # bounds, moving >2 m between seconds so the distance rule fires
    # repeatedly; matches the reference's WASD pace.
    times = np.arange(0.0, 21.0, 1.0)
    xs = np.linspace(0.5, 4.0, times.size)
    zs = np.interp(np.arange(times.size) % 6, [0, 5], [-3.0, 3.0])
    pos = np.stack([xs, np.full_like(xs, 1.9), zs], axis=1)
    yaws = np.linspace(0.0, 180.0, times.size)
    traj = streaming.ListenerTrajectory.from_arrays(times, pos, yaws)

    sr = 16000
    mono = np.random.default_rng(0).normal(size=sr) * 0.1
    reps = int(np.ceil(20 * sr / mono.shape[0]))
    samples = np.tile(mono, reps)[: 20 * sr].astype(np.float32)

    # Warm the two compiled programs (render + whole-signal convolve) once
    # and report that separately: folding compilation into the loop time
    # would misreport the sustained rate the reference's policy actually
    # experiences (its pipeline build is likewise one-time,
    # AudioRenderer.cpp:264-296).
    p0, y0 = traj.at(0.0)
    t0 = time.time()
    r.full_render_cycle(p0, y0, samples)
    cold_s = time.time() - t0

    aur = streaming.Auralizer(r, traj, chunk_seconds=0.25)
    t0 = time.time()
    out = aur.run(samples)
    wall = time.time() - t0
    assert np.isfinite(out).all()
    report["walkthrough"] = {
        "audio_seconds": 20.0,
        "compile_first_cycle_s": round(cold_s, 1),
        "wall_seconds": round(wall, 2),
        "real_time_factor": round(20.0 / wall, 2),
        "renders": aur.renders,
        "renders_per_s": round(aur.renders / wall, 2),
        "n_rays_per_render": N_RAYS,
    }
    print(json.dumps(report["walkthrough"]), flush=True)
    return r


def duplex(r):
    print("== duplex ==", flush=True)
    sr = 16000
    samples = None
    worker = streaming.AsyncRenderWorker(r, samples)
    lc = streaming.LiveConvolver(r, volume=1.0, render_guard=worker)
    rng = np.random.default_rng(3)
    block = rng.normal(size=4096).astype(np.float32) * 0.1
    # warm the convolve path
    lc.process_block(block)
    lat = []
    silenced = 0
    n_blocks = 80  # 80 x 4096 / 16k = 20.5 s of audio
    budget = 4096 / sr  # real-time pacing: one block per 256 ms
    poses = [(np.array([0.5 + 0.05 * i, 1.9, -1.0 + 0.05 * i]), 5.0 * i)
             for i in range(n_blocks)]
    next_deadline = time.time()
    for i in range(n_blocks):
        if i % 10 == 0:  # listener moved: fire a background re-render
            worker.request(*poses[i])
        t0 = time.time()
        y = lc.process_block(block)
        lat.append(time.time() - t0)
        if not np.any(y):
            silenced += 1
        # Pace at the audio clock (the RtAudio callback cadence,
        # main.cpp:144-161): an unpaced loop would spin through silence
        # faster than the worker can finish one render and overstate the
        # silenced count.
        next_deadline += budget
        sleep = next_deadline - time.time()
        if sleep > 0:
            time.sleep(sleep)
    worker.wait_idle()
    worker.close()
    lat_ms = np.asarray(lat) * 1e3
    report["duplex"] = {
        "blocks": n_blocks,
        "block_frames": 4096,
        "silenced_blocks": int(silenced),
        "background_renders": worker.renders,
        "block_ms_p50": round(float(np.percentile(lat_ms, 50)), 2),
        "block_ms_p95": round(float(np.percentile(lat_ms, 95)), 2),
        "block_budget_ms": round(4096 / sr * 1e3, 1),
    }
    print(json.dumps(report["duplex"]), flush=True)


def matrix():
    print("== matrix ==", flush=True)
    scene = load_scene()
    params = ar.TraceParams(sample_rate=16000, ir_length=32000,
                            base_power=3.62, max_bounces=100,
                            energy_threshold=0.0, hrtf_absorption_rate=0.9)
    n_rays = N_RAYS_MATRIX
    s_pos = np.array([[0.0, 0.0, 0.0], [1.0, 2.0, 0.5],
                      [2.0, -2.0, -1.0], [0.5, 3.0, 1.0]], np.float32)
    l_pos = np.stack([np.linspace(0.5, 4.0, 8),
                      np.full(8, 1.9),
                      np.linspace(-2.0, 2.0, 8)], axis=1).astype(np.float32)
    yaws = np.linspace(0.0, 90.0, 8).astype(np.float32)

    opts = ar.TracerOptions()
    sc = ar.scene_to_arrays(scene, opts.tri_chunk)
    for name, pb in [("loop", 1), ("vmap8", 8)]:
        t0 = time.time()
        irs = multi.render_ir_matrix(sc, jax.random.PRNGKey(0), s_pos,
                                     l_pos, yaws, n_rays, params, opts,
                                     pair_batch=pb)
        first = time.time() - t0
        t0 = time.time()
        irs = multi.render_ir_matrix(sc, jax.random.PRNGKey(1), s_pos,
                                     l_pos, yaws, n_rays, params, opts,
                                     pair_batch=pb)
        warm = time.time() - t0
        assert np.isfinite(irs).all() and irs.sum() > 0
        report[f"matrix_{name}"] = {
            "pairs": 32, "n_rays_per_pair": n_rays,
            "compile_first_s": round(first, 1),
            "warm_s": round(warm, 2),
            "pairs_per_s": round(32 / warm, 2),
            "aggregate_rays_per_s": round(32 * n_rays / warm, 0),
        }
        print(json.dumps(report[f"matrix_{name}"]), flush=True)


def main():
    print(f"device: {jax.devices()[0]}", flush=True)
    which = sys.argv[1] if len(sys.argv) > 1 else "all"
    r = None
    if which in ("walkthrough", "all"):
        r = walkthrough()
    if which in ("duplex", "all"):
        duplex(r or make_renderer())
    if which in ("matrix", "all"):
        matrix()
    OUT.parent.mkdir(parents=True, exist_ok=True)
    with open(OUT, "w") as f:
        json.dump(report, f, indent=1)
    print(f"wrote {OUT}", flush=True)


if __name__ == "__main__":
    main()
