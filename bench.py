"""Benchmark: IR render throughput through the AudioRenderer facade.

Two cells, both built with the facade's default options:

  reference  the reference's shipped config.json workload (config.json:26-36
             + Context defaults) over a 14 x 9 x 11 m box room (the
             reference's 3D_U.obj is not shipped), 100x100x100 = 1M rays,
             2 s IR at 16 kHz, <= 100 bounces, base_power 3.62
  office     benchmarks/large_scene.py's ~20k-triangle office, 1M rays,
             32 bounces — intersection-bound where the first is bound by
             the bounce loop

Each render is timed on the host clock and ends in ``block_until_ready``.
The ray-triangle tests a render performs are counted from the scene (the
XLA tracer tests every triangle of the padded scene at every bounce of a
live ray) and divided by the render time against the card's float32 peak.

Baseline: the reference measures-but-never-publishes its OptiX render time
(AudioRenderer.cpp:513-518; BASELINE.md). Its only stated performance bar is
real-time auralization (README.md:10) under the 1-second-settle re-render
policy (main.cpp:470-498), i.e. >= 1 IR render/s at the default 1M-ray
workload: ``vs_baseline = rays_per_s / 1e6``.

Needs a GPU: with none it exits non-zero. Prints the device, the card's
name and power limit to stderr and ONE JSON line to stdout.
"""
import json
import os
import sys
import time

import numpy as np

# 1 default render (1M rays, <=100 bounces) per second — the reference's
# real-time re-render bar on its CUDA target.
CUDA_BASELINE_RAYS_PER_S = 1.0e6

# Published dense peaks by device_kind (NVIDIA H100 data sheet, SXM part;
# rates assume the card's full 700 W power limit). The ray-triangle tests
# are float32 work outside the tensor cores.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"f32_flops": 67e12, "hbm_bytes_per_s": 3.35e12,
                              "source": "NVIDIA H100 data sheet (SXM5)"},
}
# One Möller–Trumbore test in the XLA tracer: six 3-term dot products
# (3 mul + 2 add each), the plane-t division, two multiply-adds for u/v and
# the compares/selects of the hit test ~= 64 flop.
FLOPS_PER_TEST = 64.0


def peak_for(device_kind: str) -> dict:
    """The peak table's row for ``device_kind``; an unknown device is an
    error, never a default."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise ValueError(f"no peak table entry for device_kind "
                         f"{device_kind!r} (known: {sorted(PEAKS)})") from None


def tests_per_render(n_padded_tris: int, bounces: np.ndarray) -> float:
    """Ray-triangle tests of one render: every live ray tests every
    (padded) triangle once per completed bounce, plus the final test that
    ends it (miss, receiver hit or limit)."""
    return (float(bounces.sum()) + bounces.size) * n_padded_tris


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def time_cell(name, renderer, n_warm=5):
    """Compile + first render, then ``n_warm`` timed renders; the bounce
    counts come from one extra stats render of the same rays and scene."""
    import jax

    from audiorenderingv2.core.tracer import render_ir

    t0 = time.perf_counter()
    ir = renderer.render()
    compile_first_s = time.perf_counter() - t0
    assert np.isfinite(ir).all() and ir.sum() > 0, name
    times = []
    for _ in range(n_warm):
        t0 = time.perf_counter()
        jax.block_until_ready(renderer.render())
        times.append(time.perf_counter() - t0)
    t_render = float(np.median(times))

    em, rec, yaw = renderer._pose_args()
    _, stats = jax.jit(lambda k: render_ir(
        renderer.sc, k, renderer.n_rays, em, rec, yaw, renderer.params,
        renderer.opts, with_stats=True))(jax.random.PRNGKey(1))
    bounces = np.asarray(stats["bounces"])
    tests = tests_per_render(int(renderer.sc.valid.shape[0]), bounces)
    log(f"{name}: compile+first {compile_first_s:.3f} s; warm renders "
        f"{[f'{t * 1e3:.3f} ms' for t in times]}; median "
        f"{t_render * 1e3:.3f} ms; {tests:.4e} ray-triangle tests")
    return {"n_tris": int(renderer.scene.n_triangles),
            "n_rays": renderer.n_rays,
            "max_bounces": renderer.params.max_bounces,
            "render_ms_median": t_render * 1e3,
            "render_ms_all": [t * 1e3 for t in times],
            "renders_per_s": 1.0 / t_render,
            "rays_per_s": renderer.n_rays / t_render,
            "compile_first_s": compile_first_s,
            "mean_bounces": float(bounces.mean()),
            "tests_per_render": tests,
            "flops_per_s": tests * FLOPS_PER_TEST / t_render}


def main():
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import jax

    from audiorenderingv2 import testing
    from audiorenderingv2.renderer import AudioRenderer
    from audiorenderingv2.utils.profiling import gpu_card_info, require_gpus
    from benchmarks.large_scene import office_scene

    dev = require_gpus(1)[0]
    peak = peak_for(dev.device_kind)
    cards = gpu_card_info()
    log(f"device: platform={dev.platform} device_kind={dev.device_kind} "
        f"count={len(jax.devices())}; card: {cards}")

    v, t = testing.box_room((14.0, 9.0, 11.0))
    scene = testing.scene_from_arrays(v, t, 0.3)
    scene_name = "box_room_14x9x11"
    common = dict(ir_seconds=2, sample_rate=16000, n_rays=1_000_000,
                  base_power=3.62, hrtf_absorption_rate=0.9)
    small = AudioRenderer(scene, max_bounces=100, **common)
    small.set_receiver(np.array([2.5, 1.9, 0.0], np.float32), 0.0)
    cells = {"reference": time_cell(f"reference ({scene_name})", small)}

    large = AudioRenderer(office_scene(20000), max_bounces=32, **common)
    large.set_receiver(np.array([6.0, 1.0, -8.0], np.float32), 0.0)
    cells["office"] = time_cell("office", large)
    for c in cells.values():
        c["pct_of_f32_peak"] = 100.0 * c["flops_per_s"] / peak["f32_flops"]

    rays_per_s = cells["reference"]["rays_per_s"]
    print(json.dumps({
        "metric": "rays_per_s",
        "value": rays_per_s,
        "unit": "rays/s",
        "vs_baseline": rays_per_s / CUDA_BASELINE_RAYS_PER_S,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices()), "card": cards},
        "peak": peak,
        "reference_scene": scene_name,
        "cells": cells,
    }))


if __name__ == "__main__":
    main()
