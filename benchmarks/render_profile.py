"""Where a warm AudioRenderer.render() spends its device time.

Traces one warm 1M-ray render of each scene with jax.profiler and splits
the device time between:

  nearest_hit   kernels of the ray-triangle search (jax.named_scope
                "nearest_hit" in core/tracer.py)
  ir_histogram  the scatter-add histogram (named scope in core/binning.py)
  other         every other kernel: bounce bookkeeping, sampling, the
                cross-ear shift, copies

plus the device's busy and idle share over the render window and the
kernel launch count. Kernels are attributed through the compiled HLO: each
GPU kernel is named after its fusion, whose metadata carries the scope.

Scenes: ``reference`` (14 x 9 x 11 m box, 100 bounces — the reference
config.json workload) and ``office`` (benchmarks/large_scene.py, ~20k
triangles, 32 bounces). Both 1M rays, 2 s IR at 16 kHz.

Usage: python benchmarks/render_profile.py [out_dir]
Writes <out_dir>/<scene>.json and prints one JSON line per scene.
"""
import glob
import json
import re
import shutil
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax

from audiorenderingv2 import testing
from audiorenderingv2.renderer import AudioRenderer
from audiorenderingv2.utils.profiling import gpu_card_info, require_gpus
from benchmarks.large_scene import office_scene

SCOPES = ("nearest_hit", "ir_histogram")


def scope_map(hlo_text: str) -> dict:
    """Instruction name (dots as underscores) -> scope of its op_name."""
    out = {}
    pat = re.compile(r'%?([\w.\-]+) = .*?op_name="([^"]*)"')
    for m in pat.finditer(hlo_text):
        name, op_name = m.group(1), m.group(2)
        scope = next((s for s in SCOPES if s in op_name), "other")
        out[name.replace(".", "_").replace("-", "_")] = scope
    return out


def union_ns(intervals) -> int:
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def reduce_trace(xplane: str, scopes: dict) -> dict:
    """Device time per scope, busy/idle share, top kernels."""
    from jax.profiler import ProfileData

    data = ProfileData.from_file(xplane)
    planes = [p for p in data.planes if p.name.startswith("/device:GPU")]
    assert planes, [p.name for p in data.planes]
    per_kernel: dict = {}
    intervals = []
    line_names = []
    for line in planes[0].lines:
        line_names.append(line.name)
        if not line.name.startswith("Stream"):
            continue
        for ev in line.events:
            stats = dict(ev.stats)
            op = str(stats.get("hlo_op", ev.name))
            if op == "command_buffer":  # kernels replayed from a CUDA graph
                op = ev.name
            k = per_kernel.setdefault(op, [0, 0, ev.name])
            k[0] += int(ev.duration_ns)
            k[1] += 1
            intervals.append((int(ev.start_ns),
                              int(ev.start_ns + ev.duration_ns)))
    assert intervals, line_names
    window = max(e for _, e in intervals) - min(s for s, _ in intervals)
    busy = union_ns(intervals)
    by_scope = {s: 0 for s in SCOPES + ("other",)}
    unmatched = 0
    for op, (ns, _, _) in per_kernel.items():
        key = op.replace(".", "_").replace("-", "_")
        scope = scopes.get(key)
        if scope is None:
            unmatched += ns
            scope = "other"
        by_scope[scope] += ns
    kernel_ns = sum(v[0] for v in per_kernel.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:25]
    return {
        "window_ms": window / 1e6,
        "busy_ms": busy / 1e6,
        "idle_share": 1.0 - busy / window,
        "kernel_ms": kernel_ns / 1e6,
        "launches": sum(v[1] for v in per_kernel.values()),
        "share": {s: ns / kernel_ns for s, ns in by_scope.items()},
        "ms": {s: ns / 1e6 for s, ns in by_scope.items()},
        "unattributed_ms": unmatched / 1e6,
        "top_kernels": [
            {"op": op, "kernel": v[2], "ms": v[0] / 1e6, "count": v[1],
             "scope": scopes.get(op.replace(".", "_").replace("-", "_"),
                                 "?")}
            for op, v in top],
        "device_lines": line_names,
    }


def profile(name: str, renderer: AudioRenderer, out_dir: Path) -> dict:
    t0 = time.perf_counter()
    renderer.render()
    first_s = time.perf_counter() - t0
    warm = []
    for _ in range(3):
        t0 = time.perf_counter()
        renderer.render()
        warm.append(time.perf_counter() - t0)
    fn = renderer._render_fn(True)
    hlo = fn.lower(renderer._key, np.uint32(0),
                   *renderer._pose_args()).compile().as_text()
    trace_dir = out_dir / f"trace_{name}"
    with jax.profiler.trace(str(trace_dir)):
        jax.block_until_ready(renderer.render())
    xplane = sorted(glob.glob(str(trace_dir / "**" / "*.xplane.pb"),
                              recursive=True))[-1]
    reduced = reduce_trace(xplane, scope_map(hlo))
    shutil.rmtree(trace_dir)  # large; the reduction below is what is kept
    res = {"scene": name, "tris": int(renderer.scene.n_triangles),
           "rays": renderer.n_rays, "bounces": renderer.params.max_bounces,
           "first_s": first_s, "warm_render_s": warm,
           **reduced}
    (out_dir / f"{name}.json").write_text(json.dumps(res, indent=1))
    return res


def main():
    out_dir = Path(sys.argv[1] if len(sys.argv) > 1
                   else Path(__file__).parent / "results" / "profile")
    out_dir.mkdir(parents=True, exist_ok=True)
    gpu = require_gpus(1)[0]
    print(f"card: {gpu_card_info()}; device_kind={gpu.device_kind}",
          flush=True)
    common = dict(ir_seconds=2, sample_rate=16000, n_rays=1_000_000,
                  base_power=3.62, hrtf_absorption_rate=0.9)
    v, t = testing.box_room((14.0, 9.0, 11.0))
    ref = AudioRenderer(testing.scene_from_arrays(v, t, 0.3),
                        max_bounces=100, **common)
    ref.set_receiver(np.array([2.5, 1.9, 0.0], np.float32), 0.0)
    office = AudioRenderer(office_scene(20000), max_bounces=32, **common)
    office.set_receiver(np.array([6.0, 1.0, -8.0], np.float32), 0.0)
    for name, r in (("reference", ref), ("office", office)):
        res = profile(name, r, out_dir)
        res.pop("top_kernels")
        print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
