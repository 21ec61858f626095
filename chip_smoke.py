"""Smoke run of the render -> convolve -> export path on NVIDIA GPUs.

Usage:
  python chip_smoke.py             # one GPU: every single-card phase
  python chip_smoke.py --chips 4   # four GPUs: the sharded phases only

One JAX process drives the card(s); nothing falls back to the CPU. With no
GPU the script exits non-zero and names the missing device. Every phase
prints one ``phase <name>: ok ...`` line with its result, tolerance and warm
times; a failed check raises, so the script exits non-zero and prints no
result. The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.

Single-card phases:
  export     the reference workload through ``cli.main([cfg, "export",
             wav])``: a 14 x 9 x 11 m box room written as .obj/.mtl, a
             seeded 16 kHz source, 100x100x100 = 1M rays, 2 s IR, <= 100
             bounces, base_power 3.62, hrtf 0.9; then warm facade renders
             and the compiled render's memory analysis
  office     AudioRenderer on the ~20k-triangle office scene
             (benchmarks/large_scene.py), 1M rays x 32 bounces
  live       streaming.LiveConvolver on 4096-frame blocks
  fit        diff.fit_scene_parameters(fit_absorption=True), 65,536 rays,
             and the replay gradient against direct XLA autodiff
  oracle     GPU tracer vs the float64 numpy oracle, 4096 rays x 10 bounces
  cpu        GPU tracer vs the same XLA program on the CPU, 65,536 rays x
             100 bounces
  histogram  scatter-add IR histogram vs float64 np.bincount, 1M events x
             128,000 bins, 1 and 4 bands

Four-card phases (``--chips 4``):
  sharded    render_ir_sharded and trace_directions_sharded over a 4-GPU
             rays mesh vs the same directions traced on one card
  dryrun     one sharded differentiable step (__graft_entry__)
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "smoke_out"

ROOM = (14.0, 9.0, 11.0)
EMITTER = (0.0, 0.0, 0.0)
RECEIVER = (2.5, 1.9, 0.0)
SR = 16000

SINGLE_CARD_PHASES = ("export", "office", "live", "fit", "oracle", "cpu",
                      "histogram")
FOUR_CARD_PHASES = ("sharded", "dryrun")


def select_phases(chips: int) -> tuple[str, ...]:
    """The phases one invocation runs: all single-card phases on one card,
    only the multi-card path and its comparison on four."""
    if chips == 1:
        return SINGLE_CARD_PHASES
    if chips == 4:
        return FOUR_CARD_PHASES
    raise ValueError(f"--chips must be 1 or 4, got {chips}")


def last_line(devices) -> str:
    """The final JSON line: the device as JAX reports it."""
    return json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices)}})


def report(phase: str, **fields) -> None:
    parts = [f"{k}={v}" for k, v in fields.items()]
    print(f"phase {phase}: ok " + " ".join(parts), flush=True)


def warm_times(fn, n: int = 3) -> list[float]:
    """Seconds for ``n`` calls of ``fn``, each ended by block_until_ready."""
    import jax

    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        out.append(time.perf_counter() - t0)
    return out


def box_scene(absorption: float = 0.3):
    from audiorenderingv2 import testing

    v, t = testing.box_room(ROOM)
    return testing.scene_from_arrays(v, t, absorption)


# --------------------------------------------------------------- phases
def write_reference_workload(out_dir: Path, seed: int = 0) -> Path:
    """The reference config.json settings over a box room and a seeded
    source; returns the config path."""
    from audiorenderingv2 import testing
    from audiorenderingv2.io import wav as wav_io

    out_dir.mkdir(parents=True, exist_ok=True)
    v, t = testing.box_room(ROOM)
    (out_dir / "room.mtl").write_text("newmtl walls\n")
    lines = ["mtllib room.mtl", "usemtl walls"]
    lines += [f"v {x:.6f} {y:.6f} {z:.6f}" for x, y, z in v]
    lines += [f"f {a + 1} {b + 1} {c + 1}" for a, b, c in t]
    (out_dir / "room.obj").write_text("\n".join(lines) + "\n")

    rng = np.random.default_rng(seed)
    n = 3 * SR
    env = np.exp(-((np.arange(n) % (SR // 2)) / (0.05 * SR)))
    sig = rng.normal(size=n) * env
    wav_io.write_wav(out_dir / "source.wav", 0.5 * sig / np.abs(sig).max(),
                     SR)

    cfg = out_dir / "config.json"
    cfg.write_text(json.dumps({
        "renderer_parameters": {"ir_length_in_seconds": 2},
        "scene_parameters": {
            "audio_file_path": "source.wav",
            "scene_file_path": "room.obj",
            "initial_emitter_pos": dict(zip("xyz", EMITTER)),
            "initial_receiver_pos": dict(zip("xyz", RECEIVER))},
        "pathtracer_parameters": {
            "base_power": 3.62,
            "rays": {"x": 100, "y": 100, "z": 100},
            "ray_max_bounces": 100,
            "hrtf_absorption_rate": 0.9,
            "materials": [{"name": "walls", "mat_absorption": 0.3}]},
    }, indent=1))
    return cfg


def phase_export(state: dict) -> None:
    from audiorenderingv2 import cli, context
    from audiorenderingv2.io import wav as wav_io

    cfg = write_reference_workload(OUT_DIR)
    out_wav = OUT_DIR / "export.wav"
    t0 = time.perf_counter()
    assert cli.main([str(cfg), "export", str(out_wav)]) == 0
    cold_s = time.perf_counter() - t0

    audio = wav_io.read_wav(out_wav)
    src = wav_io.read_wav(OUT_DIR / "source.wav")
    peak = float(np.abs(audio.samples).max())
    assert audio.n_channels == 2, audio.n_channels
    assert audio.sample_rate == SR, audio.sample_rate
    assert audio.n_frames == src.n_frames, (audio.n_frames, src.n_frames)
    assert np.isfinite(audio.samples).all()
    assert abs(peak - 1.0) < 1e-4, peak  # 16-bit PCM holds 32767/32768

    app = context.load_context(cfg)
    r = app.renderer
    assert r.n_rays == 1_000_000 and r.params.max_bounces == 100
    ir = r.render()  # compile (or cache hit) + first render
    assert ir.shape == (2, 2 * SR) and np.isfinite(ir).all() and ir.sum() > 0
    times = warm_times(r.render)

    fn = r._render_fn(True)
    compiled = fn.lower(r._key, np.uint32(0), *r._pose_args()).compile()
    mem = compiled.memory_analysis()
    print(f"export render memory_analysis: {mem}", flush=True)
    state["renderer"] = r
    report("export", wav=f"{audio.n_channels}ch/{audio.sample_rate}Hz/"
           f"{audio.n_frames}frames", peak=f"{peak:.6f}",
           cli_cold_s=f"{cold_s:.3f}", rays=r.n_rays,
           bounces=r.params.max_bounces, ir_sum=f"{float(ir.sum()):.6e}",
           nonzero_bins=int((ir != 0).sum()),
           warm_render_s=[f"{x:.4f}" for x in times])


def phase_office(state: dict) -> None:
    from audiorenderingv2.renderer import AudioRenderer
    from benchmarks.large_scene import office_scene

    scene = office_scene(20000)
    r = AudioRenderer(scene, ir_seconds=2, sample_rate=SR, n_rays=1_000_000,
                      base_power=3.62, max_bounces=32,
                      hrtf_absorption_rate=0.9)
    r.set_receiver(np.array([6.0, 1.0, -8.0], np.float32), 0.0)
    t0 = time.perf_counter()
    ir = r.render()
    first_s = time.perf_counter() - t0
    assert np.isfinite(ir).all() and ir.sum() > 0
    times = warm_times(r.render)
    report("office", tris=scene.n_triangles, rays=r.n_rays, bounces=32,
           first_s=f"{first_s:.3f}", ir_sum=f"{float(ir.sum()):.6e}",
           warm_render_s=[f"{x:.4f}" for x in times])


def phase_live(state: dict) -> None:
    from audiorenderingv2.streaming import LiveConvolver

    r = state["renderer"]  # rendered by the export phase
    lc = LiveConvolver(r, volume=1.0)
    rng = np.random.default_rng(5)
    lat = []
    for _ in range(12):
        block = (rng.normal(size=4096) * 0.1).astype(np.float32)
        t0 = time.perf_counter()
        y = lc.process_block(block)
        lat.append(time.perf_counter() - t0)
        assert y.shape == (2 * 4096,) and np.isfinite(y).all()
    assert np.abs(y).max() > 0
    warm = np.asarray(lat[2:]) * 1e3
    report("live", blocks=len(lat), block_frames=4096,
           block_ms_p50=f"{np.percentile(warm, 50):.3f}",
           block_ms_max=f"{warm.max():.3f}", first_block_s=f"{lat[0]:.3f}")


def phase_fit(state: dict) -> None:
    import jax
    import jax.numpy as jnp

    import audiorenderingv2 as ar
    from audiorenderingv2.core import sampling
    from audiorenderingv2.core.tracer import (TracerOptions, scene_to_arrays,
                                              trace_ir)
    from audiorenderingv2.diff import (fit_scene_parameters, record_paths,
                                       render_ir_replay, render_soft_ir)

    n_rays = 65536
    scene = box_scene(0.3)
    params = ar.TraceParams(sample_rate=SR, ir_length=SR, base_power=3.62,
                            max_bounces=10, hrtf_absorption_rate=0.9)
    target = render_soft_ir(scene, params, n_rays=n_rays, emitter=EMITTER,
                            receiver_pos=RECEIVER, seed=1)
    stamps = []
    res = fit_scene_parameters(
        scene, target, params, n_rays=n_rays, steps=6, learning_rate=0.1,
        receiver_pos=RECEIVER, init_absorption=0.5, seed=1,
        callback=lambda i, loss, theta: stamps.append(time.perf_counter()))
    losses = np.asarray(res.losses)
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    step_s = np.diff(stamps)[1:] if len(stamps) > 2 else []

    # Replay gradient vs direct autodiff through the full tracer, same
    # directions: record (hard nearest-hit search) and the full trace are
    # differently fused programs, so a grazing ray may take another
    # triangle in one of them; 1e-2 relative bounds that handful of rays.
    sc = scene_to_arrays(scene, 2048)
    dirs = sampling.sample_directions(jax.random.PRNGKey(7), n_rays)
    em = jnp.asarray(EMITTER, jnp.float32)
    rec = jnp.asarray(RECEIVER, jnp.float32)
    opts = TracerOptions(soft_binning=True, early_exit=False)
    tri_mat = jnp.where(sc.valid > 0, 1, 0)

    def ir_full(a):
        return trace_ir(sc._replace(absorption=a[tri_mat]), dirs, em, rec,
                        0.0, params, opts)

    ids, recv = jax.jit(lambda d: record_paths(sc, d, em, rec, 0.0, params,
                                               opts))(dirs)

    def ir_rep(a):
        return render_ir_replay(sc._replace(absorption=a[tri_mat]), ids,
                                recv, dirs, em, rec, 0.0, params,
                                soft_binning=True)

    a0 = jnp.array([0.0, 0.35], jnp.float32)
    tgt = jax.lax.stop_gradient(jax.jit(ir_full)(a0 + 0.1))
    g_full = np.asarray(jax.jit(jax.grad(
        lambda a: jnp.sum((ir_full(a) - tgt) ** 2) * 1e6))(a0))
    g_rep = np.asarray(jax.jit(jax.grad(
        lambda a: jnp.sum((ir_rep(a) - tgt) ** 2) * 1e6))(a0))
    rel = abs(g_rep[1] - g_full[1]) / abs(g_full[1])
    assert np.isfinite(g_rep).all() and rel < 1e-2, (g_rep, g_full)
    report("fit", rays=n_rays, steps=len(losses),
           loss_first=f"{losses[0]:.6e}", loss_last=f"{losses[-1]:.6e}",
           warm_step_s=[f"{x:.4f}" for x in step_s],
           grad_full=f"{g_full[1]:.6e}", grad_replay=f"{g_rep[1]:.6e}",
           grad_rel_err=f"{rel:.3e}", grad_tol="1e-2 (f32)")


def phase_oracle(state: dict) -> None:
    import jax
    import jax.numpy as jnp

    import audiorenderingv2 as ar
    from audiorenderingv2 import testing
    from audiorenderingv2.core import sampling, tracer_ref
    from audiorenderingv2.core.tracer import scene_to_arrays, trace_ir

    scene = box_scene(0.3)
    params = ar.TraceParams(sample_rate=SR, ir_length=2 * SR, base_power=3.62,
                            max_bounces=10, hrtf_absorption_rate=0.9)
    dirs = sampling.sample_directions(jax.random.PRNGKey(0), 4096)
    sc = scene_to_arrays(scene, 2048)
    gpu = jax.jit(lambda d: trace_ir(
        sc, d, jnp.asarray(EMITTER), jnp.asarray(RECEIVER), 0.0, params))(
            dirs)
    ref = tracer_ref.trace_ir_reference(
        scene, np.asarray(dirs), np.asarray(EMITTER), np.asarray(RECEIVER),
        0.0, params)
    de, l1 = testing.ir_distance(gpu, ref)
    # f32 on the card against float64: the oracle's own CPU test holds
    # 2e-3 per bin; on the GPU a ray grazing an edge may take the other
    # triangle, so the bars are statistical.
    testing.assert_ir_close(gpu, ref, rtol=2e-3, atol=1e-9)
    report("oracle", rays=4096, bounces=10, energy_rel=f"{de:.3e}",
           l1_rel=f"{l1:.3e}", tol="energy 2e-3, L1 1e-2 (GPU f32 vs f64)")


def phase_cpu(state: dict) -> None:
    import jax
    import jax.numpy as jnp

    import audiorenderingv2 as ar
    from audiorenderingv2 import testing
    from audiorenderingv2.core import sampling
    from audiorenderingv2.core.tracer import scene_to_arrays, trace_ir

    params = ar.TraceParams(sample_rate=SR, ir_length=2 * SR, base_power=3.62,
                            max_bounces=100, hrtf_absorption_rate=0.9)
    sc = scene_to_arrays(box_scene(0.3), 2048)
    dirs = sampling.sample_directions(jax.random.PRNGKey(1), 65536)
    em = jnp.asarray(EMITTER, jnp.float32)
    rec = jnp.asarray(RECEIVER, jnp.float32)
    fn = jax.jit(lambda s, d, e, r: trace_ir(s, d, e, r, 0.0, params))
    gpu = fn(sc, dirs, em, rec)
    cpu = jax.devices("cpu")[0]
    on_cpu = jax.device_put((sc, dirs, em, rec), cpu)
    ref = fn(*on_cpu)
    assert list(ref.devices())[0].platform == "cpu"
    de, l1 = testing.ir_distance(gpu, ref)
    # 100 bounces are chaotic: an ulp of difference between the two
    # backends sends a few rays down other paths; atomics sum in a
    # varying order. assert_ir_close's statistical bars (energy, L1).
    testing.assert_ir_close(gpu, ref)
    report("cpu", rays=65536, bounces=100, energy_rel=f"{de:.3e}",
           l1_rel=f"{l1:.3e}", tol="energy 1e-3, L1 1e-2 (f32 both)")


def phase_histogram(state: dict) -> None:
    import jax
    import jax.numpy as jnp

    from audiorenderingv2.core import binning

    rng = np.random.default_rng(3)
    n_events, n_bins = 1_000_000, 2 * 64000
    # Render-shaped: dense early bins, a long exponentially decaying tail,
    # a few out-of-range events that must be dropped.
    bins = np.minimum(rng.exponential(n_bins / 4, n_events),
                      n_bins + 99).astype(np.int32)
    bins[:1000] = -1 - np.arange(1000)
    out = {}
    for n_bands in (1, 4):
        w = (np.exp(-bins[:, None] / 20000.0)
             * rng.uniform(0.5, 1.0, (n_events, n_bands)) * 1e-6)
        w = w.astype(np.float32)
        hist = np.asarray(jax.jit(
            lambda b, x: binning.histogram_sum_banded(b, x, n_bins))(
                jnp.asarray(bins), jnp.asarray(w)))
        keep = (bins >= 0) & (bins < n_bins)
        ref = np.stack([np.bincount(bins[keep], w[keep, k].astype(np.float64),
                                    minlength=n_bins)
                        for k in range(n_bands)], axis=1)
        occ = ref > 0
        rel = np.abs(hist[occ] - ref[occ]) / ref[occ]
        zeroed = int((hist[occ] == 0).sum())
        assert rel.max() <= 1e-5 and zeroed == 0, (rel.max(), zeroed)
        out[n_bands] = (float(rel.max()), float(np.median(rel)), zeroed)
    report("histogram", events=n_events, bins=n_bins,
           **{f"bands{k}": f"max_rel={v[0]:.3e}/median_rel={v[1]:.3e}/"
              f"zeroed={v[2]}" for k, v in out.items()},
           tol="1e-5 per occupied bin, none zeroed (f32 atomics vs f64)")


def phase_sharded(state: dict) -> None:
    import jax
    import jax.numpy as jnp

    import audiorenderingv2 as ar
    from audiorenderingv2 import testing
    from audiorenderingv2.core import sampling
    from audiorenderingv2.core.tracer import scene_to_arrays, trace_ir
    from audiorenderingv2.parallel import (make_ray_mesh, render_ir_sharded,
                                           trace_directions_sharded)

    mesh = make_ray_mesh(jax.devices()[:4])
    sc = scene_to_arrays(box_scene(0.3), 2048)
    params = ar.TraceParams(sample_rate=SR, ir_length=2 * SR, base_power=3.62,
                            max_bounces=20, hrtf_absorption_rate=0.9)
    n = 1 << 20
    em = jnp.asarray(EMITTER, jnp.float32)
    rec = jnp.asarray(RECEIVER, jnp.float32)
    one = jax.jit(lambda d: trace_ir(sc, d, em, rec, 0.0, params))
    four = jax.jit(lambda d: trace_directions_sharded(
        sc, d, em, rec, 0.0, params, mesh=mesh))

    dirs = sampling.sample_directions(jax.random.PRNGKey(3), n)
    ir1, ir4 = one(dirs), four(dirs)
    d_dir = testing.ir_distance(ir4, ir1)
    # The per-card partial IRs meet in a psum and the atomics sum in
    # varying order: f32 summation differences only, statistical bars.
    testing.assert_ir_close(ir4, ir1)
    t1, t4 = warm_times(lambda: one(dirs)), warm_times(lambda: four(dirs))

    key = jax.random.PRNGKey(4)
    rendered = jax.jit(lambda k: render_ir_sharded(
        sc, k, n, em, rec, 0.0, params, mesh=mesh))(key)
    # render_ir_sharded samples n/4 directions per card from
    # fold_in(key, card index); the same directions on one card:
    dirs_r = jnp.concatenate([sampling.sample_directions(
        jax.random.fold_in(key, i), n // 4) for i in range(4)])
    d_key = testing.ir_distance(rendered, one(dirs_r))
    testing.assert_ir_close(rendered, one(dirs_r))
    report("sharded", cards=4, rays=n, bounces=20,
           directions_energy_rel=f"{d_dir[0]:.3e}",
           directions_l1_rel=f"{d_dir[1]:.3e}",
           keyed_energy_rel=f"{d_key[0]:.3e}",
           keyed_l1_rel=f"{d_key[1]:.3e}",
           tol="energy 1e-3, L1 1e-2 (f32)",
           warm_one_card_s=[f"{x:.4f}" for x in t1],
           warm_four_cards_s=[f"{x:.4f}" for x in t4])


def phase_dryrun(state: dict) -> None:
    import __graft_entry__

    __graft_entry__.dryrun_multichip(4)
    report("dryrun", cards=4)


PHASES = {name: globals()[f"phase_{name}"]
          for name in SINGLE_CARD_PHASES + FOUR_CARD_PHASES}


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--chips", type=int, default=1, choices=(1, 4))
    args = parser.parse_args(argv)
    phases = select_phases(args.chips)

    # The CPU comparison needs the CPU backend beside the GPU one; the GPU
    # stays the default device.
    platforms = os.environ.get("JAX_PLATFORMS")
    if platforms and "cpu" not in platforms.split(","):
        os.environ["JAX_PLATFORMS"] = platforms + ",cpu"
    sys.path.insert(0, str(ROOT))
    import jax

    import audiorenderingv2  # noqa: F401  (compile cache, package on path)
    from audiorenderingv2.utils.profiling import gpu_card_info, require_gpus

    gpus = require_gpus(args.chips)
    for line in gpu_card_info():
        print(f"card: {line}", flush=True)
    print(f"jax {jax.__version__}: platform={gpus[0].platform} "
          f"device_kind={gpus[0].device_kind} count={len(jax.devices())}",
          flush=True)

    state: dict = {}
    for name in phases:
        t0 = time.perf_counter()
        PHASES[name](state)
        print(f"phase {name}: wall {time.perf_counter() - t0:.1f}s",
              flush=True)
    print(last_line(jax.devices()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
