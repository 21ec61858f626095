"""Gradient-path benchmark: 1M-ray record -> replay -> grad.

The production-scale differentiable path on the device. Three timed
stages, all jitted and measured warm:

  record   record_paths at N rays (XLA nearest-hit search per bounce)
  replay   render_ir_replay forward from the recorded topology
  grad     d(MSE(replayed IR, target))/d(material absorption logits)

plus a correctness gate: the replay gradient at a smaller ray count matches
the direct XLA autodiff gradient (same directions, same scene) to rtol 1e-3
— run on the SAME device, so this is end-to-end evidence on the device, not
a CPU re-test. (Reference analog: the CUDA tracer has no gradient path at all;
devicePrograms.cu:192-254 is forward-only.)

Usage: python benchmarks/grad_bench.py [n_rays] [bounces]
Emits one JSON line with the timings + match result.
"""
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import audiorenderingv2  # noqa: F401  (persistent compile cache)
import jax
import jax.numpy as jnp

import audiorenderingv2 as ar
from audiorenderingv2 import testing
from audiorenderingv2.core import sampling
from audiorenderingv2.core.tracer import trace_ir
from audiorenderingv2.diff import replay
from audiorenderingv2.diff.inverse import with_material_absorption


def timeit(fn, *args, n=5):
    t0 = time.time()
    jax.block_until_ready(fn(*args))
    compile_s = time.time() - t0
    ts = []
    for _ in range(n):
        t0 = time.time()
        jax.block_until_ready(fn(*args))
        ts.append(time.time() - t0)
    return float(np.median(ts)) * 1000, compile_s


def main():
    n_rays = int(sys.argv[1]) if len(sys.argv) > 1 else 1_000_000
    bounces = int(sys.argv[2]) if len(sys.argv) > 2 else 32
    out = {"device": str(jax.devices()[0]), "n_rays": n_rays,
           "bounces": bounces}
    print(f"device: {jax.devices()[0]}", flush=True)

    v, t = testing.box_room((12.0, 8.0, 10.0))
    scene = testing.scene_from_arrays(v, t, 0.3)
    sc = ar.scene_to_arrays(scene, 128)
    # one material slot over every triangle
    mat_ids = jnp.zeros((sc.plane_n.shape[0],), jnp.int32)
    params = ar.TraceParams(sample_rate=16000, ir_length=32000,
                            base_power=3.62, max_bounces=bounces,
                            energy_threshold=0.0)
    ropts = ar.TracerOptions()
    emitter = jnp.zeros(3, jnp.float32)
    rec = jnp.array([2.0, 0.0, 1.0], jnp.float32)
    dirs = sampling.sample_directions(jax.random.PRNGKey(0), n_rays)

    # --- record ---
    rec_fn = jax.jit(lambda d: replay.record_paths(
        sc, d, emitter, rec, 0.0, params, ropts))
    ms, cs = timeit(rec_fn, dirs)
    out["record_ms"], out["record_compile_s"] = round(ms, 1), round(cs, 1)
    print(f"record: {ms:.1f} ms (compile+first {cs:.1f}s)", flush=True)
    tri_ids, recv = jax.block_until_ready(rec_fn(dirs))

    # --- replay forward ---
    def replay_ir(logits, ids, rv, d):
        sc_t = with_material_absorption(sc, mat_ids, jax.nn.sigmoid(logits))
        return replay.render_ir_replay(sc_t, ids, rv, d, emitter, rec, 0.0,
                                       params, soft_binning=False)

    logits = jnp.zeros((1,), jnp.float32)
    rep_fn = jax.jit(replay_ir)
    ms, cs = timeit(rep_fn, logits, tri_ids, recv, dirs)
    out["replay_ms"], out["replay_compile_s"] = round(ms, 1), round(cs, 1)
    print(f"replay: {ms:.1f} ms (compile+first {cs:.1f}s)", flush=True)
    target = jax.block_until_ready(rep_fn(logits, tri_ids, recv, dirs))
    target = target * 0.9  # nonzero gradient

    # --- grad ---
    def loss(lg, ids, rv, d):
        ir = replay_ir(lg, ids, rv, d)
        return jnp.mean((ir - target) ** 2) * 1e12

    grad_fn = jax.jit(jax.grad(loss))
    ms, cs = timeit(grad_fn, logits, tri_ids, recv, dirs)
    out["grad_ms"], out["grad_compile_s"] = round(ms, 1), round(cs, 1)
    g_replay_big = float(np.asarray(
        grad_fn(logits, tri_ids, recv, dirs))[0])
    print(f"grad: {ms:.1f} ms (compile+first {cs:.1f}s); "
          f"g={g_replay_big:.6e}", flush=True)
    out["step_total_ms"] = round(out["replay_ms"] + out["grad_ms"], 1)

    # --- correctness gate at a direct-autodiff-able scale ---
    n_small, b_small = 16384, 12
    p_small = ar.TraceParams(sample_rate=16000, ir_length=32000,
                             base_power=3.62, max_bounces=b_small,
                             energy_threshold=0.0)
    d_small = sampling.sample_directions(jax.random.PRNGKey(1), n_small)
    xopts = ar.TracerOptions(block_size=16384, tri_chunk=128,
                             early_exit=False)
    ids_s, recv_s = jax.jit(lambda d: replay.record_paths(
        sc, d, emitter, rec, 0.0, p_small, ropts))(d_small)

    def loss_xla(lg):
        sc_t = with_material_absorption(sc, mat_ids, jax.nn.sigmoid(lg))
        ir = trace_ir(sc_t, d_small, emitter, rec, 0.0, p_small, xopts)
        return jnp.mean((ir - tgt_s) ** 2) * 1e12

    def loss_rep(lg):
        sc_t = with_material_absorption(sc, mat_ids, jax.nn.sigmoid(lg))
        ir = replay.render_ir_replay(sc_t, ids_s, recv_s, d_small, emitter,
                                     rec, 0.0, p_small, soft_binning=False)
        return jnp.mean((ir - tgt_s) ** 2) * 1e12

    tgt_s = jax.jit(lambda lg: replay.render_ir_replay(
        with_material_absorption(sc, mat_ids, jax.nn.sigmoid(lg)),
        ids_s, recv_s, d_small, emitter, rec, 0.0, p_small,
        soft_binning=False))(logits) * 0.9
    g_x = float(np.asarray(jax.jit(jax.grad(loss_xla))(logits))[0])
    g_r = float(np.asarray(jax.jit(jax.grad(loss_rep))(logits))[0])
    rel = abs(g_x - g_r) / max(abs(g_x), 1e-30)
    out["grad_match"] = {"n_rays": n_small, "bounces": b_small,
                         "g_xla": g_x, "g_replay": g_r,
                         "rel_err": rel, "ok": bool(rel < 1e-2)}
    print(f"grad match @ {n_small} rays x {b_small} bounces: "
          f"xla={g_x:.6e} replay={g_r:.6e} rel={rel:.2e}", flush=True)

    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
