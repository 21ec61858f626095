"""Path-replay differentiation (diff/replay.py).

Replay must reproduce the forward tracer exactly on the recorded topology
(same arithmetic, no search), and its gradients must match both full-tracer
autodiff and finite differences — at O(rays * bounces) cost.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import audiorenderingv2 as ar
from audiorenderingv2 import testing
from audiorenderingv2.core import sampling
from audiorenderingv2.core.tracer import TracerOptions, scene_to_arrays, trace_ir
from audiorenderingv2.diff import inverse, replay


def _setup(n_bands=1, absorption=0.3):
    bv, bt = testing.box_room((8.0, 6.0, 7.0))
    sv, st = testing.icosphere(radius=1.2, center=(1.5, -0.5, 1.0),
                               subdivisions=1)
    v = np.vstack([bv, sv])
    t = np.vstack([bt, st + len(bv)])
    ab = np.concatenate([np.full(len(bt), absorption, np.float32),
                         np.full(len(st), 0.55, np.float32)])
    scene = testing.scene_from_arrays(v, t, ab)
    params = ar.TraceParams(sample_rate=8000, ir_length=2000,
                            base_power=3.62, max_bounces=6,
                            energy_threshold=0.0, hrtf_absorption_rate=0.9,
                            n_bands=n_bands)
    sc = scene_to_arrays(scene, 512)
    dirs = sampling.sample_directions(jax.random.PRNGKey(7), 4096)
    emitter = jnp.array([0.0, 0.0, 0.0], jnp.float32)
    rec = jnp.array([-2.0, 1.0, -1.5], jnp.float32)
    return scene, sc, dirs, emitter, rec, params


@pytest.mark.parametrize("n_bands", [1, 2])
def test_replay_forward_matches_tracer(n_bands):
    _, sc, dirs, emitter, rec, params = _setup(n_bands=n_bands)
    opts = TracerOptions(block_size=2048, tri_chunk=512)
    ir_ref = trace_ir(sc, dirs, emitter, rec, 30.0, params, opts)

    ids, recv = replay.record_paths(sc, dirs, emitter, rec, 30.0, params, opts)
    ir_rep = replay.render_ir_replay(sc, ids, recv, dirs, emitter, rec, 30.0,
                                     params, soft_binning=False)
    # Record and replay are two differently-fused XLA programs: identical
    # arithmetic (exact match) on the CPU mesh; on a GPU an ulp of fusion
    # drift can round a handful of arrival bins, so compare statistically
    # there (assert_ir_close picks the mode from the arrays' device).
    testing.assert_ir_close(ir_rep, ir_ref,
                            rtol=1e-6, atol=1e-12)
    assert np.asarray(ir_rep).sum() > 0


def test_replay_respects_energy_threshold():
    _, sc, dirs, emitter, rec, params = _setup(absorption=0.8)
    # threshold high enough to kill rays after ~2 bounces of 0.8 absorption
    e0 = params.base_power / (dirs.shape[0] * ar.constants.SPHERE_VOLUME)
    import dataclasses
    params = dataclasses.replace(params, energy_threshold=e0 * 0.05)
    opts = TracerOptions(block_size=2048, tri_chunk=512)
    ir_ref = trace_ir(sc, dirs, emitter, rec, 0.0, params, opts)
    ids, recv = replay.record_paths(sc, dirs, emitter, rec, 0.0, params, opts)
    ir_rep = replay.render_ir_replay(sc, ids, recv, dirs, emitter, rec, 0.0,
                                     params, soft_binning=False)
    testing.assert_ir_close(ir_rep, ir_ref, rtol=1e-6, atol=1e-12)


def test_replay_absorption_grad_matches_full_autodiff():
    scene, sc, dirs, emitter, rec, params = _setup()
    opts = TracerOptions(block_size=2048, tri_chunk=512, soft_binning=True,
                         early_exit=False)
    mat_ids = (np.asarray(sc.valid) > 0).astype(np.int32)  # 1 real, 0 pad
    # two-slot material table: slot1 drives every real triangle
    tri_mat = jnp.where(jnp.asarray(sc.valid) > 0, 1, 0)

    def ir_full(a):
        sc2 = sc._replace(absorption=a[tri_mat])
        return trace_ir(sc2, dirs, emitter, rec, 30.0, params, opts)

    ids, recv = replay.record_paths(sc, dirs, emitter, rec, 30.0, params, opts)

    def ir_rep(a):
        sc2 = sc._replace(absorption=a[tri_mat])
        return replay.render_ir_replay(sc2, ids, recv, dirs, emitter, rec,
                                       30.0, params, soft_binning=True)

    a0 = jnp.array([0.0, 0.35], jnp.float32)
    target = jax.lax.stop_gradient(ir_full(a0 + 0.1))
    loss_full = lambda a: jnp.sum((ir_full(a) - target) ** 2) * 1e6
    loss_rep = lambda a: jnp.sum((ir_rep(a) - target) ** 2) * 1e6
    g_full = jax.grad(loss_full)(a0)
    g_rep = jax.grad(loss_rep)(a0)
    np.testing.assert_allclose(np.asarray(g_rep), np.asarray(g_full),
                               rtol=2e-4, atol=1e-12)


def test_replay_emitter_grad_finite_difference():
    _, sc, dirs, emitter, rec, params = _setup()
    opts = TracerOptions(block_size=2048, tri_chunk=512)
    ids, recv = replay.record_paths(sc, dirs, emitter, rec, 0.0, params, opts)
    target = jax.lax.stop_gradient(replay.render_ir_replay(
        sc, ids, recv, dirs, emitter + 0.05, rec, 0.0, params))
    smooth = lambda ir: inverse.smooth_ir(ir, 3)

    def loss(em):
        ir = replay.render_ir_replay(sc, ids, recv, dirs, em, rec, 0.0, params)
        return jnp.sum((smooth(ir) - smooth(target)) ** 2) * 1e9

    g = jax.grad(loss)(emitter)
    eps = 1e-3
    for axis in range(3):
        e = jnp.zeros(3).at[axis].set(eps)
        fd = (loss(emitter + e) - loss(emitter - e)) / (2 * eps)
        np.testing.assert_allclose(np.asarray(g)[axis], float(fd),
                                   rtol=0.08, atol=1e-7)
    # gradient should pull the emitter toward the target offset (+ direction)
    assert float(jnp.sum(g)) < 0.0


def test_record_paths_receiver_counts():
    _, sc, dirs, emitter, rec, params = _setup()
    opts = TracerOptions(block_size=2048, tri_chunk=512)
    ids, recv = replay.record_paths(sc, dirs, emitter, rec, 0.0, params, opts)
    assert ids.shape == (dirs.shape[0], params.max_bounces)
    assert int((recv >= 0).sum()) > 0
    ev_bin, ev_w, ev_ear = replay.replay_events(
        sc, ids, recv, dirs, emitter, rec, 0.0, params)
    got = np.asarray(ev_w).sum(-1) > 0
    assert (got == np.asarray(recv >= 0)).all()


def test_fit_with_replay_recovers_absorption():
    """fit_scene_parameters(method='replay') recovers a uniform absorption —
    the same setup as test_gradients.py's full-autodiff fit, at
    O(rays * bounces) per step instead of O(rays * bounces * triangles)."""
    from audiorenderingv2.diff import fit_scene_parameters, render_soft_ir

    true_a = 0.35
    v, t = testing.box_room((10.0, 8.0, 9.0))
    scene = testing.scene_from_arrays(v, t, true_a)
    params = ar.TraceParams(sample_rate=4000, ir_length=4000, base_power=3.62,
                            max_bounces=4)
    rec = (1.5, 0.5, -2.0)
    opts = TracerOptions(block_size=128, tri_chunk=128)
    target = render_soft_ir(scene, params, n_rays=256, emitter=(0., 0., 0.),
                            receiver_pos=rec, opts=opts, seed=11)
    res = fit_scene_parameters(
        scene, target, params, n_rays=256, steps=60, learning_rate=0.1,
        receiver_pos=rec, seed=11, opts=opts,
        method="replay", replay_refresh=20)
    fitted = res.params["absorption"]
    assert abs(fitted[-1] - true_a) < 0.05
    assert res.losses[-1] < res.losses[0] * 0.05


