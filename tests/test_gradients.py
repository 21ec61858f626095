"""Gradient correctness: autodiff through the tracer vs finite differences,
and the end-to-end inverse-rendering fit (BASELINE config #4)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import audiorenderingv2 as ar
from audiorenderingv2 import testing
from audiorenderingv2.core import sampling
from audiorenderingv2.diff import (fit_scene_parameters, ir_loss,
                                       material_ids_padded, render_soft_ir,
                                       with_material_absorption)

SR = 8000


def diff_opts():
    return ar.TracerOptions(block_size=128, tri_chunk=128,
                            early_exit=False, soft_binning=True)


def make_setup(absorption=0.3, max_bounces=5, n_rays=128):
    v, t = testing.box_room((10.0, 8.0, 9.0))
    scene = testing.scene_from_arrays(v, t, absorption)
    params = ar.TraceParams(sample_rate=SR, ir_length=SR, base_power=3.62,
                            max_bounces=max_bounces)
    dirs = sampling.sample_directions(jax.random.PRNGKey(2), n_rays)
    rec = jnp.array([1.5, 0.5, -2.0])
    return scene, params, dirs, rec


def test_absorption_gradient_matches_finite_difference():
    scene, params, dirs, rec = make_setup()
    sc = ar.scene_to_arrays(scene, 128)
    target = jnp.zeros((2, SR))

    def loss(a):
        sc_a = sc._replace(absorption=jnp.full_like(sc.absorption, a))
        ir = ar.trace_ir(sc_a, dirs, jnp.zeros(3), rec, 10.0, params, diff_opts())
        return jnp.sum(ir ** 2)

    a0 = 0.3
    g = float(jax.grad(loss)(jnp.float32(a0)))
    eps = 1e-3
    fd = (float(loss(jnp.float32(a0 + eps))) - float(loss(jnp.float32(a0 - eps)))) / (2 * eps)
    assert g == pytest.approx(fd, rel=5e-2)


def test_pose_gradient_matches_finite_difference():
    """Receiver position gradient through soft binning + chord."""
    scene, params, dirs, _ = make_setup()
    sc = ar.scene_to_arrays(scene, 128)

    def loss(x):
        rec = jnp.array([x, 0.5, -2.0])
        ir = ar.trace_ir(sc, dirs, jnp.zeros(3), rec, 0.0, params, diff_opts())
        # weighted arrival time: smooth functional of delays and energies
        w = jnp.arange(SR, dtype=jnp.float32)
        return jnp.sum(ir * w[None, :]) / (jnp.sum(ir) + 1e-9)

    x0 = 1.5
    g = float(jax.grad(loss)(jnp.float32(x0)))
    eps = 3e-3
    fd = (float(loss(jnp.float32(x0 + eps))) - float(loss(jnp.float32(x0 - eps)))) / (2 * eps)
    assert g == pytest.approx(fd, rel=1e-1, abs=1e-3)


def test_emitter_gradient_exists_and_finite():
    scene, params, dirs, rec = make_setup()
    sc = ar.scene_to_arrays(scene, 128)

    def loss(em):
        ir = ar.trace_ir(sc, dirs, em, rec, 0.0, params, diff_opts())
        return jnp.sum(ir ** 2)

    g = np.asarray(jax.grad(loss)(jnp.array([0.1, 0.2, -0.1])))
    assert np.isfinite(g).all()
    assert np.abs(g).sum() > 0


def test_geometry_gradient_exists():
    """Gradients flow to the precomputed geometry arrays (plane rows)."""
    scene, params, dirs, rec = make_setup()
    sc = ar.scene_to_arrays(scene, 128)

    def loss(plane_n):
        ir = ar.trace_ir(sc._replace(plane_n=plane_n), dirs, jnp.zeros(3), rec,
                         0.0, params, diff_opts())
        return jnp.sum(ir ** 2)

    g = np.asarray(jax.grad(loss)(sc.plane_n))
    assert np.isfinite(g).all()
    assert np.abs(g).sum() > 0


def test_inverse_fit_recovers_absorption():
    """Fit a uniform absorption from a target IR rendered at a=0.35,
    starting the optimizer at 0.5 — common random numbers, so the fit can
    in principle reach the target exactly."""
    true_a = 0.35
    v, t = testing.box_room((10.0, 8.0, 9.0))
    scene = testing.scene_from_arrays(v, t, true_a)
    params = ar.TraceParams(sample_rate=SR, ir_length=SR, base_power=3.62,
                            max_bounces=4)
    rec = (1.5, 0.5, -2.0)
    target = render_soft_ir(scene, params, n_rays=256, emitter=(0., 0., 0.),
                            receiver_pos=rec,
                            opts=ar.TracerOptions(block_size=128, tri_chunk=128),
                            seed=11)
    res = fit_scene_parameters(
        scene, target, params, n_rays=256, steps=60, learning_rate=0.1,
        receiver_pos=rec, seed=11,
        opts=ar.TracerOptions(block_size=128, tri_chunk=128))
    fitted = res.params["absorption"]
    # material slot -1 (the only one used: scene has no named materials)
    assert fitted[-1] == pytest.approx(true_a, abs=0.05)
    assert res.losses[-1] < res.losses[0] * 0.05


def test_inverse_fit_recovers_banded_absorption():
    """Frequency-dependent inverse: recover per-band absorption [0.2, 0.6]."""
    import numpy as _np

    from audiorenderingv2.scene import build_scene
    from audiorenderingv2.testing import mesh_from_arrays

    true_bands = _np.array([0.2, 0.6], _np.float32)
    v, t = testing.box_room((10.0, 8.0, 9.0))
    scene = build_scene(mesh_from_arrays(v, t),
                        _np.tile(true_bands, (len(t), 1)))
    params = ar.TraceParams(sample_rate=SR, ir_length=SR, base_power=3.62,
                            max_bounces=4, n_bands=2)
    rec = (1.5, 0.5, -2.0)
    opts = ar.TracerOptions(block_size=128, tri_chunk=128)
    target = render_soft_ir(scene, params, n_rays=256, emitter=(0., 0., 0.),
                            receiver_pos=rec, opts=opts, seed=13)
    assert target.shape == (2, 2, SR)
    res = fit_scene_parameters(
        scene, target, params, n_rays=256, steps=80, learning_rate=0.1,
        receiver_pos=rec, seed=13, opts=opts)
    fitted = res.params["absorption"][-1]  # the no-material slot, [2]
    np.testing.assert_allclose(fitted, true_bands, atol=0.06)
    assert res.losses[-1] < res.losses[0] * 0.05
