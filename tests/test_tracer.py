"""Tracer physics unit tests (deterministic rays) and oracle parity.

The analytic cases pin down each semantic inherited from the reference
device code (devicePrograms.cu:62-254); the parity tests cross-check the
vectorized JAX tracer against the independent numpy oracle on procedural
scenes and (when present) reference assets.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import audiorenderingv2 as ar
from audiorenderingv2 import constants, testing
from audiorenderingv2.core import sampling, tracer, tracer_ref

REF = "/root/reference"
SR = 16000


def small_opts(**kw):
    d = dict(block_size=256, tri_chunk=128)
    d.update(kw)
    return ar.TracerOptions(**d)


def run_both(scene, dirs, emitter, rec, yaw, params, **opts_kw):
    ir_ref = tracer_ref.trace_ir_reference(scene, dirs, emitter, rec, yaw, params)
    sc = ar.scene_to_arrays(scene, 128)
    ir_jax = np.asarray(ar.trace_ir(
        sc, jnp.asarray(dirs, jnp.float32), jnp.asarray(emitter, jnp.float32),
        jnp.asarray(rec, jnp.float32), yaw, params, small_opts(**opts_kw)))
    return ir_ref, ir_jax


def empty_scene():
    # a far-away quad so the scene has >=1 real triangle
    v, t = testing.quad([0.0, -500.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0])
    return testing.scene_from_arrays(v, t, 0.5)


def ray(*d):
    d = np.asarray(d, np.float64)
    return (d / np.linalg.norm(d))[None, :]


def base_params(**kw):
    d = dict(sample_rate=SR, ir_length=2 * SR, base_power=float(constants.SPHERE_VOLUME),
             max_bounces=8, hrtf_absorption_rate=0.9)
    d.update(kw)
    return ar.TraceParams(**d)


class TestDirectPath:
    def test_direct_hit_bin_energy_and_ear(self):
        params = base_params()
        scene = empty_scene()
        emitter = np.zeros(3)
        rec = np.array([5.0, 0.0, 0.0])
        # yaw=90 deg: looking along +z; head-local z of the hit point
        # (4,0,0)-(5,0,0) = (-1,0,0) is -sin(90)*-1 = +1 -> right ear
        ir_ref, ir_jax = run_both(scene, ray(1, 0, 0), emitter, rec, 90.0, params)
        for ir in (ir_ref, ir_jax):
            b = round(4.0 / 343.0 * SR)
            # energy = base_power/(1*V) * chord(=2, through center)
            assert ir[1, b] == pytest.approx(2.0, rel=1e-5)
            # cross-ear deposit: bin+int(16000*0.00044)=bin+7, x(1-0.9)
            assert ir[0, b + 7] == pytest.approx(0.2, rel=1e-4)
            assert np.sum(ir != 0) == 2

    def test_opposite_yaw_flips_ear(self):
        params = base_params()
        ir_ref, ir_jax = run_both(empty_scene(), ray(1, 0, 0), np.zeros(3),
                                  np.array([5.0, 0.0, 0.0]), -90.0, params)
        b = round(4.0 / 343.0 * SR)
        for ir in (ir_ref, ir_jax):
            assert ir[0, b] == pytest.approx(2.0, rel=1e-5)
            assert ir[1, b + 7] == pytest.approx(0.2, rel=1e-4)

    def test_chord_scaling_off_center(self):
        params = base_params()
        # ray passes 0.6 above center: chord = 2*sqrt(1-0.36) = 1.6
        rec = np.array([5.0, -0.6, 0.0])
        ir_ref, ir_jax = run_both(empty_scene(), ray(1, 0, 0), np.zeros(3), rec, 90.0, params)
        for ir in (ir_ref, ir_jax):
            assert ir.sum() == pytest.approx(1.6 * 1.1, rel=1e-4)  # same + 0.1 cross

    def test_mono_skips_cross_ear(self):
        params = base_params(is_mono=True)
        ir_ref, ir_jax = run_both(empty_scene(), ray(1, 0, 0), np.zeros(3),
                                  np.array([5.0, 0.0, 0.0]), 90.0, params)
        for ir in (ir_ref, ir_jax):
            assert np.sum(ir != 0) == 1


class TestBounce:
    def test_single_reflection_absorption_and_delay(self):
        params = base_params()
        # wall at x=10 (absorption 0.3), receiver behind the emitter
        v, t = testing.quad([10.0, 0.0, 0.0], [0.0, 50.0, 0.0], [0.0, 0.0, 50.0])
        scene = testing.scene_from_arrays(v, t, 0.3)
        rec = np.array([-5.0, 0.0, 0.0])
        ir_ref, ir_jax = run_both(scene, ray(1, 0, 0), np.zeros(3), rec, -90.0, params)
        # path: 10 out + (14 - eps) back to sphere entry at x=-4
        dist = 10.0 + 14.0 - constants.BOUNCE_EPSILON
        b = round(dist / 343.0 * SR)
        for ir in (ir_ref, ir_jax):
            total_same = 0.7 * 2.0  # (1-absorption) * chord
            assert ir[:, b].max() == pytest.approx(total_same, rel=1e-4)

    def test_max_bounces_kills(self):
        params = base_params(max_bounces=1)
        # two parallel walls; ray needs 2 bounces to reach receiver -> nothing
        v1, t1 = testing.quad([10.0, 0.0, 0.0], [0.0, 50.0, 0.0], [0.0, 0.0, 50.0])
        v2, t2 = testing.quad([-10.0, 0.0, 0.0], [0.0, 50.0, 0.0], [0.0, 0.0, 50.0])
        v = np.vstack([v1, v2])
        t = np.vstack([t1, t2 + 4])
        scene = testing.scene_from_arrays(v, t, 0.0)
        rec = np.array([0.0, 5.0, 0.0])  # off the ray's axis entirely
        ir_ref, ir_jax = run_both(scene, ray(1, 0, 0), np.zeros(3), rec, 0.0, params)
        assert ir_ref.sum() == 0
        assert ir_jax.sum() == 0

    def test_energy_threshold_kills(self):
        params = base_params(energy_threshold=0.9)
        v, t = testing.quad([10.0, 0.0, 0.0], [0.0, 50.0, 0.0], [0.0, 0.0, 50.0])
        scene = testing.scene_from_arrays(v, t, 0.5)  # energy 1 -> 0.5 < 0.9
        rec = np.array([-5.0, 0.0, 0.0])
        ir_ref, ir_jax = run_both(scene, ray(1, 0, 0), np.zeros(3), rec, 0.0, params)
        assert ir_ref.sum() == 0
        assert ir_jax.sum() == 0

    def test_distance_threshold_kills(self):
        # 1 s IR: distance cap 343+1; a 400 m path deposits nothing
        params = base_params(ir_length=SR)
        scene = empty_scene()
        rec = np.array([400.0, 0.0, 0.0])
        ir_ref, ir_jax = run_both(scene, ray(1, 0, 0), np.zeros(3), rec, 0.0, params)
        # first leg: condition dist<344 holds at start, the hit itself is
        # beyond the IR -> bin out of range, dropped
        assert ir_ref.sum() == 0
        assert ir_jax.sum() == 0

    def test_miss_kills(self):
        params = base_params()
        ir_ref, ir_jax = run_both(empty_scene(), ray(0, 1, 0), np.zeros(3),
                                  np.array([5.0, 0.0, 0.0]), 0.0, params)
        assert ir_ref.sum() == 0
        assert ir_jax.sum() == 0


class TestOracleParity:
    @pytest.mark.parametrize("n_rays,max_bounces", [(256, 4), (512, 16)])
    def test_box_room(self, n_rays, max_bounces):
        v, t = testing.box_room((12.0, 8.0, 10.0))
        scene = testing.scene_from_arrays(v, t, 0.3)
        params = base_params(max_bounces=max_bounces, base_power=3.62)
        dirs = np.asarray(sampling.sample_directions(jax.random.PRNGKey(7), n_rays))
        emitter = np.array([2.0, 1.0, -1.5])
        rec = np.array([-3.0, -1.0, 2.0])
        ir_ref, ir_jax = run_both(scene, dirs, emitter, rec, 33.0, params)
        assert ir_ref.sum() > 0
        np.testing.assert_allclose(ir_jax, ir_ref, rtol=2e-3, atol=1e-8)

    def test_icosphere_interior(self):
        v, t = testing.icosphere(radius=6.0, subdivisions=2)
        scene = testing.scene_from_arrays(v, t, 0.1)
        params = base_params(max_bounces=12, base_power=3.62)
        dirs = np.asarray(sampling.sample_directions(jax.random.PRNGKey(3), 256))
        ir_ref, ir_jax = run_both(scene, dirs, np.zeros(3),
                                  np.array([2.0, 0.5, -1.0]), -45.0, params)
        assert ir_ref.sum() > 0
        # exact vs the numpy oracle on CPU; statistical on an accelerator,
        # where XLA fusion drift at 12 bounces can move a lone deposit
        testing.assert_ir_close(ir_jax, ir_ref, rtol=2e-3, atol=1e-8)

    def test_scan_mode_matches_while_mode(self):
        v, t = testing.box_room((12.0, 8.0, 10.0))
        scene = testing.scene_from_arrays(v, t, 0.3)
        params = base_params(max_bounces=6)
        dirs = np.asarray(sampling.sample_directions(jax.random.PRNGKey(9), 256))
        sc = ar.scene_to_arrays(scene, 128)
        a = ar.trace_ir(sc, jnp.asarray(dirs), jnp.zeros(3), jnp.array([1.0, 0.0, 2.0]),
                        10.0, params, small_opts(early_exit=True))
        b = ar.trace_ir(sc, jnp.asarray(dirs), jnp.zeros(3), jnp.array([1.0, 0.0, 2.0]),
                        10.0, params, small_opts(early_exit=False))
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6, atol=0)

    @pytest.mark.skipif(not os.path.exists(REF), reason="reference assets absent")
    def test_reference_sphere_scene(self):
        scene = ar.load_scene(f"{REF}/sphere.obj", [])
        params = base_params(max_bounces=4, base_power=3.62, ir_length=SR)
        dirs = np.asarray(sampling.sample_directions(jax.random.PRNGKey(0), 384))
        ir_ref, ir_jax = run_both(scene, dirs, np.zeros(3),
                                  np.array([0.3, 0.0, 0.0]), 30.0, params)
        assert ir_ref.sum() > 0
        np.testing.assert_allclose(ir_jax, ir_ref, rtol=2e-3, atol=1e-8)

    def test_energy_conservation_bound(self):
        """Total deposited energy can't exceed rays*e0*max_chord(=2)."""
        v, t = testing.box_room((10.0, 10.0, 10.0))
        scene = testing.scene_from_arrays(v, t, 0.2)
        params = base_params(base_power=float(constants.SPHERE_VOLUME))
        n = 512
        dirs = np.asarray(sampling.sample_directions(jax.random.PRNGKey(11), n))
        sc = ar.scene_to_arrays(scene, 128)
        ir = np.asarray(ar.trace_ir(sc, jnp.asarray(dirs), jnp.zeros(3),
                                    jnp.array([3.0, 0.0, 0.0]), 0.0, params,
                                    small_opts()))
        # e0 = 1/n per ray; same-ear <= 2/n each; cross adds 10%
        assert ir.sum() <= 2.0 * 1.1 + 1e-6


class TestRngImpl:
    """rng_impl="rbg": the fast XLA RngBitGenerator direction stream
    (TracerOptions.rng_impl / sampling.sample_directions). The
    reference's curand stream was clock64-seeded and irreproducible
    (devicePrograms.cu:216-224); both impls here are deterministic."""

    def test_rbg_unit_and_deterministic(self):
        k = jax.random.PRNGKey(5)
        a = np.asarray(sampling.sample_directions(k, 4096, rng_impl="rbg"))
        b = np.asarray(sampling.sample_directions(k, 4096, rng_impl="rbg"))
        np.testing.assert_array_equal(a, b)  # same key -> same stream
        np.testing.assert_allclose(np.linalg.norm(a, axis=1), 1.0, rtol=1e-5)
        t = np.asarray(sampling.sample_directions(k, 4096))
        assert not np.array_equal(a, t)  # distinct stream from threefry
        # uniform on the sphere: component means vanish at ~1/sqrt(n)
        assert np.abs(a.mean(axis=0)).max() < 0.05

    def test_render_ir_rbg_statistical_parity(self):
        """Different stream, same distribution: total IR energy matches the
        threefry render to Monte-Carlo noise."""
        v, t = testing.box_room((12.0, 8.0, 10.0))
        scene = testing.scene_from_arrays(v, t, 0.3)
        sc = ar.scene_to_arrays(scene, 128)
        params = base_params(max_bounces=12, base_power=3.62)
        args = (jnp.zeros(3), jnp.array([2.0, 0.0, 1.0]), jnp.float32(0.0))
        n = 32768
        sums = {}
        for impl in ("threefry", "rbg"):
            opts = ar.TracerOptions(block_size=n, tri_chunk=128,
                                    rng_impl=impl)
            ir = np.asarray(tracer.render_ir(sc, jax.random.PRNGKey(2), n,
                                             *args, params, opts))
            assert (ir != 0).sum() > 50
            sums[impl] = ir.sum()
        np.testing.assert_allclose(sums["rbg"], sums["threefry"], rtol=0.05)


@pytest.mark.parametrize("backend", ["pallas", "triton", "mosaic_gpu", ""])
def test_unknown_backend_raises(backend):
    """The XLA tracer is the only backend; any other name is refused when
    the options are built, not silently traced with XLA."""
    with pytest.raises(ValueError, match="only backend is 'xla'"):
        ar.TracerOptions(backend=backend)


def test_default_options_are_the_xla_tracer():
    opts = ar.TracerOptions()
    assert opts.backend == "xla"
    assert not hasattr(opts, "rays_per_tile")
    assert not [f for f in vars(opts) if f.startswith("pallas")]
