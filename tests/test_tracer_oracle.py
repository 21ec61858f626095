"""XLA tracer vs the float64 numpy oracle across scenes, receivers, chunking,
ray padding, degenerate faces and absorption bands.

On the CPU both sides run deterministic arithmetic, so every case is a
per-bin comparison (``testing.assert_ir_close`` picks the exact mode for
host arrays).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import audiorenderingv2 as ar
from audiorenderingv2 import testing
from audiorenderingv2.core import sampling, tracer_ref
from audiorenderingv2.scene import build_scene

SR = 16000

SCENES = {
    "box": lambda: testing.box_room((12.0, 8.0, 10.0)),
    "sphere": lambda: testing.icosphere(radius=6.0, subdivisions=2),
    "room_with_obstacle": lambda: _room_with_obstacle(),
}
RECEIVERS = [([2.0, 0.0, 1.0], 25.0), ([1.5, 0.5, -1.0], -60.0),
             ([-2.5, -1.0, 2.0], 180.0)]


def _room_with_obstacle():
    bv, bt = testing.box_room((10.0, 9.0, 8.0))
    sv, st = testing.icosphere(radius=1.2, center=(2.5, 0.0, -1.0),
                               subdivisions=1)
    return np.vstack([bv, sv]), np.vstack([bt, st + len(bv)])


def _params(**kw):
    d = dict(sample_rate=SR, ir_length=SR, base_power=3.62, max_bounces=6,
             hrtf_absorption_rate=0.9)
    d.update(kw)
    return ar.TraceParams(**d)


def _dirs(seed, n):
    return np.asarray(sampling.sample_directions(jax.random.PRNGKey(seed), n))


def _xla(scene, dirs, rec, yaw, params, tri_chunk=128, block_size=256):
    sc = ar.scene_to_arrays(scene, tri_chunk)
    return np.asarray(ar.trace_ir(
        sc, jnp.asarray(dirs, jnp.float32), jnp.zeros(3),
        jnp.asarray(rec, jnp.float32), yaw, params,
        ar.TracerOptions(block_size=block_size, tri_chunk=tri_chunk)))


def _both(scene, dirs, rec, yaw, params, **kw):
    ref = tracer_ref.trace_ir_reference(scene, dirs, np.zeros(3),
                                        np.asarray(rec), yaw, params)
    return _xla(scene, dirs, rec, yaw, params, **kw), ref


@pytest.mark.parametrize("rec,yaw", RECEIVERS)
@pytest.mark.parametrize("scene_name", sorted(SCENES))
def test_scene_receiver_grid(scene_name, rec, yaw):
    v, t = SCENES[scene_name]()
    scene = testing.scene_from_arrays(v, t, 0.3)
    got, ref = _both(scene, _dirs(4, 256), rec, yaw, _params())
    assert ref.sum() > 0
    # atol: a ray grazing the receiver sphere deposits energy times a short
    # chord (t2 - t1), which f32 resolves to ~4e-3 relative against the
    # float64 oracle; deposits here are ~1e-5 to 1e-3.
    testing.assert_ir_close(got, ref, rtol=2e-3, atol=1e-6)


@pytest.mark.parametrize("tri_chunk", [128, 256, 512])
def test_multichunk_triangles(tri_chunk):
    """320 triangles over 1-3 chunks: the chunk scan keeps the nearest hit
    across chunk boundaries."""
    v, t = testing.icosphere(radius=5.0, subdivisions=2)
    scene = testing.scene_from_arrays(v, t, 0.15)
    got, ref = _both(scene, _dirs(8, 128), [2.0, 0.0, 0.0], 0.0,
                     _params(max_bounces=5), tri_chunk=tri_chunk)
    assert ref.sum() > 0
    testing.assert_ir_close(got, ref, rtol=2e-3, atol=1e-8)


@pytest.mark.parametrize("n_rays", [100, 129, 300])
def test_ray_padding(n_rays):
    """Ray counts that do not fill whole blocks: the padded rays deposit
    nothing and the energy normalization uses the real count."""
    v, t = testing.box_room((10.0, 9.0, 8.0))
    scene = testing.scene_from_arrays(v, t, 0.25)
    got, ref = _both(scene, _dirs(10, n_rays), [1.0, 0.0, 0.0], 0.0,
                     _params(max_bounces=4), block_size=128)
    assert ref.sum() > 0
    testing.assert_ir_close(got, ref, rtol=2e-3, atol=1e-8)


def test_interior_degenerate_triangle_keeps_tail_geometry():
    """A zero-area face in the middle of the triangle list is marked invalid
    without hiding the real triangles after it."""
    v, t = testing.box_room((4.0, 3.0, 5.0))  # 12 tris
    v = np.concatenate([v, np.zeros((3, 3), np.float32)])
    n = v.shape[0]
    t = np.concatenate([t[:6], [[n - 3, n - 2, n - 1]], t[6:]]).astype(
        np.int32)
    scene = testing.scene_from_arrays(v, t, 0.3)
    valid = np.asarray(ar.scene_to_arrays(scene, 128).valid)
    assert valid[6] == 0.0 and valid[12] == 1.0  # interior hole, real tail
    got, ref = _both(scene, _dirs(2, 256), [1.0, 0.5, -0.5], 0.0,
                     _params())
    assert ref.sum() > 0
    testing.assert_ir_close(got, ref, rtol=2e-3, atol=1e-8)


@pytest.mark.parametrize("n_bands", [1, 2, 8])
def test_bands_match_oracle(n_bands):
    v, t = testing.box_room((12.0, 8.0, 10.0))
    absorb = np.linspace(0.1, 0.8, n_bands, dtype=np.float32)
    tri_abs = (np.tile(absorb, (len(t), 1)) if n_bands > 1
               else np.full(len(t), absorb[0], np.float32))
    scene = build_scene(testing.mesh_from_arrays(v, t), tri_abs)
    got, ref = _both(scene, _dirs(7, 256), [2.0, 0.0, 1.0], 15.0,
                     _params(n_bands=n_bands))
    expect_shape = (2, SR) if n_bands == 1 else (2, n_bands, SR)
    assert got.shape == ref.shape == expect_shape
    assert ref.sum() > 0
    testing.assert_ir_close(got, ref, rtol=2e-3, atol=1e-8)
    if n_bands > 1:  # more absorbing bands carry less energy
        assert (np.diff(got.sum(axis=(0, 2))) < 0).all()


@pytest.mark.parametrize("block_size", [64, 256, 1024])
def test_block_size_invariance(block_size):
    """How rays are grouped into lax.map blocks changes no deposit."""
    v, t = testing.box_room((12.0, 8.0, 10.0))
    scene = testing.scene_from_arrays(v, t, 0.3)
    dirs = _dirs(12, 1024)
    got = _xla(scene, dirs, [2.0, 0.0, 1.0], 25.0, _params(),
               block_size=block_size)
    base = _xla(scene, dirs, [2.0, 0.0, 1.0], 25.0, _params(),
                block_size=1024)
    assert base.sum() > 0
    np.testing.assert_allclose(got, base, rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("make", [np.asarray, jnp.asarray],
                         ids=["numpy", "jax_cpu"])
def test_on_accelerator_false_for_host_and_cpu_arrays(make):
    assert not testing.on_accelerator(make(np.ones(4, np.float32)))


def test_assert_ir_close_is_exact_for_cpu_arrays():
    """CPU arrays get the per-bin comparison: one deposit moved by a bin
    passes the statistical bars but fails here."""
    a = np.zeros((2, 1000), np.float32)
    a[:, 10:1000] = 1.0
    b = a.copy()
    b[0, 10], b[0, 9] = 0.0, 1.0
    testing.assert_ir_close(a, b, exact=False)  # energy equal, L1 ~1e-3
    with pytest.raises(AssertionError):
        testing.assert_ir_close(jnp.asarray(a), jnp.asarray(b))
