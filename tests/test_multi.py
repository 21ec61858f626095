"""Multi-source / multi-listener rendering tests."""
import jax
import jax.numpy as jnp
import numpy as np

import audiorenderingv2 as ar
from audiorenderingv2 import multi, testing
from audiorenderingv2.core import sampling

SR = 8000


def setup():
    v, t = testing.box_room((12.0, 9.0, 10.0))
    scene = testing.scene_from_arrays(v, t, 0.3)
    sc = ar.scene_to_arrays(scene, 128)
    params = ar.TraceParams(sample_rate=SR, ir_length=SR, base_power=3.62,
                            max_bounces=5)
    opts = ar.TracerOptions(block_size=256, tri_chunk=128)
    return sc, params, opts


def test_matrix_shape_and_single_pair_parity():
    sc, params, opts = setup()
    key = jax.random.PRNGKey(0)
    emitters = np.array([[0.0, 0.0, 0.0], [2.0, 1.0, -1.0]])
    receivers = np.array([[3.0, 0.0, 1.0], [-2.0, -1.0, 2.0], [0.0, 2.0, -3.0]])
    yaws = np.array([0.0, 45.0, -90.0])
    irs = multi.render_ir_matrix(sc, key, emitters, receivers, yaws, 512,
                                 params, opts)
    assert irs.shape == (2, 3, 2, SR)
    assert np.isfinite(irs).all()
    assert irs.sum() > 0
    # pair (1, 2) reproduces a direct single render with the same key fold
    k = jax.random.fold_in(key, 1 * 3 + 2)
    dirs = sampling.sample_directions(k, 512)
    single = np.asarray(ar.trace_ir(sc, dirs, jnp.asarray(emitters[1]),
                                    jnp.asarray(receivers[2]), -90.0,
                                    params, opts))
    np.testing.assert_allclose(irs[1, 2], single, rtol=1e-4, atol=1e-8)
    # pair_batch=1 (per-pair async dispatch, no vmap) gives the same matrix
    irs1 = multi.render_ir_matrix(sc, key, emitters, receivers, yaws, 512,
                                  params, opts, pair_batch=1)
    # two program structures -> f32 summation-order drift on an
    # accelerator; exact on CPU.
    # Flatten to per-(source, listener, ear) rows so the statistical
    # mode's energy check binds at that granularity, not per source.
    testing.assert_ir_close(irs1.reshape(-1, irs1.shape[-1]),
                            irs.reshape(-1, irs.shape[-1]),
                            rtol=1e-5, atol=1e-9)


def test_matrix_sharded_batches_pairs():
    """mesh branch: pairs ride inside the sharded dispatch (vmap outside
    shard_map) and match per-pair render_ir_sharded calls exactly."""
    from audiorenderingv2.parallel import sharding

    sc, params, opts = setup()
    mesh = sharding.make_ray_mesh()
    key = jax.random.PRNGKey(3)
    emitters = np.array([[0.0, 0.0, 0.0], [2.0, 1.0, -1.0]])
    receivers = np.array([[3.0, 0.0, 1.0], [-2.0, -1.0, 2.0]])
    yaws = np.array([0.0, 30.0])
    n_rays = 64 * mesh.devices.size
    irs = multi.render_ir_matrix(sc, key, emitters, receivers, yaws, n_rays,
                                 params, opts, mesh=mesh, pair_batch=3)
    assert irs.shape == (2, 2, 2, SR)
    for si in range(2):
        for li in range(2):
            k = jax.random.fold_in(key, si * 2 + li)
            single = np.asarray(sharding.render_ir_sharded(
                sc, k, n_rays, jnp.asarray(emitters[si], jnp.float32),
                jnp.asarray(receivers[li], jnp.float32),
                jnp.float32(yaws[li]), params, opts, mesh=mesh))
            np.testing.assert_allclose(irs[si, li], single, rtol=1e-4,
                                       atol=1e-8)


def test_mix_is_linear():
    sc, params, opts = setup()
    key = jax.random.PRNGKey(1)
    emitters = np.array([[0.0, 0.0, 0.0], [2.0, 1.0, -1.0]])
    receivers = np.array([[3.0, 0.0, 1.0]])
    irs = multi.render_ir_matrix(sc, key, emitters, receivers, [10.0], 256,
                                 params, opts)
    rng = np.random.default_rng(0)
    sig_a = rng.normal(size=2 * SR).astype(np.float32)
    sig_b = rng.normal(size=SR).astype(np.float32)
    mixed = multi.mix_sources(irs, [sig_a, sig_b], SR)
    only_a = multi.mix_sources(irs[:1], [sig_a], SR)
    only_b = multi.mix_sources(irs[1:], [sig_b], SR)
    padded_b = np.zeros_like(only_a)
    padded_b[..., : only_b.shape[-1]] = only_b
    np.testing.assert_allclose(mixed, only_a + padded_b, rtol=1e-4, atol=1e-6)


def test_banded_matrix_fallback_and_mix_shapes():
    """Every render_ir_matrix path returns the banded [S, L, 2, n_bands,
    ir_length] shape, and mix_sources auralizes it via the filterbank
    (r5 contract fix — the fallback paths used to crash on banded)."""
    from audiorenderingv2 import testing

    v, t = testing.box_room((6.0, 4.0, 5.0))
    absorb = np.tile(np.array([[0.1, 0.3, 0.5, 0.7]], np.float32),
                     (t.shape[0], 1))
    scene = testing.scene_from_arrays(v, t, absorb)
    sc = ar.scene_to_arrays(scene, 128)
    params = ar.TraceParams(sample_rate=SR, ir_length=SR, base_power=3.62,
                            max_bounces=4, n_bands=4)
    xopts = ar.TracerOptions(backend="xla", block_size=512, tri_chunk=128)
    key = jax.random.PRNGKey(9)
    emitters = np.array([[0.5, 0.2, -0.3]], np.float32)
    receivers = np.array([[1.5, 0.0, 1.0], [-1.0, -0.5, 0.8]], np.float32)
    yaws = np.array([0.0, 30.0], np.float32)
    # vmapped fallback (xla backend -> fused_ok False)
    m = multi.render_ir_matrix(sc, key, emitters, receivers, yaws, 256,
                               params, xopts, pair_batch=2)
    assert m.shape == (1, 2, 2, 4, SR)
    # per-pair path
    m1 = multi.render_ir_matrix(sc, key, emitters, receivers, yaws, 256,
                                params, xopts, pair_batch=1)
    assert m1.shape == (1, 2, 2, 4, SR)
    # two program structures -> f32 summation-order drift on an accelerator
    np.testing.assert_allclose(m, m1, rtol=1e-4, atol=1e-7)
    # banded mix
    sig = np.random.default_rng(0).standard_normal(SR // 2).astype(np.float32)
    out = multi.mix_sources(m, [sig], SR)
    assert out.shape == (2, 2, SR // 2)
    assert np.isfinite(out).all()
