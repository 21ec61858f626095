"""Frequency-dependent (banded) absorption: tracer, filterbank, renderer."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import audiorenderingv2 as ar
from audiorenderingv2 import testing
from audiorenderingv2.config import MaterialSpec, parse_config
from audiorenderingv2.core import sampling, tracer_ref
from audiorenderingv2.io import obj as obj_io
from audiorenderingv2.ops import filterbank
from audiorenderingv2.scene import build_scene
from audiorenderingv2.testing import mesh_from_arrays

SR = 8000
BANDS = 4


def banded_scene(absorption_rows):
    """Box room with per-band absorption [n_bands] on every face."""
    v, t = testing.box_room((10.0, 8.0, 9.0))
    tri_abs = np.tile(np.asarray(absorption_rows, np.float32), (len(t), 1))
    return build_scene(mesh_from_arrays(v, t), tri_abs)


def test_banded_ir_shape_and_band_ordering():
    scene = banded_scene([0.1, 0.3, 0.5, 0.7])
    sc = ar.scene_to_arrays(scene, 128)
    params = ar.TraceParams(sample_rate=SR, ir_length=SR, base_power=3.62,
                            max_bounces=6, n_bands=BANDS)
    opts = ar.TracerOptions(block_size=256, tri_chunk=128)
    dirs = sampling.sample_directions(jax.random.PRNGKey(0), 512)
    ir = np.asarray(ar.trace_ir(sc, dirs, jnp.zeros(3),
                                jnp.array([2.0, 0.0, 1.0]), 0.0, params, opts))
    assert ir.shape == (2, BANDS, SR)
    # lower absorption bands must carry at least as much energy
    band_energy = ir.sum(axis=(0, 2))
    assert (np.diff(band_energy) <= 1e-9).all()
    assert band_energy[0] > band_energy[3] > 0


def test_banded_matches_oracle():
    scene = banded_scene([0.1, 0.4, 0.6, 0.9])
    sc = ar.scene_to_arrays(scene, 128)
    params = ar.TraceParams(sample_rate=SR, ir_length=SR, base_power=3.62,
                            max_bounces=8, n_bands=BANDS)
    opts = ar.TracerOptions(block_size=128, tri_chunk=128)
    dirs = np.asarray(sampling.sample_directions(jax.random.PRNGKey(2), 256))
    ir_ref = tracer_ref.trace_ir_reference(
        scene, dirs, np.zeros(3), np.array([1.0, 1.0, -2.0]), 25.0, params)
    ir_jax = np.asarray(ar.trace_ir(sc, jnp.asarray(dirs), jnp.zeros(3),
                                    jnp.array([1.0, 1.0, -2.0]), 25.0,
                                    params, opts))
    assert ir_ref.shape == (2, BANDS, SR)
    np.testing.assert_allclose(ir_jax, ir_ref, rtol=2e-3, atol=1e-8)


def test_uniform_bands_match_broadband():
    """Identical absorption in every band == the broadband render."""
    a = 0.35
    banded = banded_scene([a] * BANDS)
    v, t = testing.box_room((10.0, 8.0, 9.0))
    broadband = testing.scene_from_arrays(v, t, a)
    dirs = sampling.sample_directions(jax.random.PRNGKey(1), 256)
    opts = ar.TracerOptions(block_size=128, tri_chunk=128)
    p_banded = ar.TraceParams(sample_rate=SR, ir_length=SR, base_power=3.62,
                              max_bounces=6, n_bands=BANDS)
    p_broad = ar.TraceParams(sample_rate=SR, ir_length=SR, base_power=3.62,
                             max_bounces=6)
    ir_b = np.asarray(ar.trace_ir(ar.scene_to_arrays(banded, 128), dirs,
                                  jnp.zeros(3), jnp.array([2.0, 0.0, 1.0]),
                                  0.0, p_banded, opts))
    ir_s = np.asarray(ar.trace_ir(ar.scene_to_arrays(broadband, 128), dirs,
                                  jnp.zeros(3), jnp.array([2.0, 0.0, 1.0]),
                                  0.0, p_broad, opts))
    for b in range(BANDS):
        np.testing.assert_allclose(ir_b[:, b], ir_s, rtol=1e-5, atol=1e-8)


def test_filterbank_reconstructs():
    rng = np.random.default_rng(0)
    x = rng.normal(size=4096).astype(np.float32)
    bands = np.asarray(filterbank.split_bands(jnp.asarray(x), SR))
    assert bands.shape == (BANDS, 4096)
    np.testing.assert_allclose(bands.sum(axis=0), x, rtol=1e-4, atol=1e-4)


def test_banded_convolution_uniform_ir_matches_broadband():
    from audiorenderingv2.ops import convolve

    rng = np.random.default_rng(1)
    x = rng.normal(size=3 * SR).astype(np.float32)
    ir = np.zeros((2, SR), np.float32)
    ir[0, [0, 100]] = [1.0, 0.5]
    ir[1, [3, 50]] = [0.7, -0.2]
    ir_banded = np.repeat(ir[:, None, :], BANDS, axis=1)
    got = np.asarray(filterbank.convolve_file_banded(
        jnp.asarray(x), jnp.asarray(ir_banded), SR))
    want = np.asarray(convolve.convolve_file_stereo(jnp.asarray(x),
                                                    jnp.asarray(ir), SR))
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


def test_config_banded_materials():
    cfg = parse_config({"pathtracer_parameters": {
        "absorption_band_edges": [300.0, 1200.0, 5000.0],
        "materials": [
            {"name": "wall", "mat_absorption": [0.1, 0.2, 0.4, 0.8]},
            {"name": "floor", "mat_absorption": 0.5},
        ]}})
    assert cfg.pathtracer.n_bands == 4
    assert cfg.pathtracer.absorption_band_edges == (300.0, 1200.0, 5000.0)
    per = obj_io.resolve_absorption(["wall", "floor", "other"],
                                    cfg.pathtracer.materials)
    assert per.shape == (4, 4)
    np.testing.assert_allclose(per[0], [0.1, 0.2, 0.4, 0.8])
    np.testing.assert_allclose(per[1], 0.5)  # scalar broadcasts
    np.testing.assert_allclose(per[2], 0.5)  # unmatched -> default
    with pytest.raises(ValueError):
        obj_io.resolve_absorption(["x"], [
            MaterialSpec("a", (0.1, 0.2)), MaterialSpec("b", (0.1, 0.2, 0.3))])


def test_banded_renderer_end_to_end():
    from audiorenderingv2.renderer import AudioRenderer

    v, t = testing.box_room((10.0, 8.0, 9.0))
    tri_abs = np.tile(np.array([0.1, 0.3, 0.6, 0.9], np.float32), (len(t), 1))
    scene = build_scene(mesh_from_arrays(v, t), tri_abs)
    r = AudioRenderer(scene, ir_seconds=1, sample_rate=SR, n_rays=512,
                      base_power=3.62, max_bounces=6,
                      opts=ar.TracerOptions(block_size=256, tri_chunk=128))
    r.set_receiver(np.array([2.0, 0.0, 1.0]), 0.0)
    ir = r.render()
    assert ir.shape == (2, 4, SR)
    sig = np.random.default_rng(2).normal(size=2 * SR).astype(np.float32)
    out = r.convolve_audio_file(sig)
    assert out.shape == (2, 2 * SR)
    assert np.isfinite(out).all()
    assert (out != 0).any()


