"""Parity on the GPU (marker ``gpu``; skipped where JAX sees no GPU).

Run on a machine with a card:

    JAX_PLATFORMS=cuda,cpu python -m pytest tests -m gpu

Guards what CPU tests cannot see: a default-precision contraction running
in TF32, and the ordering freedom of atomic adds. At depth the tracer is
chaotic, so IR comparisons use testing.assert_ir_close's statistical mode,
which it picks for arrays on the GPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import audiorenderingv2 as ar
from audiorenderingv2 import testing
from audiorenderingv2.core import binning, sampling, tracer_ref
from audiorenderingv2.parallel import make_ray_mesh, trace_directions_sharded

pytestmark = pytest.mark.gpu

EMITTER = (0.0, 0.0, 0.0)
RECEIVER = (2.5, 1.9, 0.0)


def _box():
    v, t = testing.box_room((14.0, 9.0, 11.0))
    return testing.scene_from_arrays(v, t, 0.3)


def _params(max_bounces):
    return ar.TraceParams(sample_rate=16000, ir_length=32000,
                          base_power=3.62, max_bounces=max_bounces,
                          hrtf_absorption_rate=0.9)


def _trace(sc, dirs, params):
    return jax.jit(lambda s, d: ar.trace_ir(
        s, d, jnp.asarray(EMITTER), jnp.asarray(RECEIVER), 0.0, params))(
            sc, dirs)


def test_tracer_matches_oracle_on_gpu(gpu_device):
    scene = _box()
    params = _params(10)
    dirs = jax.device_put(
        sampling.sample_directions(jax.random.PRNGKey(0), 4096), gpu_device)
    sc = jax.device_put(ar.scene_to_arrays(scene, 2048), gpu_device)
    got = _trace(sc, dirs, params)
    assert testing.on_accelerator(got)
    ref = tracer_ref.trace_ir_reference(
        scene, np.asarray(dirs), np.asarray(EMITTER), np.asarray(RECEIVER),
        0.0, params)
    testing.assert_ir_close(got, ref, rtol=2e-3, atol=1e-9)


def test_gpu_matches_cpu_at_100_bounces(gpu_device):
    params = _params(100)
    sc = ar.scene_to_arrays(_box(), 2048)
    dirs = sampling.sample_directions(jax.random.PRNGKey(1), 65536)
    cpu = jax.devices("cpu")[0]
    on_gpu = _trace(jax.device_put(sc, gpu_device),
                    jax.device_put(dirs, gpu_device), params)
    on_cpu = _trace(jax.device_put(sc, cpu), jax.device_put(dirs, cpu),
                    params)
    testing.assert_ir_close(on_gpu, on_cpu)


@pytest.mark.parametrize("n_bands", [1, 4])
def test_scatter_add_histogram_on_gpu(gpu_device, n_bands):
    rng = np.random.default_rng(3)
    n_bins = 2 * 64000
    bins = np.minimum(rng.exponential(n_bins / 4, 1_000_000),
                      n_bins + 99).astype(np.int32)
    w = (np.exp(-bins[:, None] / 20000.0)
         * rng.uniform(0.5, 1.0, (bins.size, n_bands)) * 1e-6)
    w = w.astype(np.float32)
    got = np.asarray(jax.jit(
        lambda b, x: binning.histogram_sum_banded(b, x, n_bins))(
            jax.device_put(bins, gpu_device), jax.device_put(w, gpu_device)))
    keep = bins < n_bins
    ref = np.stack([np.bincount(bins[keep], w[keep, k].astype(np.float64),
                                minlength=n_bins) for k in range(n_bands)],
                   axis=1)
    occ = ref > 0
    assert (got[occ] != 0).all()
    np.testing.assert_allclose(got[occ], ref[occ], rtol=1e-5)


def test_sharded_trace_matches_one_gpu(gpu_device):
    gpus = jax.devices("gpu")
    mesh = make_ray_mesh(gpus)
    params = _params(20)
    sc = jax.device_put(ar.scene_to_arrays(_box(), 2048), gpu_device)
    dirs = jax.device_put(sampling.sample_directions(
        jax.random.PRNGKey(3), 8192 * len(gpus)), gpu_device)
    sharded = trace_directions_sharded(
        sc, dirs, jnp.asarray(EMITTER), jnp.asarray(RECEIVER), 0.0, params,
        mesh=mesh)
    testing.assert_ir_close(sharded, _trace(sc, dirs, params))
