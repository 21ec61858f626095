"""Segment-axis (sequence-parallel) convolution on the 8-device CPU mesh.

Parity bar: convolve_file_sharded must equal the single-device overlap-add
engine up to f32 summation order, across halo widths (k = ir seconds) that
fit within one neighbor hop and ones that chain across several shards.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from audiorenderingv2.ops import convolve
from audiorenderingv2.parallel.ir_sharding import (
    convolve_file_sharded, make_segment_mesh)

SR = 4000


def _signal(seconds, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=int(seconds * SR)).astype(np.float32) * 0.3


def _ir(k_seconds, seed=1):
    rng = np.random.default_rng(seed)
    ir = rng.normal(size=(2, k_seconds * SR)).astype(np.float32)
    return ir * np.exp(-np.linspace(0, 6, k_seconds * SR))[None, :]


@pytest.mark.parametrize("sig_seconds,k", [
    (16, 2),   # segment count divisible by 8: the wrap edge must still
               # deliver the last real segment's spill (r4 review finding)
    (16, 4),   # 3-second halo chaining across spans
    (9, 2),    # segment count not divisible by 8 -> silent padding
    (8, 3),    # local_s small: halo chains across two shards
    (16.5, 2),  # partial trailing second: reverb tail inside the input
               # length is kept (kernels.cu:417 contract)
])
def test_sharded_matches_single_device(sig_seconds, k):
    sig = _signal(sig_seconds)
    ir = _ir(k)
    mesh = make_segment_mesh()
    assert mesh.devices.size == 8
    want = np.asarray(convolve.convolve_file_stereo(
        jnp.asarray(sig), jnp.asarray(ir), SR))
    got = np.asarray(convolve_file_sharded(sig, ir, SR, mesh=mesh))
    assert got.shape == want.shape == (2, sig.shape[0])
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-6)
    assert np.abs(got).max() > 0


def test_short_signal_and_truncation():
    # 1.5 s signal: one whole segment processed, output truncated/padded
    sig = _signal(1.5)
    ir = _ir(2)
    got = np.asarray(convolve_file_sharded(sig, ir, SR))
    want = np.asarray(convolve.convolve_file_stereo(
        jnp.asarray(sig), jnp.asarray(ir), SR))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-6)


def test_bad_ir_length_raises():
    with pytest.raises(ValueError):
        convolve_file_sharded(_signal(4), np.zeros((2, SR + 7), np.float32),
                              SR)
