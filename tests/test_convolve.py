"""Convolution engine tests: parity with a direct numpy port of the
reference algorithm, plus analytic cases."""
import numpy as np
import jax.numpy as jnp

from audiorenderingv2.ops import convolve


def numpy_reference_ola(samples, ir, sr):
    """Direct per-second loop port of convoluteFromAudioBuffer
    (kernels.cu:382-438) including its circular aliasing and the
    /(ir_len/2) normalization of the unnormalized FFT round trip."""
    n = len(ir)
    out = np.zeros(len(samples), np.float64)
    irf = np.fft.rfft(ir, n)
    for second in range(len(samples) // sr):
        seg = np.zeros(n)
        seg[:sr] = samples[second * sr : (second + 1) * sr]
        y = np.fft.irfft(np.fft.rfft(seg) * irf, n) * n  # unnormalized C2R
        take = min(n, len(samples) - second * sr)
        out[second * sr : second * sr + take] += y[:take]
    return out / (n // 2)


def test_matches_reference_algorithm():
    rng = np.random.default_rng(0)
    sr = 400
    samples = rng.normal(size=3 * sr + 123).astype(np.float32)  # partial tail
    ir = np.zeros(2 * sr, np.float32)
    ir[[0, 37, 100, 790]] = [1.0, 0.5, -0.25, 0.125]
    got = np.asarray(convolve.convolve_file(jnp.asarray(samples), jnp.asarray(ir), sr))
    want = numpy_reference_ola(samples, ir, sr)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_impulse_ir_scales_by_two():
    """IR = delta at 0 => output is 2x the input (the reference's net scale)."""
    sr = 100
    samples = np.sin(np.linspace(0, 20, 2 * sr)).astype(np.float32)
    ir = np.zeros(sr, np.float32)
    ir[0] = 1.0
    out = np.asarray(convolve.convolve_file(jnp.asarray(samples), jnp.asarray(ir), sr))
    np.testing.assert_allclose(out, 2.0 * samples, rtol=1e-4, atol=1e-5)


def test_delayed_impulse():
    sr = 100
    samples = np.zeros(3 * sr, np.float32)
    samples[10] = 1.0
    ir = np.zeros(2 * sr, np.float32)
    ir[30] = 1.0
    out = np.asarray(convolve.convolve_file(jnp.asarray(samples), jnp.asarray(ir), sr))
    expect = np.zeros(3 * sr)
    expect[40] = 2.0
    np.testing.assert_allclose(out, expect, atol=1e-5)


def test_stereo_vmap():
    sr = 100
    samples = np.random.default_rng(1).normal(size=2 * sr).astype(np.float32)
    ir = np.zeros((2, sr), np.float32)
    ir[0, 0] = 1.0
    ir[1, 3] = 0.5
    out = np.asarray(convolve.convolve_file_stereo(jnp.asarray(samples), jnp.asarray(ir), sr))
    assert out.shape == (2, 2 * sr)
    l0 = np.asarray(convolve.convolve_file(jnp.asarray(samples), jnp.asarray(ir[0]), sr))
    np.testing.assert_allclose(out[0], l0, rtol=1e-5, atol=1e-6)


def test_live_circular():
    """Live path: circular convolution at ir_length with the x2 net scale
    (convoluteFromLiveInput kernels.cu:345-377 + normalizeBuffers)."""
    n = 64
    rng = np.random.default_rng(2)
    block = rng.normal(size=n).astype(np.float32)
    ir = np.zeros((2, n), np.float32)
    ir[0, 5] = 1.0
    ir[1, 0] = 0.25
    out = np.asarray(convolve.convolve_live(jnp.asarray(block), jnp.asarray(ir)))
    np.testing.assert_allclose(out[0], 2.0 * np.roll(block, 5), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(out[1], 0.5 * block, rtol=1e-4, atol=1e-5)


def test_live_double_precision_flag():
    """double_precision=True reproduces the reference's f64 live FFT
    (kernels.cu:345-377) when x64 is enabled; without x64 it degrades
    gracefully to the f32 result. Output dtype is float32 either way."""
    n = 128
    rng = np.random.default_rng(7)
    block = rng.normal(size=n).astype(np.float32)
    ir = rng.normal(size=(2, n)).astype(np.float32) * 0.1
    f32 = np.asarray(convolve.convolve_live(jnp.asarray(block),
                                            jnp.asarray(ir)))
    f64 = np.asarray(convolve.convolve_live(jnp.asarray(block),
                                            jnp.asarray(ir),
                                            double_precision=True))
    assert f64.dtype == np.float32
    # The two precisions agree to f32 roundoff regardless of x64 state.
    np.testing.assert_allclose(f64, f32, rtol=1e-5, atol=1e-6)


def test_interleave():
    out = np.asarray(convolve.interleave_stereo(jnp.array([1.0, 2.0]), jnp.array([3.0, 4.0])))
    np.testing.assert_array_equal(out, [1.0, 3.0, 2.0, 4.0])


def test_linear_convolution_no_alias():
    rng = np.random.default_rng(3)
    x = rng.normal(size=257).astype(np.float32)
    h = rng.normal(size=63).astype(np.float32)
    got = np.asarray(convolve.convolve_linear(jnp.asarray(x), jnp.asarray(h)))
    want = np.convolve(x, h)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)
