"""FFT convolution engine (auralization).

Replaces the reference's cuFFT kernels (kernels.cu:345-536) with batched
``jnp.fft`` (cuFFT under XLA on the GPU):

* ``convolve_file`` — the reference's overlap-add scheme
  (convoluteFromAudioBuffer, kernels.cu:382-438, algorithm credit
  dspguide.com/ch18): the signal is cut into 1-second segments, each
  zero-padded to ir_length, circularly convolved with the IR at FFT size
  ir_length, and overlap-added. All segments are batched into ONE rfft /
  multiply / irfft instead of a host-side per-second loop with device syncs.
  Numerical parity notes:
    - cuFFT's unnormalized R2C+C2R round trip scales by ir_length and the
      reference then divides by (ir_length/2) (AudioRenderer.cpp:707-710);
      with normalized jnp.fft this is a net factor of 2, applied here.
    - segments are ir_length long but carry sample_rate real samples, so each
      segment's circular convolution time-aliases its last second exactly as
      the reference's does; parity preserved by construction.
    - only floor(len/sr) whole seconds are processed and the output is
      truncated to the input length (kernels.cu:417, 425).

* ``convolve_live`` — the live-input path (convoluteFromLiveInput,
  kernels.cu:345-377): one circular convolution at length ir_length plus the
  same /(ir_length/2) normalization (AudioRenderer.cpp:649).

* ``convolve_linear`` — a proper linear (non-aliasing) convolution, offered
  as the quality-correct mode the reference lacks.

All functions are differentiable (FFT is linear), so audio-domain losses
backpropagate to the IR and through it to scene parameters.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def _ola_segments(samples: jax.Array, sample_rate: int, ir_length: int):
    """Cut the signal into zero-padded 1 s segments [S, ir_length]."""
    n_seconds = samples.shape[0] // sample_rate
    segs = samples[: n_seconds * sample_rate].reshape(n_seconds, sample_rate)
    return jnp.pad(segs, ((0, 0), (0, ir_length - sample_rate)))


def convolve_file(samples: jax.Array, ir: jax.Array, sample_rate: int) -> jax.Array:
    """Overlap-add convolution of ``samples`` [L] with one IR [ir_length].

    Returns float32 [L] (the reference's output buffer has the input's
    length). ``ir_length`` must be a whole number of seconds of samples.
    """
    samples = jnp.asarray(samples, jnp.float32)
    ir = jnp.asarray(ir, jnp.float32)
    length = samples.shape[0]
    ir_length = ir.shape[0]
    if ir_length % sample_rate != 0:
        raise ValueError("ir_length must be a multiple of sample_rate")
    k = ir_length // sample_rate

    segs = _ola_segments(samples, sample_rate, ir_length)
    n_seconds = segs.shape[0]
    y = jnp.fft.irfft(jnp.fft.rfft(segs, axis=-1) * jnp.fft.rfft(ir)[None, :],
                      n=ir_length, axis=-1)

    # Overlap-add: segment s starts at s*sample_rate. Each result is k
    # seconds long; accumulate the k diagonals with static shifted adds.
    yk = y.reshape(n_seconds, k, sample_rate)
    total = jnp.zeros((n_seconds + k - 1, sample_rate), jnp.float32)
    for m in range(k):
        total = total.at[m : m + n_seconds].add(yk[:, m, :])
    out = total.reshape(-1)
    out = out[:length] if out.shape[0] >= length else jnp.pad(out, (0, length - out.shape[0]))
    # Net factor 2 = cuFFT's unnormalized ir_length scale / the reference's
    # (ir_length/2) divide.
    return out * 2.0


@functools.partial(jax.jit, static_argnames=("sample_rate",))
def convolve_file_stereo(samples: jax.Array, ir_stereo: jax.Array,
                         sample_rate: int) -> jax.Array:
    """Both ears in one vmapped call. ir_stereo [2, ir_length] -> [2, L].

    Jitted (cached per shape): the interactive loop re-convolves the whole
    signal on every listener move, and eager op-by-op dispatch made that
    ~30x slower than the compiled graph.
    """
    return jax.vmap(lambda ir: convolve_file(samples, ir, sample_rate))(ir_stereo)


@functools.partial(jax.jit, static_argnames=("double_precision",))
def convolve_live(block: jax.Array, ir_stereo: jax.Array,
                  double_precision: bool = False) -> jax.Array:
    """Live-input block convolution (kernels.cu:345-377).

    ``block`` [ir_length] — the current input frames zero-padded to
    ir_length (AudioRenderer.cpp:599-607). Returns [2, ir_length] with the
    reference's /(ir_length/2) normalization. The streaming layer interleaves
    the two ears and accumulates the overlap tail in the ring buffer.

    The reference's live path is double precision end-to-end (D2Z/Z2D,
    kernels.cu:345-377; FLOAT64 stream, main.cpp:151). The default here is
    float32 (documented divergence, docs/PARITY.md): f64 FFTs run far below
    the f32 rate on the GPU and the ~1e-7 relative error is below audio
    quantization.
    ``double_precision=True`` restores the reference's f64 FFT — it needs
    ``jax.config.update("jax_enable_x64", True)`` to take effect and is
    meant for the CPU/live path. Output dtype is always float32 (the
    stream format conversion the reference does at the RtAudio boundary).
    """
    if double_precision and not jax.config.jax_enable_x64:
        import warnings

        warnings.warn(
            "convolve_live(double_precision=True) needs "
            'jax.config.update("jax_enable_x64", True); running in float32 '
            "instead (the f64 request cannot take effect)", stacklevel=2)
    dtype = (jnp.float64 if double_precision and jax.config.jax_enable_x64
             else jnp.float32)
    block = jnp.asarray(block, dtype)
    ir_stereo = jnp.asarray(ir_stereo, dtype)
    ir_length = block.shape[0]
    spec = jnp.fft.rfft(block)[None, :] * jnp.fft.rfft(ir_stereo, axis=-1)
    out = jnp.fft.irfft(spec, n=ir_length, axis=-1) * 2.0
    return out.astype(jnp.float32)


def interleave_stereo(left: jax.Array, right: jax.Array) -> jax.Array:
    """[n],[n] -> [2n] interleaved LRLR (zipArrays, kernels.cu:469-487)."""
    return jnp.stack([left, right], axis=-1).reshape(-1)


@functools.partial(jax.jit, static_argnames=("out_length",))
def convolve_linear(samples: jax.Array, ir: jax.Array,
                    out_length: int | None = None) -> jax.Array:
    """True linear convolution via one zero-padded FFT (no time aliasing).

    The quality-correct alternative to the reference's segment-circular
    scheme. Returns length ``out_length`` (default L + ir_length - 1).
    """
    samples = jnp.asarray(samples, jnp.float32)
    ir = jnp.asarray(ir, jnp.float32)
    full = samples.shape[0] + ir.shape[0] - 1
    nfft = 1 << (full - 1).bit_length()
    y = jnp.fft.irfft(jnp.fft.rfft(samples, n=nfft) * jnp.fft.rfft(ir, n=nfft),
                      n=nfft)[:full]
    if out_length is not None:
        y = y[:out_length] if full >= out_length else jnp.pad(y, (0, out_length - full))
    return y
