"""Sequence parallelism for the convolution engine (the SP analog).

The reference's long dimensions are ray count and signal/IR length
(SURVEY §5); its convolution walks 1-second segments on one GPU
(kernels.cu:414-430). This package shards the OTHER long axis: the
overlap-add SEGMENT axis of the file convolution, so arbitrarily long
signals convolve across a device mesh:

  * each device holds a contiguous run of 1-second segments and runs the
    same batched rfft -> multiply -> irfft as the single-device engine
    (ops/convolve.py),
  * overlap-add is local except for the tail: a segment's circular result
    is ``k = ir_len/sr`` seconds long, so the last ``k-1`` seconds of each
    shard's accumulation spill into the NEXT shard's span — one
    ``jax.lax.ppermute`` halo exchange (neighbor traffic, no
    all-to-all) adds the spill where it belongs,
  * the final device's spill is past the signal's end and is dropped,
    exactly like the single-device truncation (kernels.cu:417, 425).

Numerical parity with ``convolve_file`` is exact up to f32 addition order
(the same per-segment products are summed in the same positions), pinned
by tests/test_ir_sharding.py on the 8-device CPU mesh.

This is deliberately NOT ring attention: the reduction is a fixed-width
halo (k-1 seconds), so one neighbor permute replaces any ring/all-gather
structure — cheaper than the general sequence-parallel machinery.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.convolve import _ola_segments
from .sharding import shard_map

SEG_AXIS = "segments"


def make_segment_mesh(devices=None) -> Mesh:
    """A 1-D mesh over all (or the given) devices with the segment axis."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    return Mesh(devices.reshape(-1), (SEG_AXIS,))


def convolve_file_sharded(samples: jax.Array, ir_stereo: jax.Array,
                          sample_rate: int,
                          mesh: Mesh | None = None) -> jax.Array:
    """Overlap-add convolution with the segment axis sharded over a mesh.

    Args:
      samples: float [L] mono signal (whole seconds are processed, output
        truncated to L — the reference's contract).
      ir_stereo: float [2, ir_length]; ir_length a whole number of seconds.
      mesh: 1-D device mesh (default: all devices). The segment count is
        padded to a multiple of the device count with silent segments.

    Returns float32 [2, L] — matches ``convolve_file_stereo`` up to f32
    summation order.
    """
    mesh = mesh or make_segment_mesh()
    n_dev = mesh.devices.size
    samples = jnp.asarray(samples, jnp.float32)
    ir_stereo = jnp.asarray(ir_stereo, jnp.float32)
    length = samples.shape[0]
    ir_length = ir_stereo.shape[-1]
    if ir_length % sample_rate != 0:
        raise ValueError("ir_length must be a multiple of sample_rate")
    k = ir_length // sample_rate

    segs = _ola_segments(samples, sample_rate, ir_length)  # [S, ir_length]
    s = segs.shape[0]
    if s == 0:
        return jnp.zeros((2, length), jnp.float32)
    # Pad with silent segments until the LAST REAL segment's k-1-second
    # spill fits inside allocated output spans: the only halo that wraps
    # (last shard -> shard 0) then originates from silent segments and is
    # exactly zero, so dropping it at the wrap edge loses nothing. Without
    # this, an exactly-divisible segment count would drop the real spill
    # into a partial trailing second that the single-device engine keeps
    # (kernels.cu:417 writes up to the input length).
    s_pad = -(-(s + k - 1) // n_dev) * n_dev
    if s_pad != s:
        segs = jnp.pad(segs, ((0, s_pad - s), (0, 0)))  # silent segments
    local_s = s_pad // n_dev

    @functools.partial(
        shard_map, mesh=mesh, check_vma=False,
        in_specs=(P(SEG_AXIS), P()),
        out_specs=P(None, SEG_AXIS),  # [2, time]: the TIME axis is sharded
    )
    def sharded(segs_, ir_):
        # [local_s, ir_length] x [2, ir_length] -> per-ear circular results
        spec = jnp.fft.rfft(segs_, axis=-1)[None] * \
            jnp.fft.rfft(ir_, axis=-1)[:, None, :]
        y = jnp.fft.irfft(spec, n=ir_length, axis=-1)  # [2, local_s, irl]
        # Local overlap-add over this shard's span plus a k-1 second halo:
        # segment j starts at j*sr within [0, (local_s + k - 1) * sr).
        yk = y.reshape(2, local_s, k, sample_rate)
        total = jnp.zeros((2, local_s + k - 1, sample_rate), jnp.float32)
        for m in range(k):
            total = total.at[:, m:m + local_s].add(yk[:, :, m, :])
        own = total[:, :local_s]          # this shard's output seconds
        halo = total[:, local_s:]         # spills into FOLLOWING shards
        # Forward neighbor permutes carry the halo along the mesh. A halo
        # is k-1 seconds, so it reaches ceil((k-1)/local_s) neighbors; on
        # each hop a shard adds the first local_s incoming seconds to its
        # span and forwards the remainder. The wrap edge (last -> first)
        # is dropped each hop: that energy lies past the signal's end (the
        # single-device truncation, kernels.cu:425), not at its start.
        fwd = [(i, (i + 1) % n_dev) for i in range(n_dev)]
        idx = jax.lax.axis_index(SEG_AXIS)
        hops = -(-(k - 1) // local_s) if k > 1 else 0
        carry = halo
        for h in range(hops):
            carry = jax.lax.ppermute(carry, SEG_AXIS, perm=fwd)
            carry = jnp.where(idx <= h, 0.0, carry)
            take = min(local_s, carry.shape[1])
            own = own.at[:, :take].add(carry[:, :take])
            carry = carry[:, take:]
            if carry.shape[1] == 0:
                break
        return own.reshape(2, local_s * sample_rate)

    out = sharded(segs, ir_stereo)  # [2, s_pad * sr]
    out = out.reshape(2, -1)[:, :length]
    if out.shape[1] < length:
        out = jnp.pad(out, ((0, 0), (0, length - out.shape[1])))
    # Net factor 2 = cuFFT's unnormalized scale / the /(ir_len/2) divide
    # (ops/convolve.py parity note).
    return out * 2.0
