"""IR histogram accumulation by scatter-add.

The reference resolves write conflicts on the IR arrays with device-wide
``atomicAdd`` (devicePrograms.cu:135-166). ``x.at[bins].add(w)`` is the same
operation in XLA: on the GPU it lowers to atomic adds into the histogram, on
the CPU to a serial loop. Every deposit is added directly into its bin, so a
small late deposit is never swamped by a large running sum.

Events with bin < 0 or bin >= n_bins go to one spare row past the end, which
is dropped — the reference's ``array_pos < ir_length`` guard
(devicePrograms.cu:133). The transpose of a scatter-add is a gather, so
d(hist)/d(weights) exists without a custom rule; with soft binning (see
``core/tracer._slot_bins``) d(hist)/d(arrival delay) does too.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def histogram_sum(bins: jax.Array, weights: jax.Array, n_bins: int) -> jax.Array:
    """Sum ``weights`` into ``n_bins`` buckets keyed by int32 ``bins``.

    bins/weights may have any (equal) shape; they are flattened. Entries with
    bin < 0 or bin >= n_bins are dropped. Returns float32 [n_bins].
    """
    return histogram_sum_banded(bins.reshape(-1), weights.reshape(-1, 1),
                                n_bins)[:, 0]


def histogram_sum_banded(bins: jax.Array, weights: jax.Array,
                         n_bins: int) -> jax.Array:
    """Like :func:`histogram_sum` but weights carry a trailing band axis.

    bins: int [E]; weights: [E, n_bands]. Returns float32 [n_bins, n_bands].
    """
    bins = bins.reshape(-1)
    if bins.shape[0] != weights.shape[0]:
        # A scatter with mismatched operands would fail deep inside XLA (or,
        # under a gather-style transpose, clamp silently); name it here.
        raise ValueError(f"{bins.shape[0]} bins but {weights.shape[0]} "
                         f"weight rows")
    n_bands = weights.shape[-1]
    spare = jnp.where((bins < 0) | (bins >= n_bins), n_bins,
                      bins).astype(jnp.int32)
    with jax.named_scope("ir_histogram"):  # profiler attribution
        hist = jnp.zeros((n_bins + 1, n_bands), jnp.float32)
        return hist.at[spare].add(weights.astype(jnp.float32))[:n_bins]
