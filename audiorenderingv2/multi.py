"""Multi-source / multi-listener rendering.

The reference supports exactly one emitter and one receiver per run
(LaunchParams.h:20-43). Production auralization wants S sources x L
listeners; here this is one more batch axis:

  * :func:`render_ir_matrix` renders the [S, L] IR matrix with ONE compiled
    trace reused across pairs (pose is a traced argument, so no recompiles),
    optionally sharding each render's rays over the device mesh,
  * :func:`mix_sources` auralizes per listener: each source's dry signal is
    convolved with its IR to that listener and the results sum — linearity
    of the wave equation, same normalization as the single-source path.

Listeners are independent (a listener does not shadow another listener's
arrivals), matching how the reference would behave run L separate times.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .core import sampling
from .core.tracer import SceneArrays, TracerOptions, trace_ir
from .core.tracer_ref import TraceParams
from .ops import convolve
from .parallel.sharding import render_ir_sharded


def render_ir_matrix(
    sc: SceneArrays,
    key: jax.Array,
    emitters: np.ndarray,
    receivers: np.ndarray,
    receiver_yaws_deg: np.ndarray,
    n_rays: int,
    params: TraceParams,
    opts: TracerOptions = TracerOptions(),
    mesh=None,
    pair_batch: int = 16,
) -> np.ndarray:
    """Render IRs for every (source, listener) pair.

    Args:
      emitters: [S, 3]; receivers: [L, 3]; receiver_yaws_deg: [L].
      n_rays: rays per pair render.
      mesh: optional device mesh — each pair's rays shard across it.
      pair_batch: pairs rendered per dispatch (vmap over the pose axis —
        ONE kernel evaluates the whole batch instead of one host round-trip
        per pair). Bounds peak memory at pair_batch * n_rays ray states;
        0 = all S*L pairs at once.

    Returns float32 [S, L, 2, ir_length] — or [S, L, 2, n_bands,
    ir_length] for banded scenes (params.n_bands > 1), every path.
    """
    if pair_batch is not None and pair_batch < 0:
        raise ValueError(f"pair_batch must be >= 0 (0 = all pairs at "
                         f"once), got {pair_batch}")
    emitters = np.atleast_2d(np.asarray(emitters, np.float32))
    receivers = np.atleast_2d(np.asarray(receivers, np.float32))
    # Broadcast a scalar yaw to every listener; mismatched lengths are an
    # error (a short yaw list would otherwise silently zero listener rows).
    yaws = np.broadcast_to(np.asarray(receiver_yaws_deg, np.float32),
                           (receivers.shape[0],))
    s, l = len(emitters), len(receivers)
    n_pairs = s * l

    if mesh is not None:
        # Sharded renders split each pair's rays over the mesh AND batch the
        # pair axis in the same dispatch: vmap outside shard_map, so one
        # device-wide kernel evaluates pair_batch poses per host round-trip
        # instead of one dispatch + sync per pair.
        @jax.jit
        def many(ks, ems, rcs, yws):
            def one(k, em, rc, yw):
                return render_ir_sharded(sc, k, n_rays, em, rc, yw, params,
                                         opts, mesh=mesh)

            return jax.vmap(one)(ks, ems, rcs, yws)
    else:
        @jax.jit
        def one_pair(k, em, rc, yw):
            dirs = sampling.sample_directions(k, n_rays,
                                              rng_impl=opts.rng_impl)
            return trace_ir(sc, dirs, em, rc, yw, params, opts)

        @jax.jit
        def many(ks, ems, rcs, yws):
            def one(k, em, rc, yw):
                dirs = sampling.sample_directions(k, n_rays,
                                                  rng_impl=opts.rng_impl)
                return trace_ir(sc, dirs, em, rc, yw, params, opts)

            return jax.vmap(one)(ks, ems, rcs, yws)

    # Flat pair arrays; chunked vmap with the tail chunk padded to the
    # batch size so every dispatch reuses the one compiled executable.
    em_p = jnp.asarray(np.repeat(emitters, l, axis=0))
    rc_p = jnp.asarray(np.tile(receivers, (s, 1)))
    yw_p = jnp.asarray(np.tile(yaws, s))
    keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(
        jnp.arange(n_pairs, dtype=jnp.uint32))

    if mesh is None and pair_batch == 1:
        # Per-pair async dispatch of the plain single-pose program: one
        # render's memory at a time. The vmapped batch below is the default.
        results = [one_pair(keys[i], em_p[i], rc_p[i], yw_p[i])
                   for i in range(n_pairs)]
        flat = np.stack([np.asarray(x) for x in results])
        return flat.reshape((s, l) + flat.shape[1:])
    batch = n_pairs if pair_batch in (0, None) else min(pair_batch, n_pairs)
    chunks = []
    for start in range(0, n_pairs, batch):
        idx = jnp.arange(start, start + batch) % n_pairs  # pad by wrapping
        chunks.append(np.asarray(many(keys[idx], em_p[idx], rc_p[idx],
                                      yw_p[idx])))
    flat = np.concatenate(chunks)[:n_pairs]
    return flat.reshape((s, l) + flat.shape[1:])


def mix_sources(
    ir_matrix: np.ndarray,
    signals: list[np.ndarray],
    sample_rate: int,
    band_edges: tuple = (250.0, 1000.0, 4000.0),
) -> np.ndarray:
    """Auralize S sources at L listeners.

    Args:
      ir_matrix: [S, L, 2, ir_length] from :func:`render_ir_matrix` —
        or its banded form [S, L, 2, n_bands, ir_length], auralized
        through the filterbank with ``band_edges``.
      signals: S mono dry signals (may have different lengths; zero-padded
        to the longest).
    Returns float32 [L, 2, max_len] — per-listener stereo mixes.
    """
    s, l = ir_matrix.shape[:2]
    if len(signals) != s:
        raise ValueError(f"{s} sources but {len(signals)} signals")
    max_len = max(sig.shape[0] for sig in signals)
    out = np.zeros((l, 2, max_len), np.float32)
    # One dispatch per source: all L listener convolutions vmapped.
    if ir_matrix.ndim == 5:
        from .ops import filterbank

        convolve_l = jax.jit(
            jax.vmap(filterbank.convolve_file_banded,
                     in_axes=(None, 0, None, None)),
            static_argnums=(2, 3))
        extra = (tuple(band_edges),)
    else:
        convolve_l = jax.jit(
            jax.vmap(convolve.convolve_file_stereo, in_axes=(None, 0, None)),
            static_argnums=2)
        extra = ()
    for si, sig in enumerate(signals):
        padded = np.zeros(max_len, np.float32)
        padded[: sig.shape[0]] = sig
        out += np.asarray(convolve_l(jnp.asarray(padded),
                                     jnp.asarray(ir_matrix[si]), sample_rate,
                                     *extra))
    return out
