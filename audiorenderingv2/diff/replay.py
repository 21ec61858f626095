"""Path-replay differentiation: gradients at full ray scale.

The reference has no gradients at all; the XLA tracer (core/tracer.py)
differentiates by back-propagating through the complete nearest-triangle
search of every bounce — O(rays * bounces * triangles) work and activation
memory, fine for demo-scale fits but hopeless at the 1M-ray production
workload (devicePrograms.cu's launch grid, config.json:27-31).

Path topology, however, is a *discrete* quantity: which triangle a ray hits
never has a useful local derivative (SURVEY §7 "differentiating through
discrete events"). Everything the BASELINE gradients need — absorption,
emitter/receiver pose, surface geometry — only flows through the *continuous*
quantities measured along a FIXED path: plane-intersection distances, energy
attenuation products, and the receiver-sphere crossing. So:

  1. ``record_paths``  — run the fast forward tracer once, keeping only the
     per-bounce winning triangle index and the step at which the receiver
     was reached: int32 [N, K] + [N], O(N*K) memory, no f32 activations.
  2. ``replay_events`` — recompute the ray walk along the recorded topology:
     each bounce is one gather + a plane intersection (no search), fully
     differentiable; the same physics as the tracer (reflect, absorb,
     1e-3 offset, chord-scaled deposit, head-frame ear).
  3. ``render_ir_replay`` — replay -> (soft or hard) IR histogram; feed to
     any loss and ``jax.grad`` straight through.

Topology is refreshed between optimization steps whenever parameters moved
far enough to change hit/miss decisions (the caller's choice — see
diff/inverse.py's grid+refine loop for the same idea applied to pose).

Replay forward == tracer forward exactly (same arithmetic on the same
path), tested in tests/test_replay.py; gradients are checked against the
full-tracer autodiff and finite differences.

MAINTENANCE INVARIANT: the bounce physics (alive predicate, receiver-
before-surface ordering, reflect/absorb/offset updates) exists in THREE
deliberately-specialized forms — core/tracer.py::_bounce_step (full
nearest-hit search), record_paths' step (search + topology capture), and
replay_events' step (gather, no search). Any physics change must land in
all three; tests/test_replay.py's exact-equality tests are the tripwire.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .. import constants
from ..core import binning  # noqa: F401  (re-exported for callers)
from ..core.tracer import (SceneArrays, TraceParams, TracerOptions,
                           _histogram_from_events, _intersect_block,
                           _sphere_entry)


@functools.partial(jax.jit,
                   static_argnames=("params", "opts", "n_total_rays"))
def record_paths(sc: SceneArrays, dirs: jax.Array, emitter: jax.Array,
                 rec_center: jax.Array, receiver_yaw_deg,
                 params: TraceParams, opts: TracerOptions = TracerOptions(),
                 n_total_rays: int | None = None):
    """Trace once, recording topology only.

    Returns (tri_ids int32 [N, K], recv_step int32 [N]) with
    K = params.max_bounces: ``tri_ids[i, k]`` is the triangle bounced off at
    step k (-1 = the ray did not advance at step k), ``recv_step[i]`` the
    step at which ray i entered the receiver sphere (-1 = never). Not
    differentiable (int outputs); runs blocked like the XLA tracer.

    ``n_total_rays``: global launch size when recording one shard of a larger
    launch — sets the e0 energy normalization so the energy-threshold kill
    matches trace_ir/replay_events on the full launch.
    """
    n = dirs.shape[0]
    block = min(opts.block_size, n)
    n_pad = ((n + block - 1) // block) * block
    dirs = jnp.asarray(dirs, jnp.float32)
    if n_pad != n:
        dirs = jnp.pad(dirs, ((0, n_pad - n), (0, 0)),
                       constant_values=1.0)  # harmless unit-ish padding
    emitter = jnp.asarray(emitter, jnp.float32)
    rec_center = jnp.asarray(rec_center, jnp.float32)

    absorb = sc.absorption
    if absorb.ndim == 1:
        absorb = absorb[:, None]
    e0 = params.base_power / ((n_total_rays if n_total_rays is not None
                               else n) * constants.SPHERE_VOLUME)

    def block_fn(dirs_block):
        b = dirs_block.shape[0]
        state = (jnp.broadcast_to(emitter[None, :], (b, 3)),
                 dirs_block,
                 jnp.zeros((b,), jnp.float32),            # dist
                 jnp.full((b, absorb.shape[1]), e0),      # energy (for ethr)
                 jnp.zeros((b,), bool),                   # done
                 jnp.full((b,), -1, jnp.int32))           # recv_step

        def step(carry, k):
            pos, dirn, dist, energy, done, recv = carry
            alive = (~done & (dist < params.distance_threshold)
                     & (jnp.max(energy, -1) > params.energy_threshold))
            t_tri, tri = _intersect_block(sc, pos, dirn, opts.tri_chunk)
            t_sph, _ = _sphere_entry(pos, dirn, rec_center)
            receiver = alive & (t_sph < t_tri)
            surface = alive & ~receiver & jnp.isfinite(t_tri)
            t_safe = jnp.where(jnp.isfinite(t_tri), t_tri, 0.0)
            nrm = sc.normal[tri]
            refl = dirn - 2.0 * jnp.sum(dirn * nrm, axis=-1, keepdims=True) * nrm
            hit_p = pos + t_safe[:, None] * dirn
            sm = surface[:, None]
            carry = (jnp.where(sm, hit_p + constants.BOUNCE_EPSILON * refl, pos),
                     jnp.where(sm, refl, dirn),
                     jnp.where(surface, dist + t_safe, dist),
                     jnp.where(sm, energy * (1.0 - absorb[tri]), energy),
                     done | receiver | ~alive | (~surface & alive),
                     jnp.where(receiver, k, recv))
            return carry, jnp.where(surface, tri, -1)

        (_, _, _, _, _, recv), ids = jax.lax.scan(
            step, state, jnp.arange(params.max_bounces, dtype=jnp.int32))
        return ids.T, recv  # [B, K], [B]

    ids, recv = jax.lax.map(block_fn, dirs.reshape(-1, block, 3))
    return ids.reshape(n_pad, -1)[:n], recv.reshape(-1)[:n]


def replay_events(sc: SceneArrays, tri_ids: jax.Array, recv_step: jax.Array,
                  dirs: jax.Array, emitter: jax.Array, rec_center: jax.Array,
                  receiver_yaw_deg, params: TraceParams,
                  n_total_rays: int | None = None):
    """Differentiably re-walk recorded paths; returns per-ray event slots
    (ev_bin_f [N], ev_w [N, n_bands], ev_ear [N]) exactly like the tracers.

    Per step: one gather of the known triangle's plane/normal/absorption and
    a closed-form plane intersection — no nearest-hit search, so cost is
    O(N * K) and gradients flow to absorption, emitter, receiver pose and
    the triangle arrays themselves (plane_n/plane_d/normal via the gather's
    linear VJP). Energy cutoffs do not re-kill paths during replay: the
    recorded topology *is* the truth of the forward run being linearized.
    """
    n, k_steps = tri_ids.shape
    n_total = n_total_rays if n_total_rays is not None else n
    e0 = params.base_power / (n_total * constants.SPHERE_VOLUME)
    emitter = jnp.asarray(emitter, jnp.float32)
    rec_center = jnp.asarray(rec_center, jnp.float32)
    yaw_rad = jnp.deg2rad(jnp.asarray(receiver_yaw_deg, jnp.float32))
    dirs = jnp.asarray(dirs, jnp.float32)

    absorb = sc.absorption
    if absorb.ndim == 1:
        absorb = absorb[:, None]
    n_bands = params.n_bands
    if absorb.shape[1] < n_bands:
        if absorb.shape[1] != 1:
            # Mirror the forward tracer: only broadband (1-band) absorption
            # broadcasts across bands; a partial band table is an error, not
            # a silent band-0 copy.
            raise ValueError(
                f"scene has {absorb.shape[1]} absorption bands but params "
                f"ask for {n_bands}; only 1-band scenes broadcast")
        absorb = jnp.broadcast_to(absorb[:, :1], (absorb.shape[0], n_bands))

    pos0 = jnp.broadcast_to(emitter[None, :], (n, 3))
    energy0 = jnp.full((n, n_bands), e0, jnp.float32)
    ev0 = (jnp.zeros((n,), jnp.float32), jnp.zeros((n, n_bands), jnp.float32),
           jnp.zeros((n,), jnp.int32))

    def deposit(pos, dirn, dist, energy, hit_mask):
        t_sph, chord = _sphere_entry(pos, dirn, rec_center)
        # On the recorded path the sphere is guaranteed hit where
        # hit_mask is set; guard the padding lanes anyway.
        t_safe = jnp.where(jnp.isfinite(t_sph), t_sph, 0.0)
        dist_r = dist + t_safe
        p_hit = pos + t_safe[:, None] * dirn
        d_local = p_hit - rec_center[None, :]
        local_z = (-jnp.sin(yaw_rad) * d_local[:, 0]
                   + jnp.cos(yaw_rad) * d_local[:, 2])
        ear = (local_z >= 0.0).astype(jnp.int32)
        bin_f = dist_r * (params.sample_rate / constants.SPEED_OF_SOUND)
        w = energy * chord[:, None]
        return bin_f, w, ear, hit_mask & jnp.isfinite(t_sph)

    def step(carry, inp):
        pos, dirn, dist, energy, ev = carry
        tri, k = inp
        ev_bin, ev_w, ev_ear = ev

        # receiver deposit happens *before* this step's surface advance
        is_recv = recv_step == k
        bin_f, w, ear, ok = deposit(pos, dirn, dist, energy, is_recv)
        ev_bin = jnp.where(ok, bin_f, ev_bin)
        ev_w = jnp.where(ok[:, None], w, ev_w)
        ev_ear = jnp.where(ok, ear, ev_ear)

        surface = tri >= 0
        ti = jnp.maximum(tri, 0)
        pn = sc.plane_n[ti]
        pd = sc.plane_d[ti]
        nrm = sc.normal[ti]
        ab = absorb[ti]
        # Same term order as the tracer's dot3, so the replayed hit point
        # matches the forward trace to the bit.
        nd = (dirn[:, 0] * pn[:, 0] + dirn[:, 1] * pn[:, 1]
              + dirn[:, 2] * pn[:, 2])
        no = (pos[:, 0] * pn[:, 0] + pos[:, 1] * pn[:, 1]
              + pos[:, 2] * pn[:, 2]) + pd
        t = -no / jnp.where(jnp.abs(nd) > 1e-12, nd, 1.0)
        refl = dirn - 2.0 * jnp.sum(dirn * nrm, axis=-1, keepdims=True) * nrm
        hit_p = pos + t[:, None] * dirn
        sm = surface[:, None]
        carry = (jnp.where(sm, hit_p + constants.BOUNCE_EPSILON * refl, pos),
                 jnp.where(sm, refl, dirn),
                 jnp.where(surface, dist + t, dist),
                 jnp.where(sm, energy * (1.0 - ab), energy),
                 (ev_bin, ev_w, ev_ear))
        return carry, None

    ks = jnp.arange(k_steps, dtype=jnp.int32)
    (_, _, _, _, ev), _ = jax.lax.scan(
        step, (pos0, dirs, jnp.zeros((n,), jnp.float32), energy0, ev0),
        (tri_ids.T, ks))
    # recv_step is always < k_steps (a ray at depth == max_bounces fails the
    # tracer's can_continue and never deposits), so the scan covers every
    # recorded deposit.
    return ev


def render_ir_replay(sc: SceneArrays, tri_ids, recv_step, dirs, emitter,
                     rec_center, receiver_yaw_deg, params: TraceParams,
                     soft_binning: bool = True,
                     n_total_rays: int | None = None) -> jax.Array:
    """Replayed differentiable IR: [2, ir_length] (or [2, n_bands, L]).

    ``soft_binning=True`` (default) makes d(IR)/d(arrival delay) nonzero —
    the point of replaying; hard binning reproduces the forward tracer
    bit-for-bit."""
    ev = replay_events(sc, tri_ids, recv_step, dirs, emitter, rec_center,
                       receiver_yaw_deg, params, n_total_rays)
    return _histogram_from_events(*ev, params, soft_binning)
