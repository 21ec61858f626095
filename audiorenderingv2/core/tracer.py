"""Path tracer: JAX/XLA implementation of the acoustic ray bounce loop.

This replaces the reference's OptiX launch (AudioRenderer.cpp:497-506 +
devicePrograms.cu:192-254) with an XLA program:

* **Uniform control flow.** The reference's divergent per-thread ``while``
  bounce loop becomes a ``lax.scan`` / ``lax.while_loop`` over bounce steps
  with an alive mask — every ray in a block advances in lockstep.
  Termination semantics are identical: {distance below
  ir_seconds*343+1, energy above threshold, depth below max_bounces}
  (devicePrograms.cu:227-236).

* **Intersection as broadcast dot products.** Instead of per-(ray, triangle)
  cross products, the scene precomputes plane rows and barycentric rows
  (scene.py), reducing Möller–Trumbore to six [B, T] broadcast dot products
  plus fused elementwise math and a masked min-reduction, with no
  data-dependent branching. The dots are deliberately elementwise (not
  jnp.dot): a K=3 f32 matmul at default precision may run in TF32 on the
  GPU (about 3 significant digits) and corrupt the geometry. Triangles are
  processed in static chunks so intermediates stay small.

* **Receiver as a parameter.** The listener is an analytic sphere test
  (center, yaw) rather than re-tessellated geometry, so listener movement
  requires no acceleration-structure rebuild (the reference rebuilds its GAS
  per move, AudioRenderer.cpp:466-486) and pose is differentiable.

* **One deposit per ray.** Each ray deposits at most one arrival (it dies on
  reaching the receiver, devicePrograms.cu:147), recorded in per-ray event
  slots and reduced afterwards by the scatter-add histogram in binning.py —
  the reference's ``atomicAdd`` (devicePrograms.cu:135-166).

The whole pipeline is jit-able and differentiable (with ``soft_binning`` for
delay gradients); rays shard over a device mesh via parallel/sharding.py.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .. import constants
from . import binning
from .tracer_ref import TraceParams

_BARY_EPS = 1e-7


class SceneArrays(NamedTuple):
    """Device-resident scene data (all float32, T padded to the tri chunk).

    ``u_off``/``v_off`` fold the -v0 term of the barycentric affine map so the
    per-chunk math is pure multiply-add + elementwise.
    """

    plane_n: jax.Array   # [T, 3]
    plane_d: jax.Array   # [T]
    bary_u: jax.Array    # [T, 3]
    bary_v: jax.Array    # [T, 3]
    u_off: jax.Array     # [T]
    v_off: jax.Array     # [T]
    normal: jax.Array    # [T, 3] unit geometric normal
    absorption: jax.Array  # [T]
    valid: jax.Array     # [T] 1.0 real / 0.0 padding


@dataclass(frozen=True)
class TracerOptions:
    """Static tracer knobs (part of the jit cache key)."""

    block_size: int = 8192       # rays traced in lockstep per lax.map step
    tri_chunk: int = 2048        # triangles per intersection chunk
    soft_binning: bool = False   # linear-interp bins (differentiable delays)
    early_exit: bool = True      # while_loop with all-dead exit (forward only)
    remat: bool = False          # checkpoint per-block trace for backward
    backend: str = "xla"         # the only tracer: XLA-compiled, differentiable
    rng_impl: str = "threefry"   # direction-sampling PRNG: "threefry"
                                 # (jax default, bit-reproducible across
                                 # devices) | "rbg"/"unsafe_rbg" (XLA
                                 # RngBitGenerator; a different stream)

    def __post_init__(self):
        if self.backend != "xla":
            raise ValueError(f"unknown tracer backend {self.backend!r}; "
                             f"the only backend is 'xla'")


def scene_to_arrays(scene, tri_chunk: int = 2048,
                    absorption: jax.Array | None = None) -> SceneArrays:
    """Pack a host Scene into device arrays, padded to a multiple of the
    triangle chunk. ``absorption`` may override the per-triangle absorption
    with a traced array (for absorption optimization)."""
    t = scene.v0.shape[0]
    t_pad = ((t + 127) // 128) * 128
    tc = min(tri_chunk, t_pad)
    t_pad = ((t_pad + tc - 1) // tc) * tc  # whole number of chunks

    def pad(x, value=0.0):
        x = jnp.asarray(x, dtype=jnp.float32)
        if x.shape[0] == t_pad:
            return x
        width = [(0, t_pad - x.shape[0])] + [(0, 0)] * (x.ndim - 1)
        return jnp.pad(x, width, constant_values=value)

    # Elementwise row dots, not einsum: a default-precision f32 contraction
    # may run in TF32 on the GPU, and these offsets feed every barycentric
    # test.
    v0 = jnp.asarray(scene.v0, jnp.float32)
    u_off = -jnp.sum(v0 * jnp.asarray(scene.bary_u, jnp.float32), axis=-1)
    v_off = -jnp.sum(v0 * jnp.asarray(scene.bary_v, jnp.float32), axis=-1)
    absorb = scene.absorption if absorption is None else absorption
    return SceneArrays(
        plane_n=pad(scene.plane_n),
        plane_d=pad(scene.plane_d),
        bary_u=pad(scene.bary_u),
        bary_v=pad(scene.bary_v),
        u_off=pad(u_off),
        v_off=pad(v_off),
        normal=pad(scene.normal),
        absorption=pad(absorb),
        valid=pad(scene.valid),
    )


def _intersect_block(sc: SceneArrays, pos: jax.Array, dirn: jax.Array,
                     tri_chunk: int):
    """Nearest triangle hit for a block of rays.

    Returns (t [B] — inf when no hit, tri_index [B]). Scans static triangle
    chunks carrying the running (min-t, argmin) so per-chunk intermediates
    are [B, tri_chunk] and fuse.
    """
    t_total = sc.plane_n.shape[0]
    tri_chunk = min(tri_chunk, t_total)
    n_chunks = t_total // tri_chunk
    b = pos.shape[0]

    def reshape(x):
        return x.reshape((n_chunks, tri_chunk) + x.shape[1:])

    chunks = (
        reshape(sc.plane_n), reshape(sc.plane_d),
        reshape(sc.bary_u), reshape(sc.u_off),
        reshape(sc.bary_v), reshape(sc.v_off),
        reshape(sc.valid),
        jnp.arange(n_chunks, dtype=jnp.int32) * tri_chunk,
    )

    def dot3(a, b):
        # Explicit broadcast multiply-add instead of jnp.dot: a K=3 f32
        # matmul at default precision may run in TF32 on the GPU (10-bit
        # mantissa geometry -> phantom ray misses); elementwise math stays
        # exact float32.
        return (a[:, None, 0] * b[None, :, 0]
                + a[:, None, 1] * b[None, :, 1]
                + a[:, None, 2] * b[None, :, 2])

    def chunk_step(carry, chunk):
        t_best, i_best = carry
        pn, pd, au, auo, av, avo, vmask, base = chunk
        nd = dot3(dirn, pn)                    # [B, Tc]
        no = dot3(pos, pn) + pd[None, :]
        safe = jnp.abs(nd) > 1e-12
        t = -no / jnp.where(safe, nd, 1.0)
        u = (dot3(pos, au) + auo[None, :]) + t * dot3(dirn, au)
        v = (dot3(pos, av) + avo[None, :]) + t * dot3(dirn, av)
        ok = (safe & (t > constants.T_MIN)
              & (u >= -_BARY_EPS) & (v >= -_BARY_EPS)
              & (u + v <= 1.0 + _BARY_EPS) & (vmask[None, :] > 0))
        t = jnp.where(ok, t, jnp.inf)
        t_min = jnp.min(t, axis=1)
        i_min = jnp.argmin(t, axis=1).astype(jnp.int32) + base
        better = t_min < t_best
        return (jnp.where(better, t_min, t_best),
                jnp.where(better, i_min, i_best)), None

    init = (jnp.full((b,), jnp.inf, jnp.float32), jnp.zeros((b,), jnp.int32))
    if n_chunks == 1:
        (t_best, i_best), _ = chunk_step(init, jax.tree.map(lambda x: x[0], chunks))
    else:
        (t_best, i_best), _ = jax.lax.scan(chunk_step, init, chunks)
    return t_best, i_best


def _sphere_entry(pos, dirn, center):
    """Analytic receiver-sphere crossing (cf. devicePrograms.cu:91-122).

    Returns (t_hit [B] — inf on miss, chord [B]). The chord is the secant
    length through the radius-1 sphere, the reference's deposited-energy
    factor. Origins inside the sphere hit the far surface, matching a mesh
    receiver hit from inside.
    """
    oc = pos - center[None, :]
    b = jnp.sum(oc * dirn, axis=-1)
    c = jnp.sum(oc * oc, axis=-1) - constants.RECEIVER_RADIUS**2
    disc = b * b - c
    hit = disc > 0.0
    s = jnp.sqrt(jnp.where(hit, disc, 0.0))
    t1 = -b - s
    t2 = -b + s
    t_hit = jnp.where(
        hit & (t1 > constants.T_MIN), t1,
        jnp.where(hit & (t2 > constants.T_MIN), t2, jnp.inf))
    return t_hit, t2 - t1


class _RayState(NamedTuple):
    pos: jax.Array       # [B, 3]
    dirn: jax.Array      # [B, 3]
    dist: jax.Array      # [B]
    energy: jax.Array    # [B, n_bands]
    depth: jax.Array     # [B] int32
    done: jax.Array      # [B] bool
    ev_bin_f: jax.Array  # [B] fractional arrival bin of the (single) deposit
    ev_w: jax.Array      # [B, n_bands] deposited energy
    ev_ear: jax.Array    # [B] int32, 0 left / 1 right


def _bounce_step(state: _RayState, sc: SceneArrays, rec_center, yaw_rad,
                 params: TraceParams, opts: TracerOptions) -> _RayState:
    can_continue = ((state.dist < params.distance_threshold)
                    & (jnp.max(state.energy, axis=-1) > params.energy_threshold)
                    & (state.depth < params.max_bounces))
    alive = ~state.done & can_continue

    with jax.named_scope("nearest_hit"):  # profiler attribution
        t_tri, tri = _intersect_block(sc, state.pos, state.dirn,
                                      opts.tri_chunk)
    t_sph, chord = _sphere_entry(state.pos, state.dirn, rec_center)

    receiver = alive & (t_sph < t_tri)
    surface = alive & ~receiver & jnp.isfinite(t_tri)
    miss = alive & ~receiver & ~surface

    # --- receiver event: record the single deposit, kill the ray ---
    t_sph_safe = jnp.where(jnp.isfinite(t_sph), t_sph, 0.0)
    dist_r = state.dist + t_sph_safe
    p_hit = state.pos + t_sph_safe[:, None] * state.dirn
    d_local = p_hit - rec_center[None, :]
    # Head-local z after undoing the -yaw placement rotation about Y
    # (OptixModel.cpp:179-184): left hemisphere is z < 0.
    local_z = -jnp.sin(yaw_rad) * d_local[:, 0] + jnp.cos(yaw_rad) * d_local[:, 2]
    ear = (local_z >= 0.0).astype(jnp.int32)
    bin_f = dist_r * (params.sample_rate / constants.SPEED_OF_SOUND)

    ev_bin_f = jnp.where(receiver, bin_f, state.ev_bin_f)
    ev_w = jnp.where(receiver[:, None], state.energy * chord[:, None],
                     state.ev_w)
    ev_ear = jnp.where(receiver, ear, state.ev_ear)

    # --- surface bounce: specular reflect, absorb, offset, advance ---
    t_tri_safe = jnp.where(jnp.isfinite(t_tri), t_tri, 0.0)
    n = sc.normal[tri]
    refl = state.dirn - 2.0 * jnp.sum(state.dirn * n, axis=-1, keepdims=True) * n
    hit_p = state.pos + t_tri_safe[:, None] * state.dirn
    new_pos = hit_p + constants.BOUNCE_EPSILON * refl
    absorb = sc.absorption[tri]
    if absorb.ndim == 1:
        absorb = absorb[:, None]  # broadband -> broadcast over bands

    sm = surface[:, None]
    return _RayState(
        pos=jnp.where(sm, new_pos, state.pos),
        dirn=jnp.where(sm, refl, state.dirn),
        dist=jnp.where(surface, state.dist + t_tri_safe, state.dist),
        energy=jnp.where(sm, state.energy * (1.0 - absorb), state.energy),
        depth=jnp.where(surface, state.depth + 1, state.depth),
        # distance/energy/depth limits are monotonic, so a ray failing them
        # now can never revive — mark it done so the early-exit while_loop
        # stops as soon as no ray can deposit anything further.
        done=state.done | receiver | miss | ~can_continue,
        ev_bin_f=ev_bin_f,
        ev_w=ev_w,
        ev_ear=ev_ear,
    )


def _trace_block(dirs_block, energy0, sc, emitter, rec_center, yaw_rad,
                 params: TraceParams, opts: TracerOptions):
    """Trace one block of rays to completion; returns per-ray event slots."""
    b = dirs_block.shape[0]
    state = _RayState(
        pos=jnp.broadcast_to(emitter[None, :], (b, 3)).astype(jnp.float32),
        dirn=dirs_block,
        dist=jnp.zeros((b,), jnp.float32),
        energy=jnp.broadcast_to(energy0[:, None], (b, params.n_bands)),
        depth=jnp.zeros((b,), jnp.int32),
        done=jnp.zeros((b,), bool),
        ev_bin_f=jnp.zeros((b,), jnp.float32),
        ev_w=jnp.zeros((b, params.n_bands), jnp.float32),
        ev_ear=jnp.zeros((b,), jnp.int32),
    )
    step = functools.partial(_bounce_step, sc=sc, rec_center=rec_center,
                             yaw_rad=yaw_rad, params=params, opts=opts)
    if opts.early_exit:
        # Forward-only: stop as soon as every ray in the block is done.
        def cond(carry):
            i, st = carry
            return (i < params.max_bounces) & jnp.any(~st.done)

        def body(carry):
            i, st = carry
            return i + 1, step(st)

        _, state = jax.lax.while_loop(cond, body, (jnp.int32(0), state))
    else:
        # Fixed-length scan: reverse-differentiable.
        def body(st, _):
            return step(st), None

        state, _ = jax.lax.scan(body, state, None, length=params.max_bounces)
    return state.ev_bin_f, state.ev_w, state.ev_ear, state.depth


def _slot_bins(bin_f: jax.Array, active: jax.Array, n_bins: int, soft: bool):
    """Per-event deposit slots: (bins [E, S], interpolation fracs [E, S])."""
    if soft:
        b0 = jnp.floor(bin_f)
        frac = bin_f - b0
        b0i = b0.astype(jnp.int32)
        bins = jnp.stack([jnp.where(active, b0i, n_bins),
                          jnp.where(active, b0i + 1, n_bins)], axis=-1)
        fracs = jnp.stack([1.0 - frac, frac], axis=-1)
    else:
        b = jnp.round(bin_f).astype(jnp.int32)
        bins = jnp.where(active, b, n_bins)[..., None]
        fracs = jnp.ones_like(bin_f)[..., None]
    return bins, fracs


def _events_to_flat_bins(ev_bin_f, ev_w, ev_ear, params: TraceParams,
                         soft: bool):
    """Expand per-ray events into (flat_bin [E*S], weight [E*S, n_bands]).

    Flat layout: left ear occupies [0, n_bins), right [n_bins, 2*n_bins);
    out-of-range deposits get the overflow index 2*n_bins and are dropped by
    the histogram. Cross-ear deposit at +int(sr*0.00044) samples scaled by
    (1 - hrtf_absorption_rate), falling back to the same bin when the delayed
    bin overflows (devicePrograms.cu:124-168).
    """
    nb = params.ir_length
    active = jnp.any(ev_w != 0.0, axis=-1)

    def flatten(bins, fracs, band_w, ear):
        in_range = (bins >= 0) & (bins < nb)
        flat = jnp.where(in_range, ear[:, None] * nb + bins, 2 * nb)
        ws = fracs[:, :, None] * band_w[:, None, :]  # [E, S, n_bands]
        return flat, ws

    slots = []
    same_bins, same_fracs = _slot_bins(ev_bin_f, active, nb, soft)
    slots.append(flatten(same_bins, same_fracs, ev_w, ev_ear))

    if not params.is_mono:
        delay = params.cross_ear_delay
        cross_w = ev_w * (1.0 - params.hrtf_absorption_rate)
        other = 1 - ev_ear
        if soft:
            # The reference's overflow fallback (devicePrograms.cu:136-167,
            # mirrored by the hard path below): a cross deposit whose
            # delayed bin lands past the IR end goes to the BASE bin
            # instead of being dropped. Applied softly at the hard-mode
            # predicate (round(base)+delay >= nb), so the last `delay`
            # samples match hard-mode energy placement instead of
            # clamping (the r4 parity delta, docs/PARITY.md).
            over = jnp.round(ev_bin_f) + delay >= nb
            cross_src = jnp.where(over, ev_bin_f, ev_bin_f + delay)
            cross_bins, cross_fracs = _slot_bins(cross_src, active, nb,
                                                 soft)
            slots.append(flatten(cross_bins, cross_fracs, cross_w, other))
        else:
            base = jnp.round(ev_bin_f).astype(jnp.int32)
            cb = jnp.where(base + delay < nb, base + delay, base)
            # Only deposit when the base bin itself was in range.
            cb = jnp.where((base >= 0) & (base < nb) & active, cb, nb)
            fr = jnp.ones_like(ev_bin_f)[..., None]
            slots.append(flatten(cb[:, None], fr, cross_w, other))

    flat = jnp.concatenate([s[0] for s in slots], axis=1).reshape(-1)
    ws = jnp.concatenate([s[1] for s in slots], axis=1)
    return flat, ws.reshape(-1, params.n_bands)


def _histogram_from_events(ev_bin_f, ev_w, ev_ear, params: TraceParams,
                           soft: bool) -> jax.Array:
    """Events -> stereo (optionally banded) IR histogram.

    ev_bin_f [E], ev_w [E, n_bands], ev_ear [E]. Returns [2, ir_length] for
    one band, [2, n_bands, ir_length] otherwise.

    Hard-binning fast path: only the same-ear deposits are scattered; the
    cross-ear contribution (devicePrograms.cu:136-167) is derived from the
    finished histograms by a shift — cross[j] = (1-hrtf) * (same[j-delay]
    + same[j] for the last `delay` bins, the reference's overflow fallback)
    — which is exact and halves the number of scattered events.
    """
    nb = params.ir_length
    if not soft and not params.is_mono:
        active = jnp.any(ev_w != 0.0, axis=-1)
        b = jnp.round(ev_bin_f).astype(jnp.int32)
        flat = jnp.where(active & (b >= 0) & (b < nb),
                         ev_ear * nb + b, 2 * nb)
        hist = binning.histogram_sum_banded(flat, ev_w, 2 * nb)
        hist = hist.reshape(2, nb, params.n_bands)
        scale = 1.0 - params.hrtf_absorption_rate
        delay = params.cross_ear_delay
        shifted = jnp.roll(hist, delay, axis=1)
        mask = (jnp.arange(nb) >= delay)[None, :, None]
        tail = (jnp.arange(nb) >= nb - delay)[None, :, None]
        cross = scale * (jnp.where(mask, shifted, 0.0)
                         + jnp.where(tail, hist, 0.0))
        hist = hist + cross[::-1]  # each ear receives the OTHER ear's cross
    else:
        flat, ws = _events_to_flat_bins(ev_bin_f, ev_w, ev_ear, params, soft)
        hist = binning.histogram_sum_banded(flat, ws, 2 * nb)
        hist = hist.reshape(2, nb, params.n_bands)
    if params.n_bands == 1:
        return hist[:, :, 0]
    return jnp.transpose(hist, (0, 2, 1))


def trace_ir(
    sc: SceneArrays,
    directions: jax.Array,
    emitter: jax.Array,
    receiver_pos: jax.Array,
    receiver_yaw_deg: jax.Array | float,
    params: TraceParams,
    opts: TracerOptions = TracerOptions(),
    n_total_rays: int | None = None,
    with_stats: bool = False,
) -> jax.Array:
    """Trace ``directions`` and return the stereo IR histogram.

    Args:
      sc: device scene arrays (``scene_to_arrays``).
      directions: float32 [N, 3] unit ray directions.
      emitter / receiver_pos: float [3] positions.
      receiver_yaw_deg: listener yaw (degrees, atan2(z, x) convention).
      params: static trace parameters (also used by the CPU oracle).
      opts: static tracer performance options.
      n_total_rays: global ray count for energy normalization when this call
        traces one shard of a larger launch (energy = base_power /
        (n_total * sphere_volume), devicePrograms.cu:207-208).
      with_stats: also return {"bounces": [N(_pad)] f32 per-ray completed
        bounce counts} — the useful-work measure for flop/MFU accounting
        (bench.py), computed by the same compiled program (no re-trace).

    Returns float32 [2, ir_length] (left, right), or
    [2, n_bands, ir_length] when params.n_bands > 1 — as (ir, stats) when
    ``with_stats``. Mono folding is applied by the renderer layer
    (kernels.cu:519-536), not here.
    """
    n = directions.shape[0]
    n_total = n_total_rays if n_total_rays is not None else n

    block = min(opts.block_size, n)
    n_pad = ((n + block - 1) // block) * block
    n_blocks = n_pad // block

    dirs = jnp.asarray(directions, jnp.float32)
    if n_pad != n:
        dirs = jnp.pad(dirs, ((0, n_pad - n), (0, 0)))
    dirs = dirs.reshape(n_blocks, block, 3)

    e0 = params.base_power / (n_total * constants.SPHERE_VOLUME)
    ray_index = jnp.arange(n_pad, dtype=jnp.int32).reshape(n_blocks, block)
    energy0 = jnp.where(ray_index < n, jnp.float32(e0), 0.0)

    emitter = jnp.asarray(emitter, jnp.float32)
    rec_center = jnp.asarray(receiver_pos, jnp.float32)
    yaw_rad = jnp.deg2rad(jnp.asarray(receiver_yaw_deg, jnp.float32))

    def block_fn(args):
        d, e = args
        return _trace_block(d, e, sc, emitter, rec_center, yaw_rad, params, opts)

    if opts.remat:
        block_fn = jax.checkpoint(block_fn)

    ev_bin_f, ev_w, ev_ear, depth = jax.lax.map(block_fn, (dirs, energy0))

    ir = _histogram_from_events(
        ev_bin_f.reshape(-1), ev_w.reshape(-1, params.n_bands),
        ev_ear.reshape(-1), params, opts.soft_binning)
    if with_stats:
        return ir, {"bounces": depth.reshape(-1)[:n].astype(jnp.float32)}
    return ir


def render_ir(
    sc: SceneArrays,
    key: jax.Array,
    n_rays: int,
    emitter: jax.Array,
    receiver_pos: jax.Array,
    receiver_yaw_deg: jax.Array | float,
    params: TraceParams,
    opts: TracerOptions = TracerOptions(),
    n_total_rays: int | None = None,
    with_stats: bool = False,
) -> jax.Array:
    """Keyed render: sample directions from ``key`` (core/sampling, the
    stream the oracle tests share) and trace them."""
    from . import sampling

    dirs = sampling.sample_directions(key, n_rays, rng_impl=opts.rng_impl)
    return trace_ir(sc, dirs, emitter, receiver_pos, receiver_yaw_deg,
                    params, opts, n_total_rays, with_stats=with_stats)
