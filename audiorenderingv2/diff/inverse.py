"""Differentiable inverse rendering.

The capability the reference lacks entirely (it has no gradients anywhere):
fit scene/source parameters from a target impulse response or target audio by
gradient descent through the tracer. Enabled by two design choices upstream:

  * the tracer's fixed-topology bounce scan is reverse-differentiable
    (``TracerOptions(early_exit=False)``), with gradients flowing to
    absorption (via the per-bounce (1-a) products), to emitter/receiver pose
    (via path lengths and the receiver chord), and to geometry (via the
    precomputed plane/barycentric rows);
  * soft (linear-interpolation) binning makes d(IR)/d(arrival delay) exist
    (``TracerOptions(soft_binning=True)``), see core/binning.py.

Matches BASELINE config #4: "differentiable inverse: fit material absorption
+ source pose from target IR via gradient descent".
"""
from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np
import optax

from ..core import sampling
from ..core.tracer import SceneArrays, TracerOptions, scene_to_arrays, trace_ir
from ..core.tracer_ref import TraceParams
from ..scene import Scene


def material_ids_padded(scene: Scene, t_padded: int) -> jnp.ndarray:
    """Per-padded-triangle material slot: material id, or the trailing
    'no material' slot for id -1 and for padding triangles."""
    n_mats = len(scene.material_names)
    ids = np.full(t_padded, n_mats, np.int64)
    tm = scene.tri_material[:t_padded]
    ids[: tm.shape[0]] = np.where(tm < 0, n_mats, tm)
    return jnp.asarray(ids)


def with_material_absorption(sc: SceneArrays, mat_ids: jax.Array,
                             per_material: jax.Array) -> SceneArrays:
    """Rebuild SceneArrays with absorption gathered from a traced
    per-material table — the hook that lets absorption be an optimization
    variable."""
    return sc._replace(absorption=per_material[mat_ids])


def smooth_ir(ir: jax.Array, radius: int) -> jax.Array:
    """Box-filter the time axis 3x (~Gaussian of sigma ~ radius).

    Soft binning only provides gradient support of +-1 bin (~4 cm of path
    length); smoothing both predicted and target IRs before the loss widens
    the pose-optimization basin to +-3*radius bins. Cumsum-based, O(n),
    differentiable."""
    if radius <= 0:
        return ir
    n = ir.shape[-1]
    kernel_norm = 1.0 / (2 * radius + 1)

    def box(x):
        c = jnp.cumsum(x, axis=-1)
        c = jnp.concatenate([jnp.zeros_like(c[..., :1]), c], axis=-1)
        hi = jnp.clip(jnp.arange(n) + radius + 1, 0, n)
        lo = jnp.clip(jnp.arange(n) - radius, 0, n)
        return (c[..., hi] - c[..., lo]) * kernel_norm

    return box(box(box(ir)))


def ir_loss(pred: jax.Array, target: jax.Array, kind: str = "l2",
            smooth_radius: int = 0) -> jax.Array:
    """Scalar IR discrepancy. 'l2' on raw energies; 'log' compares
    log(1+ir/scale) which balances early strong arrivals vs the tail.
    ``smooth_radius`` box-filters both IRs first (see :func:`smooth_ir`)."""
    pred = smooth_ir(pred, smooth_radius)
    target = smooth_ir(target, smooth_radius)
    if kind == "l2":
        return jnp.mean((pred - target) ** 2)
    if kind == "log":
        scale = jnp.maximum(jnp.max(target), 1e-12)
        f = lambda x: jnp.log1p(x / scale * 100.0)
        return jnp.mean((f(pred) - f(target)) ** 2)
    raise ValueError(kind)


@dataclass
class FitResult:
    params: dict
    losses: np.ndarray

    @property
    def final_loss(self) -> float:
        return float(self.losses[-1])


def _diff_opts(opts: TracerOptions) -> TracerOptions:
    # Gradients need the fixed-length bounce scan and soft binning.
    return dataclasses.replace(opts, early_exit=False, soft_binning=True,
                               remat=True)


def fit_scene_parameters(
    scene: Scene,
    target_ir: jax.Array,
    params: TraceParams,
    *,
    n_rays: int = 8192,
    fit_absorption: bool = True,
    fit_emitter: bool = False,
    init_emitter=(0.0, 0.0, 0.0),
    receiver_pos=(0.0, 0.0, 0.0),
    receiver_yaw_deg: float = 0.0,
    init_absorption: float = 0.5,
    steps: int = 100,
    learning_rate: float = 0.05,
    opts: TracerOptions = TracerOptions(block_size=4096),
    loss_kind: str = "log",
    smooth_radius: int = 0,
    seed: int = 0,
    callback: Callable[[int, float, dict], None] | None = None,
    checkpoint_path: str | None = None,
    checkpoint_every: int = 50,
    method: str = "full",
    replay_refresh: int = 25,
) -> FitResult:
    """Fit per-material absorption and/or emitter position to a target IR.

    Absorption is parameterized through a sigmoid so it stays in (0, 1).
    A fixed direction set (common random numbers) keeps the Monte-Carlo
    noise identical across steps, so the optimizer sees a smooth landscape.
    Returns the fitted parameters and the loss curve.

    ``method``: "full" back-propagates through the complete nearest-hit
    search every step (exact, O(rays*bounces*triangles) per step);
    "replay" records path topology once per ``replay_refresh`` steps with
    the forward tracer and differentiates the O(rays*bounces) replay
    (diff/replay.py) — the same gradients wherever topology is locally
    constant, and the only tractable option at large ray counts.
    """
    opts = _diff_opts(opts)
    sc = scene_to_arrays(scene, opts.tri_chunk)
    mat_ids = material_ids_padded(scene, sc.absorption.shape[0])
    n_mats = len(scene.material_names)

    dirs = sampling.sample_directions(jax.random.PRNGKey(seed), n_rays)
    target_ir = jnp.asarray(target_ir, jnp.float32)
    # One receiver [3] or several [L, 3]: multiple receivers make source-pose
    # recovery well-posed (a single IR is nearly invariant to source
    # direction at fixed distance). With [L, 3], target_ir is [L, 2, bins].
    recs = jnp.atleast_2d(jnp.asarray(receiver_pos, jnp.float32))
    yaws = jnp.broadcast_to(jnp.asarray(receiver_yaw_deg, jnp.float32),
                            (recs.shape[0],))
    multi_rec = jnp.asarray(receiver_pos).ndim > 1
    if multi_rec and target_ir.ndim == 2:
        raise ValueError("multiple receivers need target_ir [L, 2, bins]")

    theta0: dict = {}
    if fit_absorption:
        # Banded params fit a [n_materials+1, n_bands] table — per-band
        # frequency-dependent absorption recovery.
        shape = ((n_mats + 1,) if params.n_bands == 1
                 else (n_mats + 1, params.n_bands))
        init_a = np.clip(np.asarray(init_absorption, np.float32), 1e-4, 1 - 1e-4)
        logits = np.log(init_a / (1.0 - init_a))
        theta0["absorption_logits"] = jnp.broadcast_to(
            jnp.asarray(logits, jnp.float32), shape)
    if fit_emitter:
        theta0["emitter"] = jnp.asarray(init_emitter, jnp.float32)
    if not theta0:
        raise ValueError("nothing to fit")

    fixed_emitter = jnp.asarray(init_emitter, jnp.float32)
    use_replay = method == "replay"
    if method not in ("full", "replay"):
        raise ValueError(f"unknown method {method!r}")
    if use_replay:
        from . import replay as replay_mod

    def predict(theta, paths):
        sc_t = sc
        if fit_absorption:
            per_mat = jax.nn.sigmoid(theta["absorption_logits"])
            sc_t = with_material_absorption(sc_t, mat_ids, per_mat)
        emitter = theta.get("emitter", fixed_emitter)
        if use_replay:
            ids, recv = paths
            irs = [replay_mod.render_ir_replay(
                       sc_t, ids[i], recv[i], dirs, emitter, recs[i], yaws[i],
                       params, soft_binning=True)
                   for i in range(recs.shape[0])]
        else:
            irs = [trace_ir(sc_t, dirs, emitter, recs[i], yaws[i], params,
                            opts) for i in range(recs.shape[0])]
        return jnp.stack(irs) if multi_rec else irs[0]

    def loss_fn(theta, paths):
        return ir_loss(predict(theta, paths), target_ir, loss_kind,
                       smooth_radius)

    def record(theta):
        sc_t = sc
        if fit_absorption:
            per_mat = jax.nn.sigmoid(theta["absorption_logits"])
            sc_t = with_material_absorption(sc_t, mat_ids, per_mat)
        emitter = theta.get("emitter", fixed_emitter)
        out = [replay_mod.record_paths(sc_t, dirs, emitter, recs[i], yaws[i],
                                       params, opts)
               for i in range(recs.shape[0])]
        return (jnp.stack([o[0] for o in out]),
                jnp.stack([o[1] for o in out]))

    optimizer = optax.adam(learning_rate)
    opt_state = optimizer.init(theta0)

    # Steps run in jitted lax.scan chunks with donated parameter/optimizer
    # buffers: the host only syncs at chunk boundaries (topology refresh,
    # checkpoint, per-step callback), so a thousand-step fit is one or a few
    # device dispatches instead of a float() round-trip per step.
    # ONE static chunk length for the whole fit (the largest host-sync
    # interval): a shorter tail chunk runs at the same compiled shape with
    # its surplus steps masked to no-ops, instead of recompiling the full
    # value_and_grad scan for every distinct remainder length (tail waste
    # is bounded by one chunk of forward/backward compute; a recompile on
    # chip costs seconds to minutes).
    @functools.partial(jax.jit, donate_argnums=(0, 1),
                       static_argnames=("k",))
    def run_chunk(theta, opt_state, paths, k, n_real=None):
        if n_real is None:
            n_real = k

        def body(carry, idx):
            theta, opt_state = carry
            loss, grads = jax.value_and_grad(loss_fn)(theta, paths)
            updates, opt_state2 = optimizer.update(grads, opt_state)
            theta2 = optax.apply_updates(theta, updates)
            live = idx < n_real
            theta = jax.tree.map(lambda a, b: jnp.where(live, b, a),
                                 theta, theta2)
            opt_state = jax.tree.map(lambda a, b: jnp.where(live, b, a),
                                     opt_state, opt_state2)
            return (theta, opt_state), loss

        (theta, opt_state), chunk_losses = jax.lax.scan(
            body, (theta, opt_state), jnp.arange(k))
        return theta, opt_state, chunk_losses

    theta = theta0
    losses = []
    start_step = 0
    if checkpoint_path is not None:
        from .checkpoint import load_fit_state, save_fit_state

        restored = load_fit_state(checkpoint_path, theta0, opt_state)
        if restored is not None:
            start_step, theta, opt_state, losses = restored

    refresh = max(replay_refresh, 1)
    chunk_cap = steps
    if use_replay:
        chunk_cap = min(chunk_cap, refresh)
    if checkpoint_path is not None:
        chunk_cap = min(chunk_cap, checkpoint_every)
    if callback is not None:
        chunk_cap = 1
    chunk_cap = max(chunk_cap, 1)
    paths = None
    i = start_step
    while i < steps:
        if use_replay and (paths is None or i % refresh == 0):
            # topology moves with the emitter (and, via the energy cutoff,
            # with absorption) — re-record at the current parameters
            paths = record(theta)
        # next host-sync boundary: end of fit, topology refresh, checkpoint,
        # or every step when a per-step callback wants the loss
        nxt = steps
        if use_replay:
            nxt = min(nxt, (i // refresh + 1) * refresh)
        if checkpoint_path is not None:
            nxt = min(nxt, (i // checkpoint_every + 1) * checkpoint_every)
        if callback is not None:
            nxt = min(nxt, i + 1)
        k = nxt - i
        theta, opt_state, chunk_losses = run_chunk(
            theta, opt_state, paths, chunk_cap, np.int32(k))
        chunk_losses = np.asarray(chunk_losses)[:k]
        losses.extend(float(l) for l in chunk_losses)
        if callback is not None:
            callback(i, float(chunk_losses[-1]), theta)
        i = nxt
        if (checkpoint_path is not None
                and (i % checkpoint_every == 0 or i == steps)):
            save_fit_state(checkpoint_path, i, theta, opt_state, losses)

    out: dict = {}
    if fit_absorption:
        out["absorption"] = np.asarray(jax.nn.sigmoid(theta["absorption_logits"]))
    if fit_emitter:
        out["emitter"] = np.asarray(theta["emitter"])
    return FitResult(params=out, losses=np.asarray(losses))


def coarse_emitter_search(
    scene: Scene,
    target_ir: jax.Array,
    params: TraceParams,
    *,
    candidates: np.ndarray,
    receiver_pos,
    receiver_yaw_deg=0.0,
    n_rays: int = 2048,
    opts: TracerOptions = TracerOptions(block_size=4096),
    loss_kind: str = "log",
    smooth_radius: int = 32,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Evaluate the IR loss at candidate emitter positions; returns
    (best_position [3], losses [n_candidates]).

    Why this exists: the tracer's autodiff gradient has fixed path topology —
    it cannot see rays that would start/stop hitting the receiver under a
    parameter change, so source-pose descent stalls in spurious basins more
    than ~1 m from the truth (the measured gradient-convergent basin). A
    coarse grid costs one forward render per candidate (no gradients) and
    lands refinement inside the basin. See examples/demo_4_inverse.py.
    """
    opts = _diff_opts(opts)
    sc = scene_to_arrays(scene, opts.tri_chunk)
    dirs = sampling.sample_directions(jax.random.PRNGKey(seed), n_rays)
    target_ir = jnp.asarray(target_ir, jnp.float32)
    recs = jnp.atleast_2d(jnp.asarray(receiver_pos, jnp.float32))
    yaws = jnp.broadcast_to(jnp.asarray(receiver_yaw_deg, jnp.float32),
                            (recs.shape[0],))
    multi = jnp.asarray(receiver_pos).ndim > 1

    def loss_at(emitter):
        irs = [trace_ir(sc, dirs, emitter, recs[i], yaws[i], params, opts)
               for i in range(recs.shape[0])]
        pred = jnp.stack(irs) if multi else irs[0]
        return ir_loss(pred, target_ir, loss_kind, smooth_radius)

    # All candidates in one vmapped dispatch per chunk of 32 (one forward
    # render per candidate, evaluated in parallel on-device instead of one
    # host round-trip each; the tail chunk wraps so the compiled executable
    # is reused).
    loss_batch = jax.jit(jax.vmap(loss_at))
    candidates = np.asarray(candidates, np.float32).reshape(-1, 3)
    n_cand = len(candidates)
    chunk = min(32, n_cand)
    cands_j = jnp.asarray(candidates)
    losses = []
    for start in range(0, n_cand, chunk):
        idx = jnp.arange(start, start + chunk) % n_cand
        losses.append(np.asarray(loss_batch(cands_j[idx])))
    losses = np.concatenate(losses)[:n_cand]
    return candidates[int(np.argmin(losses))], losses


def emitter_grid(bounds_min, bounds_max, spacing: float = 2.0) -> np.ndarray:
    """Regular grid of candidate positions inside an AABB (for
    :func:`coarse_emitter_search`)."""
    axes = [np.arange(lo + spacing / 2, hi, spacing)
            for lo, hi in zip(np.asarray(bounds_min), np.asarray(bounds_max))]
    grid = np.meshgrid(*axes, indexing="ij")
    return np.stack([g.reshape(-1) for g in grid], axis=-1).astype(np.float32)


def render_soft_ir(scene: Scene, params: TraceParams, *, n_rays: int,
                   emitter, receiver_pos, receiver_yaw_deg: float = 0.0,
                   opts: TracerOptions = TracerOptions(block_size=4096),
                   seed: int = 0) -> jax.Array:
    """Render a soft-binned target IR with the same direction stream the
    fitter uses (helper for self-consistent inverse tests/demos)."""
    opts = _diff_opts(opts)
    sc = scene_to_arrays(scene, opts.tri_chunk)
    dirs = sampling.sample_directions(jax.random.PRNGKey(seed), n_rays)
    return trace_ir(sc, dirs, jnp.asarray(emitter, jnp.float32),
                    jnp.asarray(receiver_pos, jnp.float32),
                    jnp.float32(receiver_yaw_deg), params, opts)
