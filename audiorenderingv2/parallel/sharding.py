"""Ray-shard data parallelism over a device mesh.

The reference's only parallelism is a single-GPU 3-D launch grid of
independent rays with atomicAdd contention on the shared IR
(AudioRenderer.cpp:497-506; devicePrograms.cu:135-166; device 0 hardcoded at
AudioRenderer.cpp:252). This design scales the same embarrassingly
parallel axis across devices and hosts:

  * a 1-D ``rays`` mesh axis (chips x hosts flattened),
  * ``shard_map`` traces N/D rays per device — directions are never
    materialized globally; each device derives its shard's directions from
    ``fold_in(key, axis_index)``,
  * per-device partial IR histograms reduced with ``jax.lax.psum`` (NCCL
    all-reduce across GPUs) — the cross-device counterpart of atomicAdd,
  * gradients of replicated parameters (absorption, poses) are psum'd by
    shard_map's autodiff transpose automatically, overlapped with the
    backward pass by XLA's latency-hiding scheduler.

Multi-host: call :func:`init_distributed` once per process before building
the mesh; ``jax.devices()`` then spans every process's devices.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

shard_map = jax.shard_map

from ..core import sampling
from ..core.tracer import SceneArrays, TracerOptions, trace_ir
from ..core.tracer_ref import TraceParams

RAYS_AXIS = "rays"


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> None:
    """Multi-host runtime init (one process per host). No-op if already
    initialized or single-process."""
    if num_processes is None or num_processes <= 1:
        return
    state = getattr(jax._src.distributed, "global_state", None)
    if state is not None and getattr(state, "client", None) is not None:
        return  # the documented no-op: runtime already initialized
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def make_ray_mesh(devices=None) -> Mesh:
    """A 1-D mesh over all (or the given) devices with the ``rays`` axis."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    return Mesh(devices.reshape(-1), (RAYS_AXIS,))


def render_ir_sharded(
    sc: SceneArrays,
    key: jax.Array,
    n_rays: int,
    emitter: jax.Array,
    receiver_pos: jax.Array,
    receiver_yaw_deg: jax.Array | float,
    params: TraceParams,
    opts: TracerOptions = TracerOptions(),
    mesh: Mesh | None = None,
) -> jax.Array:
    """Render an IR with rays sharded over the mesh.

    Each device samples its own n_rays/D directions (key folded with the
    device's axis index — same deterministic streams regardless of device
    count given the same per-device ray count) and traces them with the
    global-ray-count energy normalization; partial histograms are psum'd.

    Returns the replicated float32 [2, ir_length] IR.
    """
    mesh = mesh or make_ray_mesh()
    n_dev = mesh.devices.size
    if n_rays % n_dev:
        raise ValueError(f"n_rays={n_rays} not divisible by {n_dev} devices")
    local_rays = n_rays // n_dev

    spec_scene = jax.tree.map(lambda _: P(), sc)

    @functools.partial(
        shard_map, mesh=mesh, check_vma=False,
        in_specs=(spec_scene, P(), P(), P(), P()),
        out_specs=P(),
    )
    def sharded(sc_, key_, emitter_, rec_, yaw_):
        idx = jax.lax.axis_index(RAYS_AXIS)
        dirs = sampling.sample_directions(jax.random.fold_in(key_, idx), local_rays)
        ir = trace_ir(sc_, dirs, emitter_, rec_, yaw_, params, opts,
                      n_total_rays=n_rays)
        return jax.lax.psum(ir, RAYS_AXIS)

    return sharded(sc, key,
                   jnp.asarray(emitter, jnp.float32),
                   jnp.asarray(receiver_pos, jnp.float32),
                   jnp.asarray(receiver_yaw_deg, jnp.float32))


def trace_directions_sharded(
    sc: SceneArrays,
    directions: jax.Array,
    emitter: jax.Array,
    receiver_pos: jax.Array,
    receiver_yaw_deg: jax.Array | float,
    params: TraceParams,
    opts: TracerOptions = TracerOptions(),
    mesh: Mesh | None = None,
) -> jax.Array:
    """Shard explicitly provided directions over the mesh (for tests and
    for exact parity with single-device traces)."""
    mesh = mesh or make_ray_mesh()
    n = directions.shape[0]
    n_dev = mesh.devices.size
    if n % n_dev:
        raise ValueError(f"{n} rays not divisible by {n_dev} devices")

    spec_scene = jax.tree.map(lambda _: P(), sc)

    @functools.partial(
        shard_map, mesh=mesh, check_vma=False,
        in_specs=(spec_scene, P(RAYS_AXIS), P(), P(), P()),
        out_specs=P(),
    )
    def sharded(sc_, dirs_, emitter_, rec_, yaw_):
        ir = trace_ir(sc_, dirs_, emitter_, rec_, yaw_, params, opts,
                      n_total_rays=n)
        return jax.lax.psum(ir, RAYS_AXIS)

    return sharded(sc, jnp.asarray(directions, jnp.float32),
                   jnp.asarray(emitter, jnp.float32),
                   jnp.asarray(receiver_pos, jnp.float32),
                   jnp.asarray(receiver_yaw_deg, jnp.float32))
