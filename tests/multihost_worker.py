"""Worker process for the multi-host (multi-process) jax.distributed test.

Each worker owns 4 virtual CPU devices; `jax.distributed.initialize` joins
them into one 8-device global mesh spanning both processes, so the shard_map
collectives (`psum` of IR histograms and of parameter gradients) actually
cross a process boundary — the execution evidence the single-process virtual
mesh cannot give. Reference analog: none (the reference is single-GPU,
AudioRenderer.cpp:252); this is the BASELINE multi-host scaling axis.

argv: coordinator_address process_id num_processes out_path.npz
"""
import os
import sys

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=4").strip()
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")


def main():
    coord, pid, nprocs, out_path = sys.argv[1:5]
    jax.distributed.initialize(coordinator_address=coord,
                               num_processes=int(nprocs),
                               process_id=int(pid))
    assert jax.process_count() == int(nprocs)
    assert jax.device_count() == 4 * int(nprocs)

    import jax.numpy as jnp
    import numpy as np

    import audiorenderingv2 as ar
    from audiorenderingv2 import testing
    from audiorenderingv2.core import sampling
    from audiorenderingv2.diff import (material_ids_padded,
                                           with_material_absorption)
    from audiorenderingv2.parallel import (make_ray_mesh,
                                               render_ir_sharded,
                                               trace_directions_sharded)

    v, t = testing.box_room((12.0, 8.0, 10.0))
    scene = testing.scene_from_arrays(v, t, 0.3)
    sc = ar.scene_to_arrays(scene, 128)
    params = ar.TraceParams(sample_rate=8000, ir_length=8000,
                            base_power=3.62, max_bounces=6)
    opts = ar.TracerOptions(block_size=128, tri_chunk=128)
    rec = jnp.array([2.0, 0.0, 1.0], jnp.float32)

    mesh = make_ray_mesh()  # 1-D rays axis over all 8 global devices
    key = jax.random.PRNGKey(5)

    # 1) keyed render across processes (each device derives its shard's
    #    directions from fold_in(key, global axis_index))
    ir = render_ir_sharded(sc, key, 2048, jnp.zeros(3), rec, 20.0,
                           params, opts, mesh=mesh)
    ir_np = np.asarray(ir.addressable_shards[0].data)

    # 2) gradient psum across processes (explicit dirs, differentiable path)
    import dataclasses

    dopts = dataclasses.replace(opts, early_exit=False, soft_binning=True)
    dparams = dataclasses.replace(params, max_bounces=4)
    mat_ids = material_ids_padded(scene, sc.absorption.shape[0])
    dirs = sampling.sample_directions(jax.random.PRNGKey(3), 512)

    def loss(logits):
        sc_t = with_material_absorption(sc, mat_ids, jax.nn.sigmoid(logits))
        ir_s = trace_directions_sharded(sc_t, dirs, jnp.zeros(3), rec, 0.0,
                                        dparams, dopts, mesh=mesh)
        return jnp.mean(ir_s ** 2)

    grad = jax.grad(loss)(jnp.zeros((1,), jnp.float32))
    grad_np = np.asarray(grad.addressable_shards[0].data
                         if hasattr(grad, "addressable_shards") else grad)

    np.savez(out_path, ir=ir_np, grad=grad_np,
             n_devices=jax.device_count(), n_processes=jax.process_count())
    print(f"worker {pid}: ok devices={jax.device_count()}", flush=True)


if __name__ == "__main__":
    main()
