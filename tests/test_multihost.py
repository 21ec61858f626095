"""Multi-host (multi-process) execution test: 2 x 4-device jax.distributed.

VERDICT round-1 gap: `init_distributed` existed but was never executed; every
collective ran inside one process. This test spawns two actual OS processes,
initializes the jax.distributed runtime between them (gloo CPU collectives),
runs the sharded renderer and a gradient psum over the resulting 8-device
global mesh, and asserts parity with the single-process result computed in
this (8-virtual-device) test process. Reference analog: none — the reference
is single-GPU (AudioRenderer.cpp:252); multi-host is the BASELINE.md scaling
axis.
"""
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import audiorenderingv2 as ar
from audiorenderingv2 import testing
from audiorenderingv2.core import sampling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "multihost_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def worker_outputs(tmp_path_factory):
    """Run the 2-process job once; both tests read its artifacts."""
    tmp = tmp_path_factory.mktemp("mh")
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    # Children configure their own platform/devices; scrub the parent's.
    env.pop("XLA_FLAGS", None)
    procs = []
    outs = []
    for pid in range(2):
        out = tmp / f"proc{pid}.npz"
        outs.append(out)
        procs.append(subprocess.Popen(
            [sys.executable, WORKER, coord, str(pid), "2", str(out)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    logs = []
    for p in procs:
        try:
            stdout, _ = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        logs.append(stdout)
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{log[-4000:]}"
    return [np.load(o) for o in outs]


def _expected_ir():
    """What render_ir_sharded computes, replayed single-process: the same
    per-device fold_in(key, axis_index) direction streams, concatenated."""
    v, t = testing.box_room((12.0, 8.0, 10.0))
    scene = testing.scene_from_arrays(v, t, 0.3)
    sc = ar.scene_to_arrays(scene, 128)
    params = ar.TraceParams(sample_rate=8000, ir_length=8000,
                            base_power=3.62, max_bounces=6)
    opts = ar.TracerOptions(block_size=128, tri_chunk=128)
    key = jax.random.PRNGKey(5)
    local = 2048 // 8
    dirs = jnp.concatenate([
        sampling.sample_directions(jax.random.fold_in(key, i), local)
        for i in range(8)])
    return np.asarray(ar.trace_ir(
        sc, dirs, jnp.zeros(3), jnp.array([2.0, 0.0, 1.0]), 20.0,
        params, opts, n_total_rays=2048))


def test_two_process_render_matches_single_process(worker_outputs):
    a, b = worker_outputs
    assert int(a["n_processes"]) == 2 and int(a["n_devices"]) == 8
    # both processes hold the same replicated IR
    np.testing.assert_array_equal(a["ir"], b["ir"])
    expected = _expected_ir()
    assert np.isfinite(a["ir"]).all() and a["ir"].sum() > 0
    np.testing.assert_allclose(a["ir"], expected, rtol=1e-4, atol=1e-8)


def test_two_process_gradient_psum(worker_outputs):
    import dataclasses

    a, b = worker_outputs
    np.testing.assert_allclose(a["grad"], b["grad"], rtol=1e-6)
    assert np.abs(a["grad"]).sum() > 0, "gradient vanished across processes"

    # parity with the single-process gradient of the same loss
    from audiorenderingv2.diff import (material_ids_padded,
                                           with_material_absorption)

    v, t = testing.box_room((12.0, 8.0, 10.0))
    scene = testing.scene_from_arrays(v, t, 0.3)
    sc = ar.scene_to_arrays(scene, 128)
    params = ar.TraceParams(sample_rate=8000, ir_length=8000,
                            base_power=3.62, max_bounces=4)
    opts = ar.TracerOptions(block_size=128, tri_chunk=128,
                            early_exit=False, soft_binning=True)
    mat_ids = material_ids_padded(scene, sc.absorption.shape[0])
    dirs = sampling.sample_directions(jax.random.PRNGKey(3), 512)

    def loss(logits):
        sc_t = with_material_absorption(sc, mat_ids, jax.nn.sigmoid(logits))
        ir = ar.trace_ir(sc_t, dirs, jnp.zeros(3),
                         jnp.array([2.0, 0.0, 1.0]), 0.0, params, opts)
        return jnp.mean(ir ** 2)

    g1 = np.asarray(jax.grad(loss)(jnp.zeros((1,), jnp.float32)))
    np.testing.assert_allclose(a["grad"], g1, rtol=1e-3, atol=1e-12)
