"""BASELINE config #2: monkey.obj, 3 bounces, 100k rays, frequency-dependent
absorption (4 bands).

Usage: python examples/demo_2_banded.py
"""
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax
import jax.numpy as jnp

import audiorenderingv2 as ar
from audiorenderingv2 import testing
from audiorenderingv2.core import sampling
from audiorenderingv2.io import obj as obj_io
from audiorenderingv2.scene import build_scene

REF_MONKEY = "/root/reference/monkey.obj"
# Concrete-like: reflective lows, absorbent highs.
BAND_ABSORPTION = np.array([0.05, 0.15, 0.4, 0.7], np.float32)


def main():
    if Path(REF_MONKEY).exists():
        mesh = obj_io.load_obj(REF_MONKEY)
    else:
        v, t = testing.icosphere(radius=3.0, subdivisions=3)
        mesh = testing.mesh_from_arrays(v, t)
    tri_abs = np.tile(BAND_ABSORPTION, (mesh.n_triangles, 1))
    scene = build_scene(mesh, tri_abs)
    print(f"scene: {scene.n_triangles} triangles, 4 absorption bands")

    params = ar.TraceParams(sample_rate=16000, ir_length=16000,
                            base_power=3.62, max_bounces=3, n_bands=4)
    sc = ar.scene_to_arrays(scene)
    dirs = sampling.sample_directions(jax.random.PRNGKey(0), 100_000)
    ir = np.asarray(ar.trace_ir(
        sc, dirs, jnp.zeros(3), jnp.array([1.2, 0.3, 0.0]), 0.0, params,
        ar.TracerOptions(backend="xla")))
    print(f"banded IR {ir.shape}; per-band energy:")
    for b, e in enumerate(ir.sum(axis=(0, 2))):
        print(f"  band {b} (absorption {BAND_ABSORPTION[b]}): {e:.4e}")
    # reverberation decays faster in the absorbent bands
    late = ir[:, :, 8000:].sum(axis=(0, 2))
    early = ir[:, :, :8000].sum(axis=(0, 2)) + 1e-12
    print("late/early ratio per band:", np.round(late / early, 4))


if __name__ == "__main__":
    main()
