"""BASELINE config #1: sphere scene, single bounce, 10k rays, 16 kHz IR,
convolve guitar_sample_16k.wav.

Runs on whatever backend jax provides (the CPU or one GPU).
Usage: python examples/demo_1_sphere.py [output.wav]
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
from audiorenderingv2.io import wav as wav_io
from audiorenderingv2.ops import convolve

REF_SPHERE = "/root/reference/sphere.obj"
REF_WAV = "/root/reference/guitar_sample_16k.wav"


def main(out_path="demo_sphere.wav"):
    if Path(REF_SPHERE).exists():
        scene = ar.load_scene(REF_SPHERE, [])
    else:
        v, t = testing.icosphere(radius=2.5, subdivisions=2)
        scene = testing.scene_from_arrays(v, t, 0.5)
    print(f"scene: {scene.n_triangles} triangles")

    params = ar.TraceParams(sample_rate=16000, ir_length=16000,
                            base_power=3.62, max_bounces=1)
    sc = ar.scene_to_arrays(scene)
    dirs = sampling.sample_directions(jax.random.PRNGKey(0), 10_000)
    ir = np.asarray(ar.trace_ir(
        sc, dirs, jnp.zeros(3), jnp.array([0.5, 0.0, 0.0]), 30.0, params,
        ar.TracerOptions(backend="xla")))
    print(f"IR: {int((ir != 0).sum())} nonzero bins, peak {ir.max():.3e}")

    if Path(REF_WAV).exists():
        audio = wav_io.read_wav(REF_WAV)
        out = np.asarray(convolve.convolve_file_stereo(
            jnp.asarray(audio.mono()), jnp.asarray(ir), audio.sample_rate))
        out = np.stack([wav_io.normalize_minus_one_to_one(c) for c in out])
        wav_io.write_wav(out_path, out, audio.sample_rate)
        print(f"wrote {out_path} ({out.shape[1] / audio.sample_rate:.1f}s)")


if __name__ == "__main__":
    main(*sys.argv[1:])
