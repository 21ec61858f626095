"""Multi-pose rendering + multi-source auralization.

The reference renders exactly one (emitter, receiver) pair per launch
(LaunchParams.h:20-43). This demo renders a full S x L IR matrix with one
compiled trace vmapped over batches of pairs, then auralizes two dry
sources at every listener with `multi.mix_sources` and exports one WAV per
listener.

Usage:
  python examples/demo_6_multipose.py [out_dir]
  JAX_PLATFORMS=cpu python examples/demo_6_multipose.py   # CPU run
"""
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax

import numpy as np

import audiorenderingv2 as ar
from audiorenderingv2 import multi, testing
from audiorenderingv2.io import wav as wav_io

SR = 16000


def main():
    out_dir = Path(sys.argv[1]) if len(sys.argv) > 1 else Path("demo_multipose")
    out_dir.mkdir(parents=True, exist_ok=True)
    on_cpu = jax.devices()[0].platform == "cpu"

    v, t = testing.box_room((18.0, 10.0, 14.0))
    scene = testing.scene_from_arrays(v, t, 0.25)
    sc = ar.scene_to_arrays(scene, 128)
    params = ar.TraceParams(sample_rate=SR, ir_length=2 * SR,
                            base_power=3.62, max_bounces=40,
                            hrtf_absorption_rate=0.9)
    opts = ar.TracerOptions(rng_impl="threefry" if on_cpu else "rbg")

    # 2 sources x 4 listeners along a walk line
    emitters = np.array([[-5.0, 0.0, -4.0], [6.0, 1.0, 5.0]], np.float32)
    listeners = np.stack([np.linspace(-6.0, 6.0, 4), np.zeros(4),
                          np.linspace(4.0, -4.0, 4)], axis=1).astype(np.float32)
    yaws = np.linspace(0.0, 270.0, 4).astype(np.float32)
    n_rays = 4096 if on_cpu else 250_000

    t0 = time.time()
    irs = multi.render_ir_matrix(sc, jax.random.PRNGKey(0), emitters,
                                 listeners, yaws, n_rays, params, opts,
                                 pair_batch=8)
    print(f"IR matrix {irs.shape} in {time.time() - t0:.2f}s "
          f"({n_rays} rays/pair, vmapped pair batches)")

    # two dry sources: a click train and a tone burst
    tt = np.arange(2 * SR) / SR
    click = (np.sin(2 * np.pi * 6 * tt) > 0.995).astype(np.float32)
    tone = (np.sin(2 * np.pi * 440 * tt)
            * np.exp(-((tt - 0.5) ** 2) / 0.02)).astype(np.float32)
    out = multi.mix_sources(irs, [click, tone], SR)  # [L, 2, len]
    for li in range(out.shape[0]):
        y = out[li] / max(np.abs(out[li]).max(), 1e-9)
        path = out_dir / f"listener_{li}.wav"
        wav_io.write_wav(path, y, SR)
        print(f"wrote {path}")


if __name__ == "__main__":
    main()
