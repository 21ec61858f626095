"""Experimentation harness: the reference's three-way timing split.

The reference reports "convolute" (device compute, kernels.cu:404-435)
separately from "convolute process" (the full host call including PCIe
staging, main.cpp:566-621); run_experiment must produce two genuinely
distinct measurements, not one number under two names.
"""
import jax.numpy as jnp
import numpy as np

import audiorenderingv2 as ar
from audiorenderingv2 import testing
from audiorenderingv2.experiment import run_experiment
from audiorenderingv2.renderer import AudioRenderer


def make_renderer():
    v, t = testing.box_room((10.0, 8.0, 9.0))
    scene = testing.scene_from_arrays(v, t, 0.3)
    r = AudioRenderer(scene, ir_seconds=1, sample_rate=8000, n_rays=512,
                      base_power=3.62, max_bounces=5,
                      opts=ar.TracerOptions(block_size=256, tri_chunk=128))
    r.set_receiver(np.array([2.0, 0.0, 1.0]), 0.0)
    return r


def test_convolute_and_process_are_distinct_measurements():
    r = make_renderer()
    sig = (np.sin(np.linspace(0, 200, 16000)) * 0.5).astype(np.float32)
    res = run_experiment(r, samples=sig, rounds=3, warmup=1)
    assert len(res.convolute.times_ms) == 3
    assert len(res.convolute_process.times_ms) == 3
    # Independently timed stages: identical lists would mean the old
    # t_proc = t_conv aliasing (the two stages timed as one).
    assert res.convolute.times_ms != res.convolute_process.times_ms
    text = res.summary()
    assert "avg convolute time" in text
    assert "avg convolute process time" in text


def test_device_convolve_matches_host_path():
    r = make_renderer()
    r.render()
    sig = (np.sin(np.linspace(0, 200, 16000)) * 0.5).astype(np.float32)
    host = r.convolve_audio_file(sig)
    dev = np.asarray(r.convolve_audio_file_device(jnp.asarray(sig)))
    np.testing.assert_allclose(dev, host, rtol=1e-6, atol=1e-9)
