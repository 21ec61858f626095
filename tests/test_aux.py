"""Auxiliary subsystems: IR dumps, checkpoint/resume, plotting, profiling."""
import numpy as np
import pytest

import audiorenderingv2 as ar
from audiorenderingv2 import testing
from audiorenderingv2.renderer import AudioRenderer


def make_renderer(tmp_path, **kw):
    v, t = testing.box_room((10.0, 8.0, 9.0))
    scene = testing.scene_from_arrays(v, t, 0.3)
    r = AudioRenderer(scene, ir_seconds=1, sample_rate=8000, n_rays=512,
                      base_power=3.62, max_bounces=5,
                      opts=ar.TracerOptions(block_size=256, tri_chunk=128), **kw)
    r.set_receiver(np.array([2.0, 0.0, 1.0]), 0.0)
    r.dump_dir = str(tmp_path)
    return r


def test_ir_dump_one_shot(tmp_path):
    r = make_renderer(tmp_path)
    r.write_ir_to_file_flag = True
    ir = r.render()
    left = np.loadtxt(tmp_path / "output_ir_left.txt")
    np.testing.assert_allclose(left, ir[0], rtol=1e-6)
    assert not r.write_ir_to_file_flag  # one-shot like the reference


def test_output_dump(tmp_path):
    r = make_renderer(tmp_path)
    r.render()
    r.write_output_to_file_flag = True
    sig = np.random.default_rng(0).normal(size=16000).astype(np.float32)
    out = r.convolve_audio_file(sig)
    right = np.loadtxt(tmp_path / "output_convolute_right.txt")
    np.testing.assert_allclose(right, out[1], rtol=1e-5, atol=1e-7)


def test_checkpoint_roundtrip(tmp_path):
    import jax.numpy as jnp
    import optax

    from audiorenderingv2.diff.checkpoint import load_fit_state, save_fit_state

    theta = {"a": jnp.arange(3.0), "b": jnp.ones((2, 2))}
    opt = optax.adam(0.1)
    st = opt.init(theta)
    save_fit_state(tmp_path / "ck", 7, theta, st, [1.0, 0.5])
    restored = load_fit_state(tmp_path / "ck", theta, st)
    assert restored is not None
    step, theta2, st2, losses = restored
    assert step == 7
    np.testing.assert_allclose(np.asarray(theta2["a"]), [0, 1, 2])
    assert losses == [1.0, 0.5]
    assert load_fit_state(tmp_path / "nope", theta, st) is None


def test_fit_resume_continues(tmp_path):
    """A fit interrupted at step N resumes from its checkpoint."""
    from audiorenderingv2.diff import fit_scene_parameters, render_soft_ir

    v, t = testing.box_room((10.0, 8.0, 9.0))
    scene = testing.scene_from_arrays(v, t, 0.35)
    params = ar.TraceParams(sample_rate=4000, ir_length=4000, base_power=3.62,
                            max_bounces=3)
    opts = ar.TracerOptions(block_size=128, tri_chunk=128)
    target = render_soft_ir(scene, params, n_rays=128, emitter=(0, 0, 0),
                            receiver_pos=(1.5, 0.5, -2.0), opts=opts, seed=3)
    kw = dict(n_rays=128, receiver_pos=(1.5, 0.5, -2.0), seed=3, opts=opts,
              checkpoint_path=str(tmp_path / "fit"), checkpoint_every=5)
    first = fit_scene_parameters(scene, target, params, steps=5, **kw)
    resumed = fit_scene_parameters(scene, target, params, steps=10, **kw)
    # the resumed run kept the first 5 losses and added 5 more
    assert len(resumed.losses) == 10
    np.testing.assert_allclose(resumed.losses[:5], first.losses, rtol=1e-6)


def test_plotting(tmp_path):
    pytest.importorskip("matplotlib")
    from audiorenderingv2.utils import plotting

    v, t = testing.box_room()
    scene = testing.scene_from_arrays(v, t, 0.3)
    plotting.plot_scene(scene, tmp_path / "scene.png", emitter=[0, 0, 0],
                        receiver=[2, 0, 1])
    ir = np.zeros((2, 1000))
    ir[0, 100] = 1.0
    plotting.plot_ir(ir, 8000, tmp_path / "ir.png")
    plotting.plot_signal(np.sin(np.linspace(0, 20, 800))[None], 8000,
                         tmp_path / "sig.png")
    np.savetxt(tmp_path / "output_ir_left_1.txt", ir[0])
    n = plotting.plot_ir_files(tmp_path, "output_ir_left", tmp_path / "batch.png")
    assert n == 1
    for f in ["scene.png", "ir.png", "sig.png", "batch.png"]:
        assert (tmp_path / f).stat().st_size > 1000
