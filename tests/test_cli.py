"""CLI contract tests: the reference's <config> [mode] [export_path] argv
surface (main.cpp:720-778), driven in-process against a tiny scene."""
import json

import numpy as np
import pytest

from audiorenderingv2 import cli, testing
from audiorenderingv2.io import wav as wav_io


@pytest.fixture
def tiny_setup(tmp_path):
    v, t = testing.box_room((10.0, 8.0, 9.0))
    obj = tmp_path / "room.obj"
    lines = ["# test room"]
    lines += [f"v {x} {y} {z}" for x, y, z in v]
    lines += [f"f {a+1} {b+1} {c+1}" for a, b, c in t]
    obj.write_text("\n".join(lines))

    wav = tmp_path / "in.wav"
    sig = (np.sin(np.linspace(0, 300, 16000)) * 0.5).astype(np.float32)
    wav_io.write_wav(wav, sig, 8000)

    cfg = tmp_path / "config.json"
    cfg.write_text(json.dumps({
        "renderer_parameters": {"ir_length_in_seconds": 1},
        "scene_parameters": {
            "audio_file_path": str(wav),
            "scene_file_path": str(obj),
            "initial_receiver_pos": {"x": 2.0, "y": 0.0, "z": 1.0},
            "initial_emitter_pos": {"x": 0.0, "y": 0.0, "z": 0.0}},
        "pathtracer_parameters": {"base_power": 3.62,
                                   "rays": {"x": 8, "y": 8, "z": 8},
                                   "ray_max_bounces": 4},
    }))
    return cfg, tmp_path


def test_export_mode(tiny_setup, capsys):
    cfg, tmp = tiny_setup
    out = tmp / "export.wav"
    assert cli.main([str(cfg), "export", str(out)]) == 0
    audio = wav_io.read_wav(out)
    assert audio.n_channels == 2
    assert audio.sample_rate == 8000
    assert np.abs(audio.samples).max() > 0.9  # normalized to [-1, 1]


def test_main_mode_walkthrough(tiny_setup):
    cfg, tmp = tiny_setup
    out = tmp / "walk.wav"
    assert cli.main([str(cfg), "main", str(out), "--duration", "1.0"]) == 0
    audio = wav_io.read_wav(out)
    assert audio.n_frames == 8000
    assert np.isfinite(audio.samples).all()


def test_experimentation_mode(tiny_setup, capsys):
    cfg, _ = tiny_setup
    assert cli.main([str(cfg), "experimentation", "--rounds", "3"]) == 0
    text = capsys.readouterr().out
    assert "median render time" in text
    assert "coefficient of variation" in text


def test_live_mode_main_errors_cleanly(tiny_setup, capsys, tmp_path):
    cfg, _ = tiny_setup
    data = json.loads(cfg.read_text())
    data["scene_parameters"]["audio_file_path"] = ""
    cfg2 = tmp_path / "live.json"
    cfg2.write_text(json.dumps(data))
    assert cli.main([str(cfg2), "main"]) == 1


def test_bad_mode_rejected(tiny_setup):
    cfg, _ = tiny_setup
    with pytest.raises(SystemExit):
        cli.main([str(cfg), "nonsense"])


def test_walkthrough_mode(tiny_setup, capsys):
    cfg, tmp = tiny_setup
    out = tmp / "walk.html"
    assert cli.main([str(cfg), "walkthrough", str(out)]) == 0
    html = out.read_text()
    assert "<canvas" in html and "const DATA" in html


def test_main_mode_recorded_trajectory(tiny_setup):
    """A browser-recorded trajectory JSON drives main-mode auralization."""
    cfg, tmp = tiny_setup
    traj = tmp / "traj.json"
    traj.write_text(json.dumps({
        "times": [0.0, 0.5, 1.0],
        "positions": [[2.0, 0.0, 1.0], [2.5, 0.0, 1.5], [3.0, 0.0, 2.0]],
        "yaws_deg": [0.0, 20.0, 45.0]}))
    out = tmp / "walked.wav"
    assert cli.main([str(cfg), "main", str(out), "--duration", "1.0",
                     "--trajectory", str(traj)]) == 0
    audio = wav_io.read_wav(out)
    assert audio.n_frames == 8000
    assert np.isfinite(audio.samples).all()
