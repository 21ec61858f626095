"""Walkthrough HTML exporter (utils/webview.py) — the headless stand-in for
the reference's interactive GL debug view (main.cpp:720-778, Camera.cpp)."""
import base64
import json
import re

import numpy as np

import audiorenderingv2 as ar
from audiorenderingv2 import streaming, testing
from audiorenderingv2.io import wav as wav_io
from audiorenderingv2.utils.webview import write_walkthrough_html


def _box_scene():
    v, t = testing.box_room((6.0, 4.0, 5.0))
    return testing.scene_from_arrays(v, t, 0.3)


def _embedded_data(html: str) -> dict:
    m = re.search(r"const DATA = (\{.*?\});\n", html, re.S)
    assert m, "DATA literal not found"
    return json.loads(m.group(1))


def test_walkthrough_embeds_geometry(tmp_path):
    scene = _box_scene()
    out = write_walkthrough_html(scene, tmp_path / "walk.html",
                                 emitter=[0.0, 0.0, 0.0],
                                 receiver=[1.0, 1.6, 2.0],
                                 receiver_yaw_deg=30.0)
    html = out.read_text()
    data = _embedded_data(html)
    tris = np.frombuffer(base64.b64decode(data["tris"]), np.float32)
    t = scene.n_triangles
    assert tris.shape == (t * 9,)
    expect = np.stack([np.asarray(scene.v0)[:t], np.asarray(scene.v1)[:t],
                       np.asarray(scene.v2)[:t]], axis=1).astype(np.float32)
    np.testing.assert_array_equal(tris.reshape(t, 3, 3), expect)
    assert data["emitter"] == [0.0, 0.0, 0.0]
    assert data["receiver"] == [1.0, 1.6, 2.0]
    assert data["yaw_deg"] == 30.0
    # self-contained: no external script/style references
    assert "http://" not in html and "https://" not in html
    assert "<canvas" in html and "requestAnimationFrame" in html


def test_walkthrough_trajectory_roundtrip(tmp_path):
    """The JSON the recorder downloads (times/positions/yaws_deg) feeds
    ListenerTrajectory.from_arrays — the full walk-in-browser ->
    auralize-offline loop."""
    rec = {"times": [0.0, 0.5, 1.2],
           "positions": [[0, 1.6, 0], [0.5, 1.6, 0.2], [1.1, 1.6, 0.6]],
           "yaws_deg": [0.0, 12.0, 25.0]}
    blob = json.loads(json.dumps(rec))  # what the browser writes
    traj = streaming.ListenerTrajectory.from_arrays(
        blob["times"], blob["positions"], blob["yaws_deg"])
    pos, yaw = traj.at(0.85)
    assert 0.5 <= pos[0] <= 1.1 and 12.0 <= yaw <= 25.0
    assert traj.duration == 1.2


def test_walkthrough_embeds_audio(tmp_path):
    scene = _box_scene()
    sr = 16000
    samples = np.zeros((2, sr), np.float32)
    samples[:, 0] = 0.5
    wav_path = tmp_path / "a.wav"
    wav_io.write_wav(str(wav_path), samples, sr)
    out = write_walkthrough_html(scene, tmp_path / "walk.html",
                                 audio_wav_path=wav_path)
    html = out.read_text()
    m = re.search(r'data:audio/wav;base64,([A-Za-z0-9+/=]+)', html)
    assert m
    back = base64.b64decode(m.group(1))
    assert back == wav_path.read_bytes()


def test_yaw_convention_conversion_present():
    """The browser camera yaw (faces sin/−cos) and the package receiver
    yaw (faces cos/sin) differ by 90 degrees; the HTML must convert at
    BOTH boundaries — camera seed and recorder export (r5 review fix:
    without it, recorded walks auralized with the head rotated 90 deg)."""
    import tempfile
    from pathlib import Path

    from audiorenderingv2 import testing
    from audiorenderingv2.utils.webview import write_walkthrough_html

    v, t = testing.box_room((4.0, 3.0, 5.0))
    scene = testing.scene_from_arrays(v, t, 0.3)
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "w.html"
        write_walkthrough_html(scene, path, receiver_yaw_deg=30.0)
        html = path.read_text()
    assert "DATA.yaw_deg*Math.PI/180 + Math.PI/2" in html
    assert "yaw*180/Math.PI-90" in html
