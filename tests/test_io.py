"""Tests for .obj/.mtl parsing and the WAV codec."""
import os

import numpy as np
import pytest

from audiorenderingv2.config import MaterialSpec
from audiorenderingv2.io import obj as obj_io
from audiorenderingv2.io import wav as wav_io

REF = "/root/reference"


def test_parse_simple_obj(tmp_path):
    p = tmp_path / "tri.obj"
    p.write_text(
        "mtllib tri.mtl\n"
        "v 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 0\n"
        "usemtl red\n"
        "f 1 2 3\n"
        "usemtl blue\n"
        "f 2/1 4/2/3 3//1\n"
        "f -4 -3 -2 -1\n"  # quad with negative indices -> 2 tris
    )
    (tmp_path / "tri.mtl").write_text("newmtl red\nKd 1 0 0\nnewmtl blue\n")
    mesh = obj_io.load_obj(p)
    assert mesh.vertices.shape == (4, 3)
    assert mesh.n_triangles == 4
    assert mesh.material_names == ["red", "blue"]
    np.testing.assert_array_equal(mesh.tri_material, [0, 1, 1, 1])
    np.testing.assert_array_equal(mesh.triangles[1], [1, 3, 2])
    np.testing.assert_array_equal(mesh.triangles[2], [0, 1, 2])
    np.testing.assert_array_equal(mesh.triangles[3], [0, 2, 3])


def test_absorption_resolution_default():
    mats = [MaterialSpec("red", 0.2), MaterialSpec("blue", 0.9)]
    per = obj_io.resolve_absorption(["red", "unknown", "blue"], mats)
    # unmatched names and the trailing no-material slot default to 0.5
    np.testing.assert_allclose(per, [0.2, 0.5, 0.9, 0.5])


@pytest.mark.skipif(not os.path.exists(REF), reason="reference assets absent")
def test_parse_reference_scene():
    mesh = obj_io.load_obj(f"{REF}/assets/models/3D_U.obj")
    assert mesh.n_triangles > 0
    assert len(mesh.material_names) > 0
    lo, hi = mesh.bounds()
    assert np.all(hi > lo)


def test_wav_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    x = (rng.uniform(-1, 1, (2, 1000)) * 0.9).astype(np.float32)
    for depth, tol in [(16, 1e-4), (24, 1e-6), (32, 1e-7), (-32, 1e-7)]:
        p = tmp_path / f"t{depth}.wav"
        wav_io.write_wav(p, x, 16000, bit_depth=depth)
        back = wav_io.read_wav(p)
        assert back.sample_rate == 16000
        assert back.samples.shape == (2, 1000)
        np.testing.assert_allclose(back.samples, x, atol=tol)


@pytest.mark.skipif(not os.path.exists(REF), reason="reference assets absent")
def test_read_reference_wav():
    a = wav_io.read_wav(f"{REF}/assets/sound_samples/guitar_sample_16k.wav")
    assert a.sample_rate == 16000
    assert a.n_frames > 16000
    assert np.abs(a.samples).max() <= 1.0


def test_normalize_range():
    x = np.array([1.0, 3.0, 2.0])
    y = wav_io.normalize_minus_one_to_one(x)
    np.testing.assert_allclose(y, [-1.0, 1.0, 0.0])


def test_wav_odd_payload_word_aligned(tmp_path):
    """RIFF chunks must be word-aligned: odd data payloads get a pad byte."""
    p = tmp_path / "odd.wav"
    x = np.array([[0.1, -0.2, 0.3]], np.float32)  # mono, 3 frames, 24-bit = 9 B
    wav_io.write_wav(p, x, 8000, bit_depth=24)
    raw = p.read_bytes()
    assert len(raw) % 2 == 0
    back = wav_io.read_wav(p)
    assert back.n_frames == 3
    np.testing.assert_allclose(back.samples, x, atol=1e-6)


def test_unmatched_config_material_warns():
    from audiorenderingv2.config import ConfigWarning

    mats = [MaterialSpec("red", 0.2), MaterialSpec("typo", 0.9)]
    with pytest.warns(ConfigWarning, match="typo"):
        per = obj_io.resolve_absorption(["red", "blue"], mats)
    # resolution behavior itself is unchanged (silent 0.5 default)
    np.testing.assert_allclose(per, [0.2, 0.5, 0.5])


@pytest.mark.parametrize("bits", [16, 24, 32])
def test_aiff_roundtrip(tmp_path, bits):
    rng = np.random.default_rng(0)
    x = rng.uniform(-0.9, 0.9, size=(2, 777)).astype(np.float32)
    p = tmp_path / "t.aiff"
    wav_io.write_aiff(p, x, 22050, bit_depth=bits)
    a = wav_io.read_audio(p)
    assert a.sample_rate == 22050
    assert a.samples.shape == (2, 777)
    tol = {16: 1e-4, 24: 5e-7, 32: 1e-7}[bits]
    np.testing.assert_allclose(a.samples, x, atol=tol)


def test_aiff_via_stdlib_reader(tmp_path):
    # Cross-check the 80-bit float + big-endian PCM encode against numpy
    # independent decode of the raw chunks.
    p = tmp_path / "m.aif"
    x = (np.sin(np.linspace(0, 20, 500, dtype=np.float32)) * 0.5)[None]
    wav_io.write_aiff(p, x, 48000, bit_depth=16)
    raw = p.read_bytes()
    assert raw[:4] == b"FORM" and raw[8:12] == b"AIFF"
    a = wav_io.read_aiff(p)
    assert a.sample_rate == 48000
    assert a.n_frames == 500


def test_read_audio_dispatch(tmp_path):
    x = np.zeros((1, 10), np.float32)
    wav_io.write_wav(tmp_path / "a.wav", x, 8000)
    wav_io.write_aiff(tmp_path / "a.aiff", x, 8000)
    assert wav_io.read_audio(tmp_path / "a.wav").sample_rate == 8000
    assert wav_io.read_audio(tmp_path / "a.aiff").sample_rate == 8000
    (tmp_path / "bad.bin").write_bytes(b"XXXXXXXX")
    with pytest.raises(ValueError):
        wav_io.read_audio(tmp_path / "bad.bin")


def test_aifc_sowt_24bit_roundtrip(tmp_path):
    """24-bit little-endian ('sowt') AIFC decodes as audio, not as
    byte-swapped noise (r5 review fix)."""
    import struct

    from audiorenderingv2.io import wav as wav_io

    sr = 8000
    x = (np.sin(2 * np.pi * 440 * np.arange(64) / sr)).astype(np.float32)
    v = np.clip((x * 8388607).astype(np.int64), -(1 << 23), (1 << 23) - 1)
    v24 = np.where(v < 0, v + (1 << 24), v).astype(np.uint32)
    le = np.zeros((64, 3), np.uint8)
    le[:, 0] = v24 & 0xFF
    le[:, 1] = (v24 >> 8) & 0xFF
    le[:, 2] = (v24 >> 16) & 0xFF
    ssnd_body = struct.pack(">II", 0, 0) + le.tobytes()

    def f80(rate):
        # minimal 80-bit float encode for integer rates
        import math

        m, e = math.frexp(rate)
        mant = int(m * (1 << 64))
        return struct.pack(">HQ", 16382 + e, mant)

    comm = struct.pack(">hIh", 1, 64, 24) + f80(sr) + b"sowt" + b"\x00\x00"
    chunks = (b"COMM" + struct.pack(">I", len(comm)) + comm
              + b"SSND" + struct.pack(">I", len(ssnd_body)) + ssnd_body)
    form = b"AIFC" + chunks
    data = b"FORM" + struct.pack(">I", len(form)) + form
    p = tmp_path / "t.aifc"
    p.write_bytes(data)
    audio = wav_io.read_audio(p)
    assert audio.sample_rate == sr
    np.testing.assert_allclose(audio.samples[0], x, atol=2e-6)


def test_wav_malformed_fmt_raises_value_error(tmp_path):
    import struct

    from audiorenderingv2.io import wav as wav_io

    # zero channels
    fmt = struct.pack("<HHIIHH", 1, 0, 8000, 16000, 2, 16)
    body = (b"fmt " + struct.pack("<I", len(fmt)) + fmt
            + b"data" + struct.pack("<I", 4) + b"\0\0\0\0")
    data = b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WAVE" + body
    p = tmp_path / "bad.wav"
    p.write_bytes(data)
    with pytest.raises(ValueError):
        wav_io.read_wav(p)
    # truncated fmt chunk
    body = (b"fmt " + struct.pack("<I", 6) + b"\1\0\1\0\0\0"
            + b"data" + struct.pack("<I", 0))
    data = b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WAVE" + body
    p.write_bytes(data)
    with pytest.raises(ValueError):
        wav_io.read_wav(p)
