"""Structured JSONL event logging (utils/logging.py).

The reference's observability is unstructured stdout prints (SURVEY §5);
the rebuild replaces them with structured records. These tests pin the
record shape, file sink behavior, and the renderer wiring.
"""
import json

import numpy as np

import audiorenderingv2 as ar
from audiorenderingv2 import testing
from audiorenderingv2.utils import logging as arlog


def test_event_record_shape(tmp_path):
    path = tmp_path / "events.jsonl"
    log = arlog.EventLogger(str(path))
    rec = log.event("render", ms=12.5, n_rays=1000)
    log.close()
    assert rec["event"] == "render" and rec["ms"] == 12.5
    lines = path.read_text().strip().splitlines()
    assert len(lines) == 1
    parsed = json.loads(lines[0])
    assert parsed["n_rays"] == 1000 and "ts" in parsed


def test_global_logger_silent_until_configured(tmp_path):
    log = arlog.get_logger()
    log.event("noop")  # no sink configured: must not raise
    path = tmp_path / "g.jsonl"
    log = arlog.configure(path=str(path))
    log.event("configured", k=1)
    assert json.loads(path.read_text())["k"] == 1
    arlog.configure()  # reset to silent for other tests


def test_full_render_cycle_emits_record(tmp_path):
    path = tmp_path / "cycle.jsonl"
    arlog.configure(path=str(path))
    try:
        from audiorenderingv2.renderer import AudioRenderer

        v, t = testing.box_room((4.0, 3.0, 3.0))
        scene = testing.scene_from_arrays(v, t, 0.3)
        r = AudioRenderer(scene, ir_seconds=1, sample_rate=8000, n_rays=256,
                          max_bounces=4,
                          opts=ar.TracerOptions(block_size=256))
        r.set_emitter_pos(np.zeros(3, np.float32))
        out = r.full_render_cycle(np.array([1.0, 0.5, 0.0]), 0.0,
                                  np.ones(64, np.float32))
        assert out.shape[0] == 2
        recs = [json.loads(x) for x in
                path.read_text().strip().splitlines()]
        cyc = [x for x in recs if x["event"] == "full_render_cycle"]
        assert len(cyc) == 1
        assert cyc[0]["render_ms"] > 0 and len(cyc[0]["receiver"]) == 3
    finally:
        arlog.configure()
