"""Config schema tests (defaults mirror Context.cpp:15-165)."""
import json
import os

import pytest

from audiorenderingv2.config import load_config, parse_config

REF = "/root/reference"


def test_defaults_from_empty():
    cfg = parse_config({})
    assert cfg.renderer.ir_length_in_seconds == 2
    assert cfg.renderer.re_render_distance_threshold == 3.0
    assert cfg.renderer.re_render_angle_threshold == 5.0
    assert cfg.scene.mono is False
    assert cfg.scene.initial_receiver_pos == (-2.5, 10.0, 0.0)
    assert cfg.pathtracer.base_power == 100.0
    assert cfg.pathtracer.rays == (100, 100, 100)
    assert cfg.pathtracer.n_rays == 1_000_000
    assert cfg.pathtracer.ray_max_bounces == 10
    assert cfg.pathtracer.hrtf_absorption_rate == 0.9
    assert cfg.is_live  # empty audio path => live-input mode


@pytest.mark.skipif(not os.path.exists(f"{REF}/config.json"),
                    reason="reference config absent")
def test_parse_reference_config(tmp_path):
    with open(f"{REF}/config.json") as f:
        data = json.load(f)
    p = tmp_path / "config.json"
    p.write_text(json.dumps(data))
    cfg = load_config(p)
    assert cfg.renderer.ir_length_in_seconds == 2
    assert cfg.pathtracer.base_power == 3.62
    assert cfg.pathtracer.rays == (100, 100, 100)
    assert cfg.pathtracer.ray_max_bounces == 100
    names = [m.name for m in cfg.pathtracer.materials]
    assert names == ["low", "med", "high", "red", "blue"]
    assert not cfg.is_live


def test_rounding_quirks():
    # thresholds are round()ed on load (Context.cpp:55-61)
    cfg = parse_config({"renderer_parameters": {
        "re_render_distance_threshold": 2.6,
        "re_render_angle_threshold": 4.4,
    }})
    assert cfg.renderer.re_render_distance_threshold == 3.0
    assert cfg.renderer.re_render_angle_threshold == 4.0
    # hrtf rate is NOT rounded (deliberate divergence from Context.cpp:143-145)
    cfg = parse_config({"pathtracer_parameters": {"hrtf_absorption_rate": 0.75}})
    assert cfg.pathtracer.hrtf_absorption_rate == 0.75


def test_unknown_key_warns():
    import warnings

    from audiorenderingv2.config import ConfigWarning

    with pytest.warns(ConfigWarning, match="re_render_distanse"):
        cfg = parse_config({"renderer_parameters":
                            {"re_render_distanse_threshold": 9.0}})
    # behavior stays reference-identical: the typo'd key is ignored
    assert cfg.renderer.re_render_distance_threshold == 3.0

    with pytest.warns(ConfigWarning, match="scene_paramters"):
        parse_config({"scene_paramters": {}})

    # the reference's own never-read key is accepted silently (parity)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        parse_config({"pathtracer_parameters":
                      {"ray_distance_threshold": 10}})
