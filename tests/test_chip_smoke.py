"""chip_smoke.py's contract where there is no GPU: it refuses to run, and
its phase selection and last line are what the GPU run relies on."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def _run(cwd, *args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "chip_smoke.py", *args], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def _prints_no_result(proc):
    return '"ok"' not in proc.stdout


def test_exits_nonzero_without_gpu():
    proc = _run(ROOT)
    assert proc.returncode != 0
    assert _prints_no_result(proc)
    assert "GPU" in proc.stderr  # names the missing device


def test_exits_nonzero_alone_in_a_directory(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run(tmp_path)
    assert proc.returncode != 0
    assert _prints_no_result(proc)


def test_rejects_unsupported_card_count():
    proc = _run(ROOT, "--chips", "2")
    assert proc.returncode != 0
    assert _prints_no_result(proc)


@pytest.mark.parametrize("count", [1, 4])
def test_last_line_reports_device_as_jax_does(count):
    dev = SimpleNamespace(platform="gpu", device_kind="NVIDIA H100 80GB HBM3")
    line = json.loads(chip_smoke.last_line([dev] * count))
    assert line == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": count}}


def test_one_card_runs_every_single_card_phase():
    phases = chip_smoke.select_phases(1)
    assert phases == chip_smoke.SINGLE_CARD_PHASES
    assert not set(phases) & set(chip_smoke.FOUR_CARD_PHASES)
    assert {"export", "office", "live", "fit", "oracle", "cpu",
            "histogram"} == set(phases)


def test_four_cards_run_only_the_sharded_path():
    assert chip_smoke.select_phases(4) == ("sharded", "dryrun")


def test_every_phase_has_a_function():
    names = chip_smoke.SINGLE_CARD_PHASES + chip_smoke.FOUR_CARD_PHASES
    assert set(chip_smoke.PHASES) == set(names)
    assert all(callable(f) for f in chip_smoke.PHASES.values())


def test_reference_workload_files(tmp_path):
    """The export phase's inputs: the reference config.json settings over a
    seeded box room and source, loadable by the package's own config."""
    from audiorenderingv2.config import load_config
    from audiorenderingv2.io import wav as wav_io
    from audiorenderingv2.scene import load_scene

    cfg_path = chip_smoke.write_reference_workload(tmp_path, seed=0)
    cfg = load_config(cfg_path)
    assert cfg.pathtracer.n_rays == 1_000_000
    assert cfg.pathtracer.ray_max_bounces == 100
    assert cfg.pathtracer.base_power == 3.62
    assert cfg.pathtracer.hrtf_absorption_rate == 0.9
    assert cfg.renderer.ir_length_in_seconds == 2
    src = wav_io.read_wav(tmp_path / cfg.scene.audio_file_path)
    assert src.sample_rate == 16000 and src.n_frames == 3 * 16000
    scene = load_scene(tmp_path / cfg.scene.scene_file_path,
                       cfg.pathtracer.materials)
    assert scene.n_triangles == 12
    assert (scene.absorption[:12] == pytest.approx(0.3))  # padding follows
