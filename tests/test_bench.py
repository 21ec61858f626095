"""bench.py's device accounting: the peak table and the test count."""
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import bench  # noqa: E402
from audiorenderingv2.utils.profiling import require_gpus  # noqa: E402


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA A100-SXM4-80GB",
                                  "NVIDIA H100 PCIe", ""])
def test_peak_table_refuses_unknown_device(kind):
    with pytest.raises(ValueError, match="no peak table entry"):
        bench.peak_for(kind)


def test_peak_table_h100_row():
    row = bench.peak_for("NVIDIA H100 80GB HBM3")
    assert row["f32_flops"] == 67e12
    assert row["hbm_bytes_per_s"] == 3.35e12
    assert "data sheet" in row["source"]


def test_tests_per_render_counts_every_padded_triangle():
    # 3 rays: 0, 2 and 5 completed bounces -> 7 bounce tests + 3 final ones
    bounces = np.array([0, 2, 5])
    assert bench.tests_per_render(128, bounces) == (7 + 3) * 128


def test_require_gpus_refuses_the_cpu():
    """No GPU here: the guard exits with the missing device named instead
    of letting a measurement fall back to the CPU."""
    with pytest.raises(SystemExit, match="needs 1 GPU"):
        require_gpus(1)
