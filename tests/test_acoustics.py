"""Room-acoustics metrics: analytic checks on synthetic decays, plus a
physics sanity check against the tracer (more absorption -> shorter RT60)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import audiorenderingv2 as ar
from audiorenderingv2 import testing
from audiorenderingv2.core import sampling
from audiorenderingv2.utils import acoustics

SR = 8000


def exponential_ir(rt60_s: float, seconds: float = 2.0) -> np.ndarray:
    """Energy IR decaying 60 dB in rt60_s (exact exponential)."""
    n = int(seconds * SR)
    t = np.arange(n) / SR
    return 10.0 ** (-6.0 * t / rt60_s)  # energy: 10^(-60dB * t/rt60 / 10)


@pytest.mark.parametrize("true_rt", [0.3, 0.8, 1.5])
def test_rt60_recovers_exponential(true_rt):
    ir = exponential_ir(true_rt)
    assert acoustics.rt60(ir, SR, "t30") == pytest.approx(true_rt, rel=0.02)
    assert acoustics.rt60(ir, SR, "t20") == pytest.approx(true_rt, rel=0.02)
    assert acoustics.edt(ir, SR) == pytest.approx(true_rt, rel=0.05)


def test_schroeder_starts_at_zero_and_decays():
    c = acoustics.schroeder_curve(exponential_ir(0.5))
    assert c[0] == pytest.approx(0.0, abs=1e-9)
    assert (np.diff(c) <= 1e-12).all()


def test_clarity_and_definition_analytic():
    # all energy in the first 10 ms: infinite clarity, D50 = 1
    ir = np.zeros(SR)
    ir[: SR // 100] = 1.0
    assert acoustics.clarity(ir, SR, 50.0) == np.inf
    assert acoustics.definition(ir, SR) == pytest.approx(1.0)
    # half the energy before 50 ms, half after: C50 = 0 dB, D50 = 0.5
    ir = np.zeros(SR)
    ir[0] = 1.0
    ir[SR // 2] = 1.0
    assert acoustics.clarity(ir, SR, 50.0) == pytest.approx(0.0, abs=1e-9)
    assert acoustics.definition(ir, SR) == pytest.approx(0.5)


def test_drr_isolates_direct_peak():
    ir = np.zeros(SR)
    ir[100] = 10.0   # direct
    ir[2000:2100] = 0.01  # reverb tail, total 1.0
    drr = acoustics.direct_to_reverberant(ir, SR)
    assert drr == pytest.approx(10.0, abs=0.1)  # 10*log10(10/1)


def test_traced_rt60_tracks_absorption():
    """Physical sanity: a more absorbent room must have a shorter RT60."""
    rts = {}
    for a in (0.1, 0.5):
        v, t = testing.box_room((10.0, 8.0, 9.0))
        scene = testing.scene_from_arrays(v, t, a)
        sc = ar.scene_to_arrays(scene, 128)
        params = ar.TraceParams(sample_rate=SR, ir_length=2 * SR,
                                base_power=3.62, max_bounces=60)
        dirs = sampling.sample_directions(jax.random.PRNGKey(0), 4096)
        ir = np.asarray(ar.trace_ir(
            sc, dirs, jnp.zeros(3), jnp.array([2.0, 0.0, 1.0]), 0.0, params,
            ar.TracerOptions(block_size=1024, tri_chunk=128)))
        rts[a] = acoustics.rt60(ir.sum(axis=0), SR, "t20")
    assert rts[0.5] < rts[0.1] * 0.6
    assert 0.005 < rts[0.5] < rts[0.1] < 5.0


def test_summary_shapes():
    ir = np.stack([exponential_ir(0.4), exponential_ir(0.4) * 0.8])
    s = acoustics.summarize(ir, SR)
    assert set(s) == {"rt60_t30_s", "rt60_t20_s", "edt_s", "c50_db",
                      "c80_db", "d50", "drr_db"}
    assert s["rt60_t30_s"] == pytest.approx(0.4, rel=0.03)
