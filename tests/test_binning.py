"""Scatter-add IR histogram vs float64 numpy; soft-binning gradients."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from audiorenderingv2.core import binning


def test_histogram_matches_numpy_scatter():
    rng = np.random.default_rng(1)
    bins = rng.integers(-5, 40, size=5000).astype(np.int32)
    w = rng.normal(size=5000).astype(np.float32)
    out = np.asarray(binning.histogram_sum(jnp.asarray(bins), jnp.asarray(w), 32))
    expect = np.zeros(32, np.float64)
    for b, x in zip(bins, w):
        if 0 <= b < 32:
            expect[b] += x
    np.testing.assert_allclose(out, expect, rtol=1e-4, atol=1e-5)


def test_histogram_jit_and_empty_bins():
    f = jax.jit(lambda b, w: binning.histogram_sum(b, w, 16))
    out = np.asarray(f(jnp.array([3, 3, 200, -1]), jnp.array([1.0, 2.0, 5.0, 7.0])))
    expect = np.zeros(16)
    expect[3] = 3.0
    np.testing.assert_allclose(out, expect)


def test_hard_deposit_rounds():
    from audiorenderingv2.core.tracer import _slot_bins

    bins, fracs = _slot_bins(jnp.array([1.4, 1.6, 2.5]),
                             jnp.array([True, True, True]), 10, soft=False)
    np.testing.assert_array_equal(np.asarray(bins)[:, 0], [1, 2, 2])  # round-half-even on 2.5
    np.testing.assert_allclose(np.asarray(fracs)[:, 0], 1.0)
    # inactive events route to the overflow marker
    bins, _ = _slot_bins(jnp.array([1.4]), jnp.array([False]), 10, soft=False)
    np.testing.assert_array_equal(np.asarray(bins)[:, 0], [10])


def test_soft_deposit_interpolates():
    from audiorenderingv2.core.tracer import _slot_bins

    bins, fracs = _slot_bins(jnp.array([2.25]), jnp.array([True]), 10, soft=True)
    np.testing.assert_array_equal(np.asarray(bins)[0], [2, 3])
    np.testing.assert_allclose(np.asarray(fracs)[0], [0.75, 0.25])


def test_soft_binning_delay_gradient():
    """d(hist)/d(bin position) must exist and match the interpolation slope."""
    from audiorenderingv2.core.tracer import _slot_bins

    def loss(bin_f):
        bins, ws = _slot_bins(bin_f, jnp.ones_like(bin_f, dtype=bool), 8,
                              soft=True)
        hist = binning.histogram_sum(bins, ws, 8)
        return hist[3]  # mass landing in bin 3

    g = jax.grad(loss)(jnp.array([2.4]))
    # moving the event from 2.4 toward 3 raises bin 3's mass at slope +1
    np.testing.assert_allclose(np.asarray(g), [1.0], atol=1e-6)


def test_weight_gradient_through_sort():
    def loss(w):
        hist = binning.histogram_sum(jnp.array([0, 1, 1, 5]), w, 8)
        return hist[1] * 2.0 + hist[5]

    g = jax.grad(loss)(jnp.array([1.0, 1.0, 1.0, 1.0]))
    np.testing.assert_allclose(np.asarray(g), [0.0, 2.0, 2.0, 1.0])


def test_soft_cross_ear_overflow_fallback():
    """A cross-ear deposit whose delayed bin would overflow the IR end
    falls back to the base bin in SOFT mode too (r5 fix of the r4 parity
    delta) — matching hard mode's energy placement in the last `delay`
    samples instead of dropping it."""
    import audiorenderingv2 as ar
    from audiorenderingv2.core.tracer import _histogram_from_events

    params = ar.TraceParams(sample_rate=16000, ir_length=100,
                            base_power=1.0, max_bounces=4,
                            hrtf_absorption_rate=0.25)
    delay = params.cross_ear_delay
    assert delay > 0
    # one event per region: mid-IR (normal cross), tail (overflow)
    ev_bin = jnp.array([50.0, 97.0], jnp.float32)
    ev_w = jnp.array([[1.0], [1.0]], jnp.float32)
    ev_ear = jnp.array([0, 0], jnp.int32)
    hard = np.asarray(_histogram_from_events(ev_bin, ev_w, ev_ear, params,
                                             soft=False))
    soft = np.asarray(_histogram_from_events(ev_bin, ev_w, ev_ear, params,
                                             soft=True))
    # integer-bin events -> soft interp is degenerate; must match hard
    np.testing.assert_allclose(soft, hard, rtol=1e-6, atol=1e-7)
    # and the overflow cross deposit really landed at the base bin
    np.testing.assert_allclose(hard[1, 97], 0.75, rtol=1e-6)
    np.testing.assert_allclose(soft[1, 97], 0.75, rtol=1e-6)
    # energy conservation: nothing dropped in either mode
    np.testing.assert_allclose(soft.sum(), hard.sum(), rtol=1e-6)


def test_histogram_length_mismatch_raises():
    import jax.numpy as jnp
    import pytest

    from audiorenderingv2.core import binning

    with pytest.raises(ValueError, match="weight rows"):
        binning.histogram_sum_banded(jnp.zeros(10, jnp.int32),
                                     jnp.zeros((6, 1)), 16)


def _float64_hist(bins, w, n_bins):
    keep = (bins >= 0) & (bins < n_bins)
    return np.stack([np.bincount(bins[keep], w[keep, k].astype(np.float64),
                                 minlength=n_bins)
                     for k in range(w.shape[1])], axis=1)


@pytest.mark.parametrize("n_bands", [1, 4, 8])
@pytest.mark.parametrize("n_events", [0, 1, 4096, 65536, 1_000_000])
def test_scatter_add_matches_float64(n_events, n_bands):
    """Every occupied bin within 1e-5 of float64, none zeroed, at event
    counts from empty to a 1M-ray render's."""
    rng = np.random.default_rng(n_events + n_bands)
    n_bins = 6000
    bins = rng.integers(-20, n_bins + 20, n_events).astype(np.int32)
    w = rng.uniform(1e-9, 1e-6, (n_events, n_bands)).astype(np.float32)
    got = np.asarray(binning.histogram_sum_banded(
        jnp.asarray(bins), jnp.asarray(w), n_bins))
    ref = _float64_hist(bins, w, n_bins)
    assert got.shape == (n_bins, n_bands)
    occ = ref > 0
    assert (got[~occ] == 0).all()
    assert (got[occ] != 0).all()
    np.testing.assert_allclose(got[occ], ref[occ], rtol=1e-5)


def test_reverb_tail_survives_at_render_scale():
    """Render-shaped input — 1M events into 2 ears x 64,000 bins, weights
    decaying exponentially with the bin — keeps its late, small deposits:
    the failure of a cumsum-difference histogram, whose f32 running sum
    swamps them."""
    rng = np.random.default_rng(0)
    n_bins = 2 * 64000
    bins = np.minimum(rng.exponential(n_bins / 4, 1_000_000),
                      n_bins + 99).astype(np.int32)
    w = (np.exp(-bins / 20000.0) * rng.uniform(0.5, 1.0, bins.size)
         * 1e-6).astype(np.float32)[:, None]
    got = np.asarray(binning.histogram_sum_banded(
        jnp.asarray(bins), jnp.asarray(w), n_bins))[:, 0]
    ref = _float64_hist(bins, w, n_bins)[:, 0]
    occ = ref > 0
    assert (got[occ] != 0).all()
    rel = np.abs(got[occ] - ref[occ]) / ref[occ]
    assert rel.max() <= 1e-5
    tail = occ & (np.arange(n_bins) >= n_bins - 10000)
    assert tail.sum() > 100  # the tail is populated and checked above


@pytest.mark.parametrize("bad_bin", [-1, -(2 ** 31), 64, 65, 2 ** 31 - 1])
def test_out_of_range_bins_dropped(bad_bin):
    """Negative and past-the-end bins land in the spare row, never in a
    real bin (no clamping onto the first or last bin)."""
    bins = jnp.array([3, bad_bin, 63, bad_bin], jnp.int32)
    w = jnp.array([[1.0], [5.0], [2.0], [7.0]], jnp.float32)
    got = np.asarray(binning.histogram_sum_banded(bins, w, 64))[:, 0]
    expect = np.zeros(64)
    expect[3], expect[63] = 1.0, 2.0
    np.testing.assert_array_equal(got, expect)


@pytest.mark.parametrize("n_bands", [1, 4])
def test_banded_weight_gradient_is_gather(n_bands):
    """d(sum(probe * hist))/d(w) is the probe gathered at each event's bin,
    and zero for dropped events."""
    rng = np.random.default_rng(4)
    n_bins = 64
    bins = rng.integers(-3, n_bins + 3, 600).astype(np.int32)
    w = jnp.asarray(rng.random((600, n_bands)), jnp.float32)
    probe = rng.random((n_bins, n_bands)).astype(np.float32)
    g = np.asarray(jax.grad(lambda x: jnp.sum(
        probe * binning.histogram_sum_banded(jnp.asarray(bins), x,
                                             n_bins)))(w))
    keep = (bins >= 0) & (bins < n_bins)
    expect = np.zeros((600, n_bands), np.float32)
    expect[keep] = probe[bins[keep]]
    np.testing.assert_allclose(g, expect, rtol=1e-6)


@pytest.mark.parametrize("position", [2.25, 5.5, 6.9])
def test_soft_delay_gradient_matches_finite_difference(position):
    """The arrival-delay gradient through soft binning + scatter-add equals
    the finite-difference slope of a smooth readout of the histogram."""
    from audiorenderingv2.core.tracer import _slot_bins

    readout = jnp.asarray(np.sin(np.arange(10) * 0.7) + 2.0, jnp.float32)

    def loss(bin_f):
        bins, ws = _slot_bins(bin_f, jnp.ones_like(bin_f, dtype=bool), 10,
                              soft=True)
        return jnp.sum(readout * binning.histogram_sum(bins, ws, 10))

    x = jnp.array([position], jnp.float32)
    g = float(jax.grad(loss)(x)[0])
    eps = 1e-2
    fd = float(loss(x + eps) - loss(x - eps)) / (2 * eps)
    lo = int(np.floor(position))
    assert abs(g - float(readout[lo + 1] - readout[lo])) < 1e-5
    assert abs(g - fd) < 1e-3
