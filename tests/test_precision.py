"""No contraction on the device path runs at default precision.

On the GPU a float32 ``dot_general`` or convolution at default precision
may run in TF32 (about three significant digits), which would corrupt the
intersection geometry. The tracer therefore writes its dot products as
elementwise multiply-adds; these tests walk the jaxprs of the device
entry points, sub-jaxprs included, and fail on any contraction that does
not ask for full precision.
"""
import jax
from jax.extend import core as jex_core
import jax.numpy as jnp
import numpy as np
import pytest

import audiorenderingv2 as ar
from audiorenderingv2 import testing
from audiorenderingv2.core import sampling
from audiorenderingv2.core.tracer import render_ir, trace_ir
from audiorenderingv2.diff import record_paths, render_ir_replay, replay_events

CONTRACTIONS = ("dot_general", "conv_general_dilated")


def _subjaxprs(value):
    if isinstance(value, jex_core.ClosedJaxpr):
        yield value.jaxpr
    elif isinstance(value, jex_core.Jaxpr):
        yield value
    elif isinstance(value, (tuple, list)):
        for v in value:
            yield from _subjaxprs(v)


def default_precision_contractions(jaxpr) -> list[str]:
    """Names of contraction equations whose precision is unset/DEFAULT."""
    bad = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name in CONTRACTIONS:
            prec = eqn.params.get("precision")
            precs = prec if isinstance(prec, tuple) else (prec,)
            if any(p in (None, jax.lax.Precision.DEFAULT) for p in precs):
                bad.append(f"{eqn.primitive.name}: {eqn.source_info}")
        for v in eqn.params.values():
            for sub in _subjaxprs(v):
                bad.extend(default_precision_contractions(sub))
    return bad


def _setup(n_bands=1):
    v, t = testing.box_room((8.0, 6.0, 7.0))
    ab = (np.full(len(t), 0.3, np.float32) if n_bands == 1
          else np.tile(np.linspace(0.1, 0.6, n_bands, dtype=np.float32),
                       (len(t), 1)))
    scene = testing.scene_from_arrays(v, t, ab)
    sc = ar.scene_to_arrays(scene, 128)
    params = ar.TraceParams(sample_rate=4000, ir_length=2000,
                            base_power=3.62, max_bounces=3, n_bands=n_bands)
    dirs = sampling.sample_directions(jax.random.PRNGKey(0), 64)
    return sc, params, dirs, jnp.zeros(3), jnp.array([1.0, 0.5, -1.0])


def _jaxpr_render(soft, n_bands):
    sc, params, _, em, rec = _setup(n_bands)
    opts = ar.TracerOptions(block_size=64, soft_binning=soft)
    return jax.make_jaxpr(lambda k: render_ir(
        sc, k, 64, em, rec, 0.0, params, opts))(jax.random.PRNGKey(1))


def _jaxpr_replay():
    sc, params, dirs, em, rec = _setup()
    ids, recv = record_paths(sc, dirs, em, rec, 0.0, params)
    return jax.make_jaxpr(lambda d: replay_events(
        sc, ids, recv, d, em, rec, 0.0, params))(dirs)


def _jaxpr_replay_grad():
    sc, params, dirs, em, rec = _setup()
    ids, recv = record_paths(sc, dirs, em, rec, 0.0, params)
    return jax.make_jaxpr(jax.grad(lambda a: jnp.sum(render_ir_replay(
        sc._replace(absorption=sc.absorption * a), ids, recv, dirs, em, rec,
        0.0, params, soft_binning=True))))(1.0)


def _jaxpr_trace_grad():
    sc, params, dirs, em, rec = _setup()
    opts = ar.TracerOptions(block_size=64, soft_binning=True,
                            early_exit=False, remat=True)
    return jax.make_jaxpr(jax.grad(lambda e: jnp.sum(trace_ir(
        sc, dirs, e, rec, 0.0, params, opts))))(em)


def _jaxpr_scene_to_arrays():
    v, t = testing.box_room((8.0, 6.0, 7.0))
    scene = testing.scene_from_arrays(v, t, 0.3)
    return jax.make_jaxpr(lambda ab: ar.scene_to_arrays(
        scene, 128, absorption=ab))(jnp.asarray(scene.absorption))


@pytest.mark.parametrize("build", [
    lambda: _jaxpr_render(soft=False, n_bands=1),
    lambda: _jaxpr_render(soft=True, n_bands=4),
    _jaxpr_replay,
    _jaxpr_replay_grad,
    _jaxpr_trace_grad,
    _jaxpr_scene_to_arrays,
], ids=["render_ir", "render_ir_soft_banded", "replay_events",
        "replay_gradient", "trace_gradient", "scene_to_arrays"])
def test_no_default_precision_contraction(build):
    assert default_precision_contractions(build().jaxpr) == []


def test_walk_flags_a_default_precision_matmul():
    """The walk itself sees a default-precision dot nested in a scan and
    accepts the same dot at HIGHEST precision."""
    def body(c, x, precision):
        return c + jnp.dot(x, x, precision=precision), None

    x = jnp.ones((4, 3, 3))
    bad = jax.make_jaxpr(lambda x: jax.lax.scan(
        lambda c, y: body(c, y, None), jnp.zeros((3, 3)), x))(x)
    good = jax.make_jaxpr(lambda x: jax.lax.scan(
        lambda c, y: body(c, y, jax.lax.Precision.HIGHEST),
        jnp.zeros((3, 3)), x))(x)
    assert len(default_precision_contractions(bad.jaxpr)) == 1
    assert default_precision_contractions(good.jaxpr) == []
