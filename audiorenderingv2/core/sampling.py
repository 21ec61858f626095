"""Ray direction sampling.

Deterministic counter-based replacement for the reference's clock64-seeded
curand (devicePrograms.cu:216-224): same uniform-sphere mapping
(theta = 2*pi*u1, phi = acos(2*u2 - 1)), but keyed by jax.random so IRs are
reproducible and testable — the reference's Monte-Carlo noise harness
(Experimentation.cpp) measured run-to-run variance precisely because its RNG
was not reproducible.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def sample_directions(key: jax.Array, n: int, dtype=jnp.float32,
                      rng_impl: str = "threefry") -> jax.Array:
    """Uniform directions on the unit sphere, shape [n, 3].

    ``rng_impl``: "threefry" (jax default — bit-reproducible across
    backends) or "rbg"/"unsafe_rbg" (XLA RngBitGenerator; a different
    stream, still deterministic per key). The reference's curand stream was clock64-seeded and not
    reproducible at all (devicePrograms.cu:216-224), so either impl is
    strictly stronger than the semantics being replaced.
    """
    if rng_impl != "threefry":
        data = key if key.dtype == jnp.uint32 else jax.random.key_data(key)
        key = jax.random.wrap_key_data(
            jnp.concatenate([data, data]).astype(jnp.uint32), impl=rng_impl)
    u = jax.random.uniform(key, (n, 2), dtype=jnp.float32)
    theta = 2.0 * jnp.pi * u[:, 0]
    cos_phi = 2.0 * u[:, 1] - 1.0
    sin_phi = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_phi * cos_phi))
    d = jnp.stack(
        [sin_phi * jnp.cos(theta), sin_phi * jnp.sin(theta), cos_phi], axis=-1
    )
    return d.astype(dtype)
