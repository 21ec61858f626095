"""Checkpoint/resume for the inverse-rendering optimization loop.

The reference has no checkpointing at all (SURVEY section 5 — its nearest
analogs are IR txt dumps and WAV export). The optimization loop here can run
for thousands of steps, so it checkpoints (step, params,
optimizer state, loss history) as a plain ``.npz`` — no extra dependencies,
and trivially inspectable.
"""
from __future__ import annotations

from pathlib import Path

import jax
import numpy as np


def save_fit_state(path: str | Path, step: int, theta, opt_state,
                   losses: list[float]) -> None:
    """Snapshot the optimization state to ``path``.npz."""
    path = Path(path)
    flat, treedef = jax.tree.flatten((theta, opt_state))
    np.savez(
        path.with_suffix(".npz"),
        step=np.asarray(step),
        losses=np.asarray(losses, np.float64),
        n_leaves=np.asarray(len(flat)),
        **{f"leaf_{i}": np.asarray(x) for i, x in enumerate(flat)},
    )


def load_fit_state(path: str | Path, theta_like, opt_state_like):
    """Restore (step, theta, opt_state, losses); the *_like pytrees provide
    the structure. Returns None if no checkpoint exists."""
    path = Path(path).with_suffix(".npz")
    if not path.exists():
        return None
    data = np.load(path)
    _, treedef = jax.tree.flatten((theta_like, opt_state_like))
    n = int(data["n_leaves"])
    leaves = [data[f"leaf_{i}"] for i in range(n)]
    theta, opt_state = jax.tree.unflatten(treedef, leaves)
    return int(data["step"]), theta, opt_state, list(data["losses"])
