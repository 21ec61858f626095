"""CPU reference tracer — the correctness oracle.

A deliberately simple numpy implementation of the reference's path-tracing
semantics (devicePrograms.cu:62-254), written with per-ray Python loops and
classic Möller–Trumbore intersection — a different formulation from the XLA
tracer's precomputed plane/barycentric matmuls, so the two implementations
cross-check each other. Used by the test suite for allclose comparisons
(the test pyramid the reference lacks; see SURVEY.md section 4) and by the
gradient tests as the finite-difference baseline.

Semantics mirrored from the reference device code:
  * per-ray energy = base_power / (n_rays * sphere_volume)   (cu:207-208)
  * bounce loop while {dist < ir_s*343+1, energy > thres,
    0 <= depth < max_bounces}                                (cu:227-252)
  * receiver = analytic 1 m sphere; deposited energy scaled by the chord
    length of the ray through the sphere                     (cu:91-122)
  * ear from the hit hemisphere in head-local (yaw) frame — the reference's
    left/right half-sphere meshes occupy z<0 / z>0 in object space
    (assets/models/leftHalf.obj / rightHalf.obj) and are rotated by -yaw
    around Y on placement (OptixModel.cpp:175-195)
  * bin = round(dist / 343 * sr); drop if >= ir_length       (cu:131-134)
  * cross-ear write at +int(sr*0.00044) samples, scaled by
    (1 - hrtf_absorption_rate); falls back to the same bin on overflow
    (cu:124-168)
  * surface: specular reflect, energy *= (1 - absorption), pos offset by
    1e-3 along the new direction                             (cu:171-179)
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import constants


@dataclass(frozen=True)
class TraceParams:
    """Static tracing parameters (shared by oracle and XLA tracer)."""

    sample_rate: int
    ir_length: int  # bins = ir_seconds * sample_rate
    base_power: float = 100.0
    energy_threshold: float = 0.0
    max_bounces: int = 10
    hrtf_absorption_rate: float = constants.DEFAULT_HRTF_ABSORPTION
    is_mono: bool = False
    # Frequency bands for per-band absorption (1 = the reference's broadband
    # behavior). With B > 1 the scene's absorption is [T, B], rays carry a
    # per-band energy vector, and the IR gains a band axis [2, B, bins].
    n_bands: int = 1

    @property
    def distance_threshold(self) -> float:
        ir_seconds = max(constants.IR_SECONDS_MIN,
                         min(self.ir_length // self.sample_rate, constants.IR_SECONDS_MAX))
        return ir_seconds * constants.SPEED_OF_SOUND + 1.0

    @property
    def cross_ear_delay(self) -> int:
        # C truncation, not rounding (devicePrograms.cu:125).
        return int(self.sample_rate * constants.HEAD_DELAY_SECONDS)


def _intersect_brute(origin, direction, v0, v1, v2, t_min=constants.T_MIN):
    """Möller–Trumbore against all triangles; returns (t, tri_index) of the
    nearest hit or (inf, -1)."""
    e1 = v1 - v0
    e2 = v2 - v0
    pvec = np.cross(direction[None, :], e2)
    det = np.einsum("ij,ij->i", e1, pvec)
    ok = np.abs(det) > 1e-12
    inv_det = np.where(ok, 1.0 / np.where(det == 0, 1.0, det), 0.0)
    tvec = origin[None, :] - v0
    u = np.einsum("ij,ij->i", tvec, pvec) * inv_det
    qvec = np.cross(tvec, e1)
    v = np.einsum("ij,j->i", qvec, direction) * inv_det
    t = np.einsum("ij,ij->i", e2, qvec) * inv_det
    eps = 1e-7
    ok &= (u >= -eps) & (v >= -eps) & (u + v <= 1.0 + eps) & (t > t_min)
    t = np.where(ok, t, np.inf)
    i = int(np.argmin(t))
    return (float(t[i]), i) if np.isfinite(t[i]) else (np.inf, -1)


def _sphere_entry(origin, direction, center, radius=constants.RECEIVER_RADIUS,
                  t_min=constants.T_MIN):
    """First crossing of the receiver sphere along the ray.

    Returns (t_hit, chord) with t_hit = inf when the sphere is missed. The
    chord is the full secant length through the sphere — the reference's
    energy factor |intersection1 - intersection2| (devicePrograms.cu:111-120).
    """
    oc = origin - center
    b = float(np.dot(oc, direction))
    c = float(np.dot(oc, oc)) - radius * radius
    disc = b * b - c
    if disc <= 0.0:
        return np.inf, 0.0
    s = float(np.sqrt(disc))
    t1, t2 = -b - s, -b + s
    if t1 > t_min:
        return t1, t2 - t1
    if t2 > t_min:
        return t2, t2 - t1  # origin inside the sphere: hit the far surface
    return np.inf, 0.0


def _ear_of_point(p, center, yaw_deg):
    """0 = left, 1 = right. Head-local z sign after undoing the placement
    rotation R(-yaw) about Y (OptixModel.cpp:179-184; Camera.cpp:31-41)."""
    theta = np.radians(yaw_deg)
    d = p - center
    local_z = -np.sin(theta) * d[0] + np.cos(theta) * d[2]
    return 0 if local_z < 0.0 else 1


def trace_ir_reference(
    scene,
    directions: np.ndarray,
    emitter: np.ndarray,
    receiver_pos: np.ndarray,
    receiver_yaw_deg: float,
    params: TraceParams,
    n_total_rays: int | None = None,
) -> np.ndarray:
    """Trace rays and accumulate the stereo IR histogram.

    Args:
      scene: a :class:`audiorenderingv2.scene.Scene` (only v0/triangles
        reconstruction fields + absorption + normal are used).
      directions: float [N, 3] unit directions.
      emitter / receiver_pos: float [3].
      receiver_yaw_deg: listener yaw in degrees (atan2(z, x) convention).
      n_total_rays: energy normalizer when this call traces a shard of a
        larger launch.

    Returns float64 [2, ir_length] (or [2, n_bands, ir_length] for banded
    absorption) — (left, right). Mono folding (kernels.cu:519-536) is
    applied by the renderer, not here.
    """
    t_tris = scene.n_triangles
    v0 = scene.v0[:t_tris].astype(np.float64)
    # Reconstruct v1/v2 from the plane/barycentric data is lossy; the Scene
    # keeps the soup implicitly. Use the original triangle arrays instead.
    normal = scene.normal[:t_tris].astype(np.float64)
    absorption = scene.absorption[:t_tris].astype(np.float64)
    v1 = scene.v1[:t_tris].astype(np.float64)
    v2 = scene.v2[:t_tris].astype(np.float64)

    emitter = np.asarray(emitter, dtype=np.float64)
    center = np.asarray(receiver_pos, dtype=np.float64)
    directions = np.asarray(directions, dtype=np.float64)

    n = directions.shape[0]
    n_total = n_total_rays if n_total_rays is not None else n
    e0 = params.base_power / (n_total * constants.SPHERE_VOLUME)

    n_bands = params.n_bands
    if absorption.ndim == 1:
        absorption = absorption[:, None]  # broadcast broadband over bands

    ir = np.zeros((2, n_bands, params.ir_length), dtype=np.float64)
    delay = params.cross_ear_delay
    dist_thresh = params.distance_threshold

    for r in range(n):
        d = directions[r]
        pos = emitter.copy()
        dist = 0.0
        energy = np.full(n_bands, e0)
        depth = 0
        while (dist < dist_thresh and energy.max() > params.energy_threshold
               and 0 <= depth < params.max_bounces):
            t_tri, tri = _intersect_brute(pos, d, v0, v1, v2)
            t_sph, chord = _sphere_entry(pos, d, center)
            if t_sph < t_tri:
                dist += t_sph
                energy = energy * chord
                p = pos + t_sph * d
                ear = _ear_of_point(p, center, receiver_yaw_deg)
                b = int(round(dist / constants.SPEED_OF_SOUND * params.sample_rate))
                if b < params.ir_length:
                    ir[ear, :, b] += energy
                    if not params.is_mono:
                        cb = b + delay if b + delay < params.ir_length else b
                        ir[1 - ear, :, cb] += energy * (1.0 - params.hrtf_absorption_rate)
                break
            if not np.isfinite(t_tri):
                break  # miss kills the ray (devicePrograms.cu:186-190)
            dist += t_tri
            p = pos + t_tri * d
            nrm = normal[tri]
            d = d - 2.0 * np.dot(d, nrm) * nrm
            energy = energy * (1.0 - absorption[tri])
            depth += 1
            pos = p + constants.BOUNCE_EPSILON * d
    return ir if n_bands > 1 else ir[:, 0, :]
