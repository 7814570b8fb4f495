"""Global volume / pressure constraint (jnp).

BASELINE config 3 capability.  The reference carried the seed of this —
``CalculateVolume`` (``XPBDSimulatorCS.compute:220-223``) and the
commented-out ``AddVolumeConstraints`` (``SoftBodySimulator.cs:187-212``) —
but never wired it.  Here: a single XPBD constraint C = V - pressure * V0
over the closed surface, with analytic gradient per vertex accumulated by
segment-sum.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from ..core.config import SolverConfig


def enclosed_volume(positions, triangles):
    p1 = positions[triangles[:, 0]]
    p2 = positions[triangles[:, 1]]
    p3 = positions[triangles[:, 2]]
    # HIGHEST: a DEFAULT-precision f32 dot may run in TF32 on a GPU
    return jnp.sum(jnp.einsum("ij,ij->i", p1, jnp.cross(p2, p3),
                              precision=lax.Precision.HIGHEST)) / 6.0


def volume_gradients(positions, triangles):
    """dV/dp per vertex: for each triangle (p1,p2,p3),
    dV/dp1 = cross(p2,p3)/6 etc., scatter-added per vertex."""
    n = positions.shape[0]
    p1 = positions[triangles[:, 0]]
    p2 = positions[triangles[:, 1]]
    p3 = positions[triangles[:, 2]]
    g1 = jnp.cross(p2, p3) / 6.0
    g2 = jnp.cross(p3, p1) / 6.0
    g3 = jnp.cross(p1, p2) / 6.0
    idx = jnp.concatenate([triangles[:, 0], triangles[:, 1], triangles[:, 2]])
    g = jnp.concatenate([g1, g2, g3], axis=0)
    return jax.ops.segment_sum(g, idx, num_segments=n)


def volume_project(pred, inv_mass, triangles, rest_volume, lam, dt,
                   cfg: SolverConfig):
    """One XPBD projection of the global volume constraint.

    Returns (pred', lam').  C = V - pressure*V0; alpha~ = compliance/dt^2.
    """
    v = enclosed_volume(pred, triangles)
    c = v - cfg.pressure * rest_volume
    grads = volume_gradients(pred, triangles)
    w = inv_mass[:, None]
    s = jnp.sum(inv_mass * jnp.sum(grads * grads, axis=-1))
    alpha = cfg.volume_compliance / (dt * dt)
    denom = s + alpha
    valid = denom > 1e-12
    # safe-where divisor: finite VJP when the body is fully pinned
    # (forward-bitwise-equal to maximum(denom, 1e-30) on valid lanes)
    dl = (-c - alpha * lam) / jnp.where(valid, denom, 1.0)
    dl = jnp.where(valid, dl, 0.0)
    pred = pred + w * dl * grads
    return pred, lam + dl
