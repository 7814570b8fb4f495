"""Per-tetrahedron volume constraints (jnp).

The volumetric XPBD constraint family: C_t = 6*(V_t - p * V0_t) per tet,
with the classic analytic gradients.  This is the standard way to build
solid (as opposed to shell) soft bodies in PBD/XPBD, and it is exactly the
capability the reference seeded but never wired: ``CalculateVolume``
(``XPBDSimulatorCS.compute:220-223``) computes a *tetrahedron* volume
``dot(cross(d1, d2), d3) / 6``, and ``AddVolumeConstraints``
(``SoftBodySimulator.cs:187-212``, commented out of the call path) walks
cube cells intending per-cell volume preservation.  Here each lattice cell
(or imported solid) is decomposed into tets (``topology/tets.py``) and each
tet carries one XPBD constraint.

Working with 6V (the raw triple product) rather than V keeps the constraint
and its gradients free of a 1/6 that would otherwise just rescale compliance;
rest volumes are stored pre-multiplied the same way so C has consistent
units.  Gradients of 6V:

    g1 = (p2 - p0) x (p3 - p0)        (d 6V / d p1)
    g2 = (p3 - p0) x (p1 - p0)
    g3 = (p1 - p0) x (p2 - p0)
    g0 = -(g1 + g2 + g3)

Only position *differences* enter (translation invariance), which is what
lets the windowed/fused backends reuse the bending machinery's signed
one-hot gathers (grad_root = -(sum of tip grads), same as the hinge root).
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

from ..core.config import SolverConfig


def _dot3(a, b):
    """Row-wise dot of (..., 3) vectors at HIGHEST precision: on a GPU a
    DEFAULT-precision f32 dot may multiply in TF32 (about three decimal
    digits); HIGHEST keeps it f32 and leaves the CPU's arithmetic as it
    was."""
    return jnp.einsum("...i,...i->...", a, b,
                      precision=lax.Precision.HIGHEST)


def tet_volume6(p0, p1, p2, p3):
    """6x the signed tet volume: dot(p1-p0, cross(p2-p0, p3-p0))."""
    return _dot3(p1 - p0, jnp.cross(p2 - p0, p3 - p0))


def tet_volumes6(positions, tets):
    """(T,) 6x signed volumes for an index array of tets."""
    p = positions[tets]                       # (T, 4, 3)
    return tet_volume6(p[..., 0, :], p[..., 1, :], p[..., 2, :], p[..., 3, :])


def tet_delta_lambda_rel(e1, e2, e3, w0, w1, w2, w3, rest_vol6,
                         compliance, lam, dt, cfg: SolverConfig):
    """XPBD projection in relative coordinates (e_i = p_i - p0).

    Returns (delta_lambda, g0, g1, g2, g3) with gradients of 6V.  The
    windowed/fused backends call this form directly (they gather the
    differences, not the absolute positions).
    """
    g1 = jnp.cross(e2, e3)
    g2 = jnp.cross(e3, e1)
    g3 = jnp.cross(e1, e2)
    g0 = -(g1 + g2 + g3)
    vol6 = _dot3(e1, g1)
    c = vol6 - cfg.tet_pressure * rest_vol6
    alpha = compliance / (dt * dt)
    denom = (w0 * _dot3(g0, g0) + w1 * _dot3(g1, g1)
             + w2 * _dot3(g2, g2) + w3 * _dot3(g3, g3) + alpha)
    # degenerate tet (all gradients ~0, e.g. fully collapsed) or all-pinned:
    # skip, mirroring the distance solver's denominator guard.  Safe-where
    # divisor keeps the division VJP finite on skipped/padded lanes
    # (forward-bitwise-equal to maximum(denom, 1e-30) on valid lanes).
    valid = denom > cfg.eps_denominator
    dl = (-c - alpha * lam) / jnp.where(valid, denom, 1.0)
    dl = jnp.where(valid, dl, 0.0)
    return dl, g0, g1, g2, g3


def tet_delta_lambda(p0, p1, p2, p3, w0, w1, w2, w3, rest_vol6,
                     compliance, lam, dt, cfg: SolverConfig):
    """XPBD projection from absolute endpoint positions."""
    return tet_delta_lambda_rel(p1 - p0, p2 - p0, p3 - p0,
                                w0, w1, w2, w3, rest_vol6,
                                compliance, lam, dt, cfg)
