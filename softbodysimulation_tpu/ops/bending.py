"""XPBD dihedral (bending) constraint math, batched + branchless (jnp).

Semantics: ``CPUBendingConstraint.Solve`` (``CPUBendingConstraint.cs:40-166``)
with the reference's control-flow bug fixed (the normal-sinTheta branch must
apply corrections; in the reference only the 'soften' band did).  The sinTheta
degeneracy guards become masks: hard skip below ``bend_skip_sin_eps``, soften
compliance by ``bend_soften_factor`` below ``bend_soften_sin_eps``
(``CPUBendingConstraint.cs:92-109``) — all via ``jnp.where`` so no NaNs leak
even through unused branches.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..core.config import SolverConfig
import jax


@jax.custom_jvp
def _safe_arccos(x):
    """arccos with a bitwise-identical primal but a clamped derivative.

    d/dx arccos = -1/sqrt(1-x^2) is inf at |x| = 1 (a FLAT hinge — the
    rest state of any planar mesh), and a zero cotangent times that inf is
    NaN, poisoning every gradient downstream.  Clamping 1-x^2 to 1e-12
    (sin >= 1e-6) only perturbs lanes that ``bend_skip_sin_eps`` (1e-5)
    already marks invalid — so gradients stay exact wherever they are used.
    """
    return jnp.arccos(x)


@_safe_arccos.defjvp
def _safe_arccos_jvp(primals, tangents):
    (x,), (t,) = primals, tangents
    d = -1.0 / jnp.sqrt(jnp.maximum(1.0 - x * x, 1e-12))
    return jnp.arccos(x), d * t


def bending_delta_lambda(pa, pb, pc, pd, wa, wb, wc, wd, rest_angle,
                         compliance, lam, dt, cfg: SolverConfig):
    """Returns (dlambda (K,), grad_a, grad_b, grad_c, grad_d each (K,3)).

    Hinge edge a-b, opposite tips c, d.  C = acos(n1.n2) - rest_angle with
    n1 = normalize((b-a) x (c-a)), n2 = normalize((d-a) x (b-a)).
    """
    return bending_delta_lambda_rel(
        pb - pa, pc - pa, pd - pa, wa, wb, wc, wd, rest_angle,
        compliance, lam, dt, cfg)


def bending_delta_lambda_rel(e0, e1, e2, wa, wb, wc, wd, rest_angle,
                             compliance, lam, dt, cfg: SolverConfig):
    """Same math in hinge-relative coordinates: e0 = pB-pA, e1 = pC-pA,
    e2 = pD-pA (the constraint is translation-invariant, so the windowed
    windowed backend gathers these differences directly via signed one-hots)."""
    n1 = jnp.cross(e0, e1)
    n2 = jnp.cross(e2, e0)
    l1sq = jnp.sum(n1 * n1, axis=-1)
    l2sq = jnp.sum(n2 * n2, axis=-1)
    geom_ok = (l1sq >= 1e-9) & (l2sq >= 1e-9)
    l1 = jnp.sqrt(jnp.maximum(l1sq, 1e-24))
    l2 = jnp.sqrt(jnp.maximum(l2sq, 1e-24))
    n1n = n1 / l1[..., None]
    n2n = n2 / l2[..., None]

    cos = jnp.clip(jnp.sum(n1n * n2n, axis=-1), -1.0, 1.0)
    angle = _safe_arccos(cos)
    c = angle - rest_angle
    sin = jnp.sin(angle)

    sin_ok = jnp.abs(sin) >= cfg.bend_skip_sin_eps
    soften = jnp.abs(sin) < cfg.bend_soften_sin_eps
    inv_dt2 = 1.0 / (dt * dt)
    alpha = compliance * inv_dt2
    alpha = jnp.where(soften, alpha * cfg.bend_soften_factor, alpha)

    inv_sin = 1.0 / jnp.where(sin_ok, sin, 1.0)

    # Analytic gradients of C = acos(n1.n2) - rest, derived by chain rule
    # through the normalized cross products (the reference's own gradient
    # formulas, CPUBendingConstraint.cs:117-124, do not match the gradient of
    # its C — verified against autodiff — so we use the correct ones):
    #   u = e0 x e1, v = e2 x e0, d = u.v/(|u||v|)
    #   dd/du = (n2 - d*n1)/|u|,   dd/dv = (n1 - d*n2)/|v|
    #   grad_b d = e1 x A + B x e2;  grad_c d = A x e0;  grad_d d = e0 x B
    #   grad C = -grad d / sin(theta)
    cos_b = cos[..., None]
    a_vec = (n2n - cos_b * n1n) / l1[..., None]
    b_vec = (n1n - cos_b * n2n) / l2[..., None]
    scale = (-inv_sin)[..., None]
    grad_b = scale * (jnp.cross(e1, a_vec) + jnp.cross(b_vec, e2))
    grad_c = scale * jnp.cross(a_vec, e0)
    grad_d = scale * jnp.cross(e0, b_vec)
    grad_a = -grad_b - grad_c - grad_d

    s = (wa * jnp.sum(grad_a * grad_a, axis=-1)
         + wb * jnp.sum(grad_b * grad_b, axis=-1)
         + wc * jnp.sum(grad_c * grad_c, axis=-1)
         + wd * jnp.sum(grad_d * grad_d, axis=-1))
    denom = s + alpha

    any_dynamic = (
        (wa >= cfg.static_inv_mass_eps) | (wb >= cfg.static_inv_mass_eps)
        | (wc >= cfg.static_inv_mass_eps) | (wd >= cfg.static_inv_mass_eps)
    )
    valid = geom_ok & sin_ok & (denom >= 1e-9) & any_dynamic
    # Safe-where divisor: forward-bitwise-equal to maximum(denom, 1e-30) on
    # valid lanes (denom >= 1e-9 there); keeps the division VJP finite on
    # zero-padded window slots (see ops/distance.py for the failure mode).
    dl = (-c - alpha * lam) / jnp.where(valid, denom, 1.0)
    if cfg.max_dlambda > 0:
        dl = jnp.clip(dl, -cfg.max_dlambda, cfg.max_dlambda)
    dl = jnp.where(valid, dl, 0.0)
    zero = jnp.zeros_like(grad_a)
    vmask = valid[..., None]
    return (dl,
            jnp.where(vmask, grad_a, zero),
            jnp.where(vmask, grad_b, zero),
            jnp.where(vmask, grad_c, zero),
            jnp.where(vmask, grad_d, zero))
