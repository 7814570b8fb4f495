"""Stencil XPBD engine for res^3 lattices — the flagship path.

The reference's flagship engine (``SoftBodySimulator`` + ``XPBDSoftBody``)
spends its life marshalling an explicit constraint list through per-color GPU
dispatches (``SoftBodySimulator.cs:590-611``).  On a regular lattice that
machinery is unnecessary: the constraint graph is a fixed set of offset
families (``topology/lattice.py``), so constraint projection becomes dense
shifted-array arithmetic —

  * gather  -> ``jnp.roll`` by the family offset (wraparound killed by a
    precomputed boundary mask),
  * scatter -> the inverse roll of the correction field,
  * graph coloring -> a parity split along the family's leading axis: within
    one parity class no two constraints share a particle, so families x 2
    parities of dense passes give EXACT Gauss-Seidel.

No edge list, no indices, no segment-sum — pure elementwise work.

Layout: component-major ``(3, res, res*res)`` — axis 1 = x-plane, axis 2 =
y*res + z (a long, contiguous minor axis; the naive ``(res,res,res,3)``
layout leaves a 3-wide minor dim and vectorizes terribly).  Offset shifts
become rolls on the two minor axes: x-shift -> axis 1; y/z-shift -> axis 2
by dy*res+dz (wrap leakage across y-rows is exactly the out-of-bounds
region the masks already kill).

State interop: standard ``SimState`` with x-major flattened positions
(index = (x*res + y)*res + z, matching ``SoftBodySimulator.cs:121-144``);
``lambda_dist`` holds the family fields flattened.  Checkpointing,
interaction and diagnostics work unchanged.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..core.config import FloorMode, LambdaMode, SolveMode, SolverConfig
from ..ops import spatial_hash as _spatial_hash
from ..core.state import SimState
from ..topology.lattice import LatticeSpec, lattice_points


def n_lambda(spec: LatticeSpec) -> int:
    return spec.n_families * spec.res ** 3


def make_lattice_state(spec: LatticeSpec, center=(0.0, 0.0, 0.0),
                       mass: float = 1.0, dtype=jnp.float32,
                       tet_volume: bool = False) -> SimState:
    """``tet_volume=True`` sizes ``lambda_tet`` for the stencil engine's
    per-cell tet family (6 Kuhn tets per cell as 6 offset families; enable
    with ``cfg.enable_tet_volume``)."""
    pos = lattice_points(spec.res, spec.size, center)
    n = pos.shape[0]
    inv = 0.0 if mass <= 1e-4 else 1.0 / mass
    return SimState(
        positions=jnp.asarray(pos, dtype),
        velocities=jnp.zeros((n, 3), dtype),
        inv_mass=jnp.full((n,), inv, dtype),
        ext_force=jnp.zeros((n, 3), dtype),
        lambda_dist=jnp.zeros((n_lambda(spec),), dtype),
        lambda_bend=jnp.zeros((0,), dtype),
        lambda_volume=jnp.zeros((), dtype),
        lambda_tet=(jnp.zeros((6 * spec.res ** 3,), dtype)
                    if tet_volume else None),
    )


@functools.lru_cache(maxsize=64)
def _family_masks(spec: LatticeSpec) -> Tuple[np.ndarray, ...]:
    """Per-family (valid, parity0) boolean masks in (res, res*res) layout.

    valid: anchor a has a partner a+d in bounds (with the reference's
    shear/bend anchor quirk when spec.reference_bounds — see
    topology/lattice.py).  parity0: anchor's leading-offset-axis coordinate
    is even.  Within one (family, parity) class no two constraints share a
    particle.
    """
    res = spec.res
    xx, yy, zz = np.meshgrid(np.arange(res), np.arange(res), np.arange(res),
                             indexing="ij")
    out = []
    for fam in spec.families:
        dx, dy, dz, kind = fam
        if spec.reference_bounds and kind != 0:
            valid = (xx < res - 1) & (yy < res - 1) & (zz < res - 1)
        else:
            valid = np.ones((res, res, res), bool)
            for coord, d in ((xx, dx), (yy, dy), (zz, dz)):
                if d > 0:
                    valid &= coord < res - d
                elif d < 0:
                    valid &= coord >= -d
        lead = xx if dx else (yy if dy else zz)
        parity0 = (lead % 2) == 0
        out.append((valid.reshape(res, res * res),
                    parity0.reshape(res, res * res)))
    return tuple(out)


def _roll_fwd(a, fam, res):
    """partner view a[x+dx, y+dy, z+dz] in (..., res, res*res) layout."""
    dx, dy, dz, _ = fam
    if dx:
        a = jnp.roll(a, -dx, axis=a.ndim - 2)
    k = dy * res + dz
    if k:
        a = jnp.roll(a, -k, axis=a.ndim - 1)
    return a


def _roll_bwd(a, fam, res):
    dx, dy, dz, _ = fam
    k = dy * res + dz
    if k:
        a = jnp.roll(a, k, axis=a.ndim - 1)
    if dx:
        a = jnp.roll(a, dx, axis=a.ndim - 2)
    return a


def _family_pass(pred, w, wb, lam_f, fam, mask, rest, comp, dt,
                 cfg: SolverConfig, res, relax=None):
    """One constraint pass on (3,res,res^2) pred.  ``mask`` folds validity
    and (for GS) parity; relax=None => exact GS, float => Jacobi scaling."""
    pb = _roll_fwd(pred, fam, res)
    d = pb - pred
    len_sq = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    length = jnp.sqrt(jnp.maximum(len_sq, 1e-24))
    c = length - rest
    alpha = comp / (dt * dt)
    if cfg.min_alpha_tilde > 0:
        alpha = max(alpha, cfg.min_alpha_tilde)
    denom = w + wb + alpha
    dl = (-c - alpha * lam_f) / jnp.maximum(denom, 1e-30)
    if cfg.max_dlambda > 0:
        dl = jnp.clip(dl, -cfg.max_dlambda, cfg.max_dlambda)
    if cfg.max_dlambda_rel > 0:
        m = cfg.max_dlambda_rel * rest
        dl = jnp.clip(dl, -m, m)
    if cfg.fast_math:
        # static masks only (see SolverConfig.fast_math); mask is a float
        # multiplier here
        scale = mask if relax is None else mask * relax
        dl = dl * scale
    else:
        active = (
            mask
            & (length >= cfg.eps_length)
            & (jnp.abs(denom) >= cfg.eps_denominator)
            & ((w >= cfg.static_inv_mass_eps)
               | (wb >= cfg.static_inv_mass_eps))
        )
        dl = jnp.where(active, dl if relax is None else dl * relax, 0.0)
    lam_f = lam_f + dl
    if cfg.lambda_clamp > 0:
        lam_f = jnp.clip(lam_f, -cfg.lambda_clamp, cfg.lambda_clamp)
    dp = d * (dl / length)[None]
    pred = pred - w[None] * dp
    pred = pred + _roll_bwd(wb[None] * dp, fam, res)
    return pred, lam_f


def _warm_apply_family(pred, w, wb, lam_f, fam, valid, res, rest,
                       cfg: SolverConfig):
    """Pre-apply a family's carried impulses along current edge directions.

    The carried multiplier is clamped so the applied correction never
    exceeds ``warm_start_clamp * rest`` per particle (see SolverConfig —
    unclamped warm impulses explode for light particles).  Returns
    (pred, clamped lam) so the feedback term stays consistent."""
    if cfg.warm_start_fraction != 1.0:
        lam_f = lam_f * cfg.warm_start_fraction  # SOR pre-application
    if cfg.warm_start_clamp > 0:
        wmax = jnp.maximum(jnp.maximum(w, wb), 1e-12)
        lim = cfg.warm_start_clamp * rest / wmax
        lam_f = jnp.clip(lam_f, -lim, lim)
    pb = _roll_fwd(pred, fam, res)
    d = pb - pred
    len_sq = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    length = jnp.sqrt(jnp.maximum(len_sq, 1e-24))
    dl = jnp.where(valid, lam_f, 0.0)
    dp = d * (dl / length)[None]
    pred = pred - w[None] * dp
    pred = pred + _roll_bwd(wb[None] * dp, fam, res)
    return pred, lam_f


@functools.lru_cache(maxsize=16)
def _tet_fields(spec: LatticeSpec):
    """Static structure for the per-cell tet family: the 6 Kuhn paths as
    offset families (``topology/tets.kuhn_offset_paths``), the valid-cell
    anchor mask, the per-particle tet degree (for the mass-splitting
    apply), and the shared 6x rest volume (= the cell volume — every Kuhn
    tet of a box cell has V = cellV/6 by the unit-determinant argument)."""
    from ..topology import tets as _tets

    res = spec.res
    paths = _tets.kuhn_offset_paths()
    cells = np.zeros((res, res, res), bool)
    cells[:res - 1, :res - 1, :res - 1] = True
    tdeg = np.zeros((res, res, res), np.float32)
    c = res - 1
    for path in paths:
        for (ox, oy, oz) in path:
            tdeg[ox:ox + c, oy:oy + c, oz:oz + c] += 1.0
    spacing = tuple(s / (res - 1) for s in spec.size)
    rest6 = float(spacing[0] * spacing[1] * spacing[2])
    return (paths, cells.reshape(res, res * res),
            tdeg.reshape(res, res * res), rest6)


def _cross3(a, b):
    """Cross product over the leading component axis of (3, res, r2)."""
    return jnp.stack([
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    ])


def _tet_sweep(pred, w, lam_t, spec: LatticeSpec, cfg: SolverConfig, dt,
               tet_dev, omega):
    """Per-cell tet-volume Jacobi sweep, gather-free: each Kuhn path is an
    offset family, so the 4 endpoint gathers are rolls and the gradient
    scatter is the inverse rolls.  Arithmetic matches
    ``general._solve_tets_jacobi`` (``ops/tet_volume`` formulas,
    full-strength projection, per-particle MEAN apply = mass splitting) up
    to summation order; all 6 families project against the SAME pred
    (Jacobi), then one apply.  lam_t: (6, res, r2)."""
    paths, valid, tdeg, rest6 = tet_dev
    res = spec.res
    alpha = cfg.tet_compliance / (dt * dt)
    delta = jnp.zeros_like(pred)
    lam_parts = []
    for pi, path in enumerate(paths):
        f1 = path[1] + (0,)
        f2 = path[2] + (0,)
        f3 = path[3] + (0,)
        e1 = _roll_fwd(pred, f1, res) - pred
        e2 = _roll_fwd(pred, f2, res) - pred
        e3 = _roll_fwd(pred, f3, res) - pred
        g1 = _cross3(e2, e3)
        g2 = _cross3(e3, e1)
        g3 = _cross3(e1, e2)
        g0 = -(g1 + g2 + g3)
        vol6 = (e1 * g1).sum(0)
        cerr = vol6 - cfg.tet_pressure * rest6
        w1 = _roll_fwd(w, f1, res)
        w2 = _roll_fwd(w, f2, res)
        w3 = _roll_fwd(w, f3, res)
        denom = (w * (g0 * g0).sum(0) + w1 * (g1 * g1).sum(0)
                 + w2 * (g2 * g2).sum(0) + w3 * (g3 * g3).sum(0) + alpha)
        lam_f = lam_t[pi]
        dl = (-cerr - alpha * lam_f) / jnp.maximum(denom, 1e-30)
        active = valid & (denom > cfg.eps_denominator)
        dl = jnp.where(active, dl, 0.0) * omega
        lam_parts.append(lam_f + dl)
        dlb = dl[None]
        delta = delta + dlb * g0
        delta = delta + _roll_bwd(dlb * g1, f1, res)
        delta = delta + _roll_bwd(dlb * g2, f2, res)
        delta = delta + _roll_bwd(dlb * g3, f3, res)
    pred = pred + (w / jnp.maximum(tdeg, 1.0))[None] * delta
    return pred, jnp.stack(lam_parts)


def _floor_xpbd(pred, x, w, dt, cfg: SolverConfig, ground_height=None):
    """XPBD inequality floor + positional friction, componentwise on
    (3,res,res^2) (semantics of ops/collision.floor_project_xpbd).
    ``ground_height`` (traced) overrides the config constant."""
    gh = cfg.ground_height if ground_height is None else ground_height
    pen = gh - pred[1]
    alpha_c = cfg.collision_compliance / (dt * dt)
    denom = w + alpha_c
    dl = pen / jnp.maximum(denom, 1e-30)
    hit = ((pen > 0) & (w >= cfg.static_inv_mass_eps)
           & (jnp.abs(denom) >= cfg.eps_denominator))
    p1 = pred[1] + jnp.where(hit, w * dl, 0.0)
    fr = min(max(cfg.friction, 0.0), 1.0)
    p0 = pred[0] - jnp.where(hit, (pred[0] - x[0]) * fr, 0.0)
    p2 = pred[2] - jnp.where(hit, (pred[2] - x[2]) * fr, 0.0)
    return jnp.stack([p0, p1, p2])


def _project_rigid(pred, x, w, dt, cfg: SolverConfig, kc=None):
    """The rigid world's projections, componentwise on (3, ...) with ``w``
    shaped like ``pred[0]``: XPBD floor, then boxes, then spheres.  ``kc``
    — optional traced ``(spheres, boxes, ground_height, sphere_velocities,
    box_velocities)`` replacing the config's rigid world (kinematic
    colliders).  The spatially sharded engine calls this too, so a contact
    decision never differs between the two by rounding."""
    if kc is None:
        sph = boxes = gh = sphv = boxv = None
        has_spheres = bool(cfg.sphere_colliders)
        has_boxes = bool(cfg.box_colliders)
    else:
        sph, boxes, gh, sphv, boxv = kc
        has_spheres, has_boxes = sph.shape[0] > 0, boxes.shape[0] > 0
    if cfg.floor_mode == FloorMode.XPBD_INEQUALITY:
        pred = _floor_xpbd(pred, x, w, dt, cfg, ground_height=gh)
    if has_boxes:
        from ..ops import collision as _collision

        flat = _collision.box_sdf_project(
            pred.reshape(3, -1).T, x.reshape(3, -1).T, w.reshape(-1), dt,
            cfg, boxes=boxes, box_velocities=boxv)
        pred = flat.T.reshape(pred.shape)
    if has_spheres:
        bshape = (3,) + (1,) * (pred.ndim - 1)
        if kc is None:
            rows = [(jnp.asarray([cx, cy, cz], x.dtype).reshape(bshape),
                     radius, None)
                    for cx, cy, cz, radius in cfg.sphere_colliders]
        else:
            rows = [(sph[i, :3].astype(x.dtype).reshape(bshape), sph[i, 3],
                     sphv[i]) for i in range(sph.shape[0])]
        for center, radius, svel in rows:
            dvec = pred - center
            dist = jnp.sqrt(jnp.maximum(
                dvec[0] ** 2 + dvec[1] ** 2 + dvec[2] ** 2, 1e-24))
            nrm = dvec / dist[None]
            penet = radius - dist
            act = (penet > 0) & (w >= cfg.static_inv_mass_eps)
            pred = pred + jnp.where(act[None], nrm * penet[None], 0.0)
            vel = (pred - x) / dt
            if svel is not None:
                # friction in the moving collider's frame: a sweeping
                # sphere drags contacting particles along
                vel = vel - svel.astype(x.dtype).reshape(bshape)
            vn = (vel[0] * nrm[0] + vel[1] * nrm[1]
                  + vel[2] * nrm[2])[None] * nrm
            vt = vel - vn
            fr = min(max(cfg.friction, 0.0), 1.0)
            pred = pred - jnp.where(act[None], vt * (dt * fr), 0.0)
    return pred


def _substep(x, v, w, f, lam, spec: LatticeSpec, cfg: SolverConfig, dt,
             apply_ext: bool, masks_dev, contact_on: bool = True,
             coll=None):
    """One substep in (3,res,res^2) layout.  x,v,f: (3,res,r2); w: (res,r2);
    lam: (nfam,res,r2) — or a ``(lam_dist, lam_tet)`` tuple when the state
    carries the per-cell tet family (lam_tet: (6,res,r2)); the same pytree
    shape is returned.  ``coll`` — optional ColliderSet whose traced poses
    replace the config's rigid world (kinematic colliders; same contract
    as the general engine)."""
    res = spec.res

    if coll is None:
        gh_op = kc = None
    else:
        gh_op = coll.ground_height
        kc = (coll.spheres, coll.boxes, coll.ground_height,
              coll.sphere_velocities, coll.box_velocities)

    lam_t = None
    if isinstance(lam, tuple):
        lam, lam_t = lam
    has_tets = cfg.enable_tet_volume and lam_t is not None

    if cfg.lambda_mode == LambdaMode.RESET:
        lam = jnp.zeros_like(lam)
    else:
        lam = lam * cfg.lambda_decay
    if lam_t is not None:
        # tets follow the general engine's lifecycle: fresh except in DECAY
        if cfg.lambda_mode == LambdaMode.DECAY:
            lam_t = lam_t * cfg.lambda_decay
        else:
            lam_t = jnp.zeros_like(lam_t)

    # predict (reference gravity is a force: v += dt*w*(g + f_ext);
    # gravity_is_acceleration applies g mass-independently)
    g = jnp.asarray(cfg.gravity, x.dtype).reshape(3, 1, 1)
    ext = f if apply_ext else jnp.zeros_like(f)
    if cfg.gravity_is_acceleration:
        if cfg.max_force > 0:
            ext = jnp.clip(ext, -cfg.max_force, cfg.max_force)
        active = (w > 0)[None]
        v = v + dt * (jnp.where(active, g, 0.0) + w[None] * ext)
    else:
        force = g + ext
        if cfg.max_force > 0:
            force = jnp.clip(force, -cfg.max_force, cfg.max_force)
        v = v + dt * w[None] * force
    if cfg.damping_mode.value == "per_step":
        v = v * (1.0 - min(max(cfg.damping, 0.0), 1.0))
    else:
        v = v * (1.0 - cfg.damping * dt)
    if cfg.max_velocity > 0:
        v = jnp.clip(v, -cfg.max_velocity, cfg.max_velocity)
    pred = x + dt * v
    if cfg.world_bounds > 0:
        pred = jnp.clip(pred, -cfg.world_bounds, cfg.world_bounds)

    sc_on = cfg.enable_self_collision and contact_on
    if sc_on and _spatial_hash.needs_morton_order(cfg):
        # Morton ordering built ONCE per substep from the predicted
        # positions (same lifecycle as the general engine)
        sc_order = _spatial_hash.morton_order(pred.reshape(3, -1).T, cfg)
    else:
        sc_order = None

    wb_per_fam = [_roll_fwd(w, fam, res) for fam in spec.families]

    if cfg.lambda_mode == LambdaMode.WARM_START:
        lam_parts = []
        for fi, fam in enumerate(spec.families):
            pred, lam_f = _warm_apply_family(
                pred, w, wb_per_fam[fi], lam[fi], fam, masks_dev[fi][0],
                res, spec.rest_lengths[fi], cfg)
            lam_parts.append(lam_f)
        lam = jnp.stack(lam_parts)

    tet_dev = None
    if has_tets:
        paths, valid_np, tdeg_np, rest6 = _tet_fields(spec)
        tet_dev = (paths, jnp.asarray(valid_np), jnp.asarray(tdeg_np),
                   rest6)
    tet_omega = cfg.omega if cfg.omega > 0 else 1.0

    def iteration(_, carry):
        pred, lam, lam_t = carry
        lam_parts = []
        for fi, fam in enumerate(spec.families):
            valid, parity0 = masks_dev[fi]
            if cfg.fast_math:
                # float multipliers (constant-folded); see SolverConfig
                m_even = (valid & parity0).astype(pred.dtype)
                m_odd = (valid & ~parity0).astype(pred.dtype)
                m_all = valid.astype(pred.dtype)
            else:
                m_even = valid & parity0
                m_odd = valid & ~parity0
                m_all = valid
            lam_f = lam[fi]
            rest = spec.rest_lengths[fi]
            comp = spec.compliances[fi]
            wb = wb_per_fam[fi]
            if cfg.solve_mode == SolveMode.COLORED:
                pred, lam_f = _family_pass(
                    pred, w, wb, lam_f, fam, m_even, rest, comp,
                    dt, cfg, res)
                pred, lam_f = _family_pass(
                    pred, w, wb, lam_f, fam, m_odd, rest, comp,
                    dt, cfg, res)
            else:
                pred, lam_f = _family_pass(
                    pred, w, wb, lam_f, fam, m_all, rest, comp, dt, cfg,
                    # omega semantics match the general engine: a scale on
                    # the 1/max-conflict-degree-normalized Jacobi update.
                    # Intra-family conflict degree is 2 (each particle is an
                    # endpoint of at most two same-family edges), hence /2;
                    # default omega=1.0 keeps the historical 0.5 factor.
                    res, relax=0.5 * (cfg.omega if cfg.omega > 0 else 1.0))
            lam_parts.append(lam_f)
        lam = jnp.stack(lam_parts)

        if has_tets:
            pred, lam_t = _tet_sweep(pred, w, lam_t, spec, cfg, dt,
                                     tet_dev, tet_omega)

        if sc_on:
            # same projection order as the general engine (self-collision
            # before the floor/SDF projections); shared backend dispatch
            flat = _spatial_hash.project_self_collision(
                pred.reshape(3, -1).T, w.reshape(-1), sc_order, cfg)
            pred = flat.T.reshape(3, res, res * res)
        pred = _project_rigid(pred, x, w, dt, cfg, kc)
        return pred, lam, lam_t

    pred, lam, lam_t = lax.fori_loop(0, cfg.iterations, iteration,
                                     (pred, lam, lam_t))

    # finalize
    pinned = (w == 0.0)[None]
    v = jnp.where(pinned, 0.0, (pred - x) / dt)
    x = jnp.where(pinned, x, pred)

    if cfg.floor_mode == FloorMode.VELOCITY_REFLECT:
        # flagship-style velocity-level floor (ops/collision semantics)
        gh = cfg.ground_height if gh_op is None else gh_op
        pen = gh - x[1]
        hit = (pen > 0) & (w > 0)
        x1 = jnp.where(hit, gh + cfg.floor_offset, x[1])
        falling = hit & (v[1] < 0)
        vy = jnp.abs(v[1]) * cfg.restitution + pen * cfg.penetration_kick
        v1 = jnp.where(falling, vy, v[1])
        normal_force = jnp.abs(v1) + pen * cfg.normal_force_scale
        h_speed = jnp.sqrt(jnp.maximum(v[0] ** 2 + v[2] ** 2, 1e-24))
        moving = h_speed > 1e-3
        fmag = jnp.minimum(h_speed,
                           normal_force * cfg.floor_friction_coeff * dt)
        scalef = jnp.where(falling & moving, fmag / h_speed, 0.0)
        v0 = v[0] - v[0] * scalef
        v2 = v[2] - v[2] * scalef
        x = jnp.stack([x[0], x1, x[2]])
        v = jnp.stack([v0, v1, v2])

    return x, v, ((lam, lam_t) if lam_t is not None else lam)


def _to_grid(state: SimState, spec: LatticeSpec):
    res = spec.res
    r2 = res * res
    lam = state.lambda_dist.reshape(spec.n_families, res, r2)
    if state.lambda_tet is not None:
        lam = (lam, state.lambda_tet.reshape(6, res, r2))
    return (state.positions.T.reshape(3, res, r2),
            state.velocities.T.reshape(3, res, r2),
            state.inv_mass.reshape(res, r2),
            state.ext_force.T.reshape(3, res, r2),
            lam)


def _from_grid(state: SimState, x, v, lam) -> SimState:
    lam_t = None
    if isinstance(lam, tuple):
        lam, lam_t = lam
    return state.replace(
        positions=x.reshape(3, -1).T,
        velocities=v.reshape(3, -1).T,
        lambda_dist=lam.reshape(-1),
        lambda_tet=None if lam_t is None else lam_t.reshape(-1),
        ext_force=jnp.zeros_like(state.ext_force),
    )


def _masks_dev(spec: LatticeSpec):
    return tuple((jnp.asarray(vv), jnp.asarray(pp))
                 for (vv, pp) in _family_masks(spec))


def step_fn(state: SimState, spec: LatticeSpec, cfg: SolverConfig,
            dt: float) -> SimState:
    """One physics step = cfg.substeps substeps; external forces consumed on
    the first substep (SoftBodyParticleCPU force lifecycle)."""
    dt_sub = dt / cfg.substeps
    every = cfg.self_collision_every if cfg.enable_self_collision else 1
    masks = _masks_dev(spec)
    coll = state.colliders    # kinematic rigid world (traced; may be None)
    x, v, w, f, lam = _to_grid(state, spec)
    x, v, lam = _substep(x, v, w, f, lam, spec, cfg, dt_sub, True, masks,
                         coll=coll)
    if cfg.substeps > 1:
        if every == 1:
            def body(carry, _):
                x, v, lam = carry
                return _substep(x, v, w, f, lam, spec, cfg, dt_sub, False,
                                masks, coll=coll), None

            (x, v, lam), _ = lax.scan(body, (x, v, lam), None,
                                      length=cfg.substeps - 1)
        else:
            # Contact cadence (self_collision_every): substep i runs the
            # self-collision pass iff i % every == 0.  Static group
            # structure, same as the general engine (general.step_fn).
            rem = cfg.substeps - 1
            n_full, tail = divmod(rem, every)
            if n_full:
                def body(carry, _):
                    x, v, lam = carry
                    for _i in range(every - 1):
                        x, v, lam = _substep(x, v, w, f, lam, spec, cfg,
                                             dt_sub, False, masks,
                                             contact_on=False, coll=coll)
                    x, v, lam = _substep(x, v, w, f, lam, spec, cfg,
                                         dt_sub, False, masks,
                                         contact_on=True, coll=coll)
                    return (x, v, lam), None

                (x, v, lam), _ = lax.scan(body, (x, v, lam), None,
                                          length=n_full)
            for _i in range(tail):
                x, v, lam = _substep(x, v, w, f, lam, spec, cfg, dt_sub,
                                     False, masks, contact_on=False,
                                     coll=coll)
    return _from_grid(state, x, v, lam)


def multi_step_fn(state, spec, cfg, dt, n_steps: int) -> SimState:
    def body(carry, _):
        return step_fn(carry, spec, cfg, dt), None

    state, _ = lax.scan(body, state, None, length=n_steps)
    return state


def make_step(spec: LatticeSpec, cfg: SolverConfig, dt: float,
              n_steps: int = 1):
    @jax.jit
    def fn(state: SimState) -> SimState:
        return multi_step_fn(state, spec, cfg, dt, n_steps)

    return fn


def make_batched_step(spec: LatticeSpec, cfg: SolverConfig, dt: float,
                      n_bodies: int, n_steps: int = 1):
    """Ensemble stepper with the body axis folded into the LANE dimension.

    A vmapped res-4 body leaves 16-wide lanes (vector units ~12% utilised);
    laying the B bodies out as ``(3, res, B*res^2)`` gives full-width lanes
    while the family masks — tiled per body — kill the roll wrap-around at
    body boundaries exactly as they do at y-row boundaries.  The substep
    code is IDENTICAL to the single-body engine; only the layout transform
    and mask tiling differ.  Input/output: batched SimState with leading
    body axis (as produced by ``parallel.batch.stack_states``).
    """
    res = spec.res
    r2 = res * res
    nfam = spec.n_families
    masks = _family_masks(spec)
    masks_tiled = tuple(
        (jnp.asarray(np.tile(v, (1, n_bodies))),
         jnp.asarray(np.tile(p, (1, n_bodies))))
        for (v, p) in masks)

    def to_wide(arr_bn3):
        # (B, N, 3) -> (3, res, B*r2) with lane index = b*r2 + (y*res+z)
        b = arr_bn3.shape[0]
        a = arr_bn3.reshape(b, res, r2, 3)
        a = jnp.transpose(a, (3, 1, 0, 2))  # (3, res, B, r2)
        return a.reshape(3, res, b * r2)

    def from_wide(a, b):
        a = a.reshape(3, res, b, r2)
        a = jnp.transpose(a, (2, 1, 3, 0))  # (B, res, r2, 3)
        return a.reshape(b, res * r2, 3)

    dt_sub = dt / cfg.substeps

    @jax.jit
    def fn(batched: SimState) -> SimState:
        if batched.colliders is not None:
            raise NotImplementedError(
                "lane-folded ensemble stepping does not take per-body "
                "ColliderSets; animate colliders on the general engine "
                "(vmap make_step)")
        b = batched.positions.shape[0]
        x = to_wide(batched.positions)
        v = to_wide(batched.velocities)
        f = to_wide(batched.ext_force)
        w = jnp.transpose(
            batched.inv_mass.reshape(b, res, r2), (1, 0, 2)
        ).reshape(res, b * r2)
        lam = jnp.transpose(
            batched.lambda_dist.reshape(b, nfam, res, r2), (1, 2, 0, 3)
        ).reshape(nfam, res, b * r2)

        def one_step(carry, step_idx):
            x, v, lam = carry
            # external forces are consumed on the very first substep of the
            # very first step only (matching step_fn's zero-after-step)
            fi = jnp.where(step_idx == 0, 1.0, 0.0) * f
            x, v, lam = _substep(x, v, w, fi, lam, spec, cfg, dt_sub, True,
                                 masks_tiled)
            if cfg.substeps > 1:
                def body(c, _):
                    x, v, lam = c
                    return _substep(x, v, w, fi, lam, spec, cfg, dt_sub,
                                    False, masks_tiled), None

                (x, v, lam), _ = lax.scan(body, (x, v, lam), None,
                                          length=cfg.substeps - 1)
            return (x, v, lam), None

        (x, v, lam), _ = lax.scan(one_step, (x, v, lam),
                                  jnp.arange(n_steps))
        lam_out = jnp.transpose(
            lam.reshape(nfam, res, b, r2), (2, 0, 1, 3)).reshape(b, -1)
        return batched.replace(
            positions=from_wide(x, b),
            velocities=from_wide(v, b),
            lambda_dist=lam_out,
            ext_force=jnp.zeros_like(batched.ext_force),
        )

    return fn


def make_substep_runner(spec: LatticeSpec, cfg: SolverConfig, dt_sub: float,
                        n_substeps: int):
    """Flat scan over raw substeps (no per-step structure, no ext forces):
    one scan level keeps compile time flat — used by benchmarks."""
    masks = _masks_dev(spec)

    every = cfg.self_collision_every if cfg.enable_self_collision else 1

    @jax.jit
    def fn(state: SimState) -> SimState:
        coll = state.colliders   # kinematic rigid world (may be None)
        x, v, w, f, lam = _to_grid(state, spec)

        if every == 1:
            def body(carry, _):
                x, v, lam = carry
                return _substep(x, v, w, f, lam, spec, cfg, dt_sub, False,
                                masks, coll=coll), None

            (x, v, lam), _ = lax.scan(body, (x, v, lam), None,
                                      length=n_substeps)
        else:
            # Contact cadence: pass on substeps i % every == 0 (groups of
            # 1 contact-on + every-1 contact-free, then the tail).
            n_full, tail = divmod(n_substeps, every)
            if n_full:
                def body(carry, _):
                    x, v, lam = carry
                    x, v, lam = _substep(x, v, w, f, lam, spec, cfg,
                                         dt_sub, False, masks,
                                         contact_on=True, coll=coll)
                    for _i in range(every - 1):
                        x, v, lam = _substep(x, v, w, f, lam, spec, cfg,
                                             dt_sub, False, masks,
                                             contact_on=False, coll=coll)
                    return (x, v, lam), None

                (x, v, lam), _ = lax.scan(body, (x, v, lam), None,
                                          length=n_full)
            for _i in range(tail):
                x, v, lam = _substep(x, v, w, f, lam, spec, cfg, dt_sub,
                                     False, masks, contact_on=(_i == 0),
                                     coll=coll)
        return _from_grid(state, x, v, lam)

    return fn
