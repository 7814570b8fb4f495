"""Spatial sharding of ONE large lattice across chips (halo exchange).

The TP/ring analog from SURVEY §2.4/§5: when a single body exceeds one chip,
partition the lattice along its x-axis over a 1-D device mesh.  Each chip
owns a slab of ``res/D`` x-planes; the stencil families with an x-component
need exactly one plane of halo, exchanged with ``lax.ppermute`` between neighbouring devices:

  * before a pass: each chip receives its right neighbor's FIRST x-plane of
    predicted positions (the gather halo);
  * after computing corrections: each chip's correction for its last
    anchor-plane's partner is sent RIGHT and added to the neighbor's first
    plane (the scatter halo).

All y/z-offset components stay chip-local (those axes are unsharded).  The
parity-split Gauss-Seidel semantics are preserved exactly: masks are built
on GLOBAL coordinates and sharded alongside the state, and each pass
spells the single-chip stencil engine's arithmetic in its order, so the
two agree to the compiler's fusion choices (tets: to their deferred-halo
sum order; see ``_sharded_tet_sweep``).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax, shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.config import FloorMode, LambdaMode, SolveMode, SolverConfig
from ..core.state import SimState
from ..ops import collision as _collision
from ..ops import integrate as _integrate
from ..solvers.lattice import _family_masks, _project_rigid, n_lambda
from ..topology.lattice import LatticeSpec


def _right_perm(d: int):
    """perm for: device i receives from device i+1 (fetch right halo)."""
    return [(i + 1, i) for i in range(d - 1)]


def _left_perm(d: int):
    """perm for: device i+1 receives from device i (push correction right)."""
    return [(i, i + 1) for i in range(d - 1)]


def _length(d):
    """Edge lengths of trailing-3 vectors, in the single-chip stencil
    engine's operation order (so both round alike)."""
    return jnp.sqrt(jnp.maximum(
        d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2],
        1e-24))


def _sharded_family_pass(pred, w, w_halo, lam_f, family, mask, rest, comp,
                         dt, cfg: SolverConfig, axis: str, n_shards: int,
                         relax=None):
    """One constraint pass on a slab.  ``mask`` already folds validity and
    (for GS) parity, built from global coordinates.  ``relax`` None => GS
    semantics (mask must be conflict-free); float => Jacobi scaling."""
    dx, dy, dz, _ = family
    yz_fwd = (-dy, -dz)
    yz_bwd = (dy, dz)

    if dx:
        halo = lax.ppermute(pred[0], axis, _right_perm(n_shards))
        pb = jnp.concatenate([pred[1:], halo[None]], axis=0)
        wb = w_halo
    else:
        pb = pred
        wb = w
    pb = jnp.roll(pb, yz_fwd, axis=(1, 2))
    wb = jnp.roll(wb, yz_fwd, axis=(1, 2))

    d = pb - pred
    length = _length(d)
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
    active = (
        mask
        & (length >= cfg.eps_length)
        & (jnp.abs(denom) >= cfg.eps_denominator)
        & ((w >= cfg.static_inv_mass_eps) | (wb >= cfg.static_inv_mass_eps))
    )
    dl = jnp.where(active, dl if relax is None else dl * relax, 0.0)

    lam_f = lam_f + dl
    if cfg.lambda_clamp > 0:
        lam_f = jnp.clip(lam_f, -cfg.lambda_clamp, cfg.lambda_clamp)

    dp = d * (dl / length)[..., None]
    pred = pred - w[..., None] * dp
    corr = jnp.roll(wb[..., None] * dp, yz_bwd, axis=(1, 2))
    if dx:
        # partner of anchor-plane i is plane i+1; the last plane's partner
        # lives on the right neighbor
        pred = pred.at[1:].add(corr[:-1])
        spill = lax.ppermute(corr[-1], axis, _left_perm(n_shards))
        pred = pred.at[0].add(spill)
    else:
        pred = pred + corr
    return pred, lam_f


def _apply_warm(pred, w, w_halo, lam_f, family, valid, axis, n_shards,
                rest, cfg: SolverConfig):
    dx, dy, dz, _ = family
    if dx:
        halo = lax.ppermute(pred[0], axis, _right_perm(n_shards))
        pb = jnp.concatenate([pred[1:], halo[None]], axis=0)
        wb = w_halo
    else:
        pb = pred
        wb = w
    pb = jnp.roll(pb, (-dy, -dz), axis=(1, 2))
    wb = jnp.roll(wb, (-dy, -dz), axis=(1, 2))
    if cfg.warm_start_fraction != 1.0:
        lam_f = lam_f * cfg.warm_start_fraction  # SOR pre-application
    if cfg.warm_start_clamp > 0:
        wmax = jnp.maximum(jnp.maximum(w, wb), 1e-12)
        lim = cfg.warm_start_clamp * rest / wmax
        lam_f = jnp.clip(lam_f, -lim, lim)
    d = pb - pred
    length = _length(d)
    dl = jnp.where(valid, lam_f, 0.0)
    dp = d * (dl / length)[..., None]
    pred = pred - w[..., None] * dp
    corr = jnp.roll(wb[..., None] * dp, (dy, dz), axis=(1, 2))
    if dx:
        pred = pred.at[1:].add(corr[:-1])
        spill = lax.ppermute(corr[-1], axis, _left_perm(n_shards))
        pred = pred.at[0].add(spill)
    else:
        pred = pred + corr
    return pred, lam_f


def _sharded_tet_sweep(pred, w, lam_t, paths, valid, tdeg, rest6,
                       cfg: SolverConfig, dt_sub, axis: str, n_shards: int,
                       omega):
    """Per-cell tet-volume Jacobi sweep on an x-slab (trailing-3 layout).

    Mirrors ``solvers/lattice._tet_sweep``: the 6 Kuhn paths all project
    against the SAME pred (Jacobi), then one mass-splitting apply.  Every
    path offset has dx in {0, 1}, so ONE right-halo fetch of pred/w serves
    the whole sweep, and the cross-boundary gradient scatters accumulate
    in a single spill plane pushed right ONCE after the paths.  Boundary
    lanes therefore sum their contributions in a different order than the
    single-chip engine (own-path terms first, then the left neighbor's
    spill) — an fp reordering bounded by the equivalence tests' tolerance,
    not an algorithmic difference.

    pred: (P,res,res,3); w/valid/tdeg: (P,res,res); lam_t: (6,P,res,res).
    """
    p_planes = pred.shape[0]
    alpha = cfg.tet_compliance / (dt_sub * dt_sub)
    halo_p = lax.ppermute(pred[0], axis, _right_perm(n_shards))
    pred_x = jnp.concatenate([pred, halo_p[None]], axis=0)
    halo_w = lax.ppermute(w[0], axis, _right_perm(n_shards))
    w_x = jnp.concatenate([w, halo_w[None]], axis=0)

    def fetch(a_x, off):
        ox, oy, oz = off
        a = a_x[ox:ox + p_planes]
        if oy or oz:
            a = jnp.roll(a, (-oy, -oz), axis=(1, 2))
        return a

    def cross(a, b):
        # same component expressions as solvers/lattice._cross3
        return jnp.stack([
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ], axis=-1)

    def scatter(acc_x, val, off):
        ox, oy, oz = off
        if oy or oz:
            # wrapped-in lanes carry only zeros: dl is masked to the valid
            # anchor cells, which exclude the y/z faces (same argument as
            # the stencil engine's inverse rolls)
            val = jnp.roll(val, (oy, oz), axis=(1, 2))
        return acc_x.at[ox:ox + p_planes].add(val)

    acc = jnp.zeros((p_planes + 1,) + pred.shape[1:], pred.dtype)
    lam_parts = []
    for pi, path in enumerate(paths):
        o1, o2, o3 = path[1], path[2], path[3]
        e1 = fetch(pred_x, o1) - pred
        e2 = fetch(pred_x, o2) - pred
        e3 = fetch(pred_x, o3) - pred
        g1 = cross(e2, e3)
        g2 = cross(e3, e1)
        g3 = cross(e1, e2)
        g0 = -(g1 + g2 + g3)
        vol6 = (e1 * g1).sum(-1)
        cerr = vol6 - cfg.tet_pressure * rest6
        w1 = fetch(w_x, o1)
        w2 = fetch(w_x, o2)
        w3 = fetch(w_x, o3)
        denom = (w * (g0 * g0).sum(-1) + w1 * (g1 * g1).sum(-1)
                 + w2 * (g2 * g2).sum(-1) + w3 * (g3 * g3).sum(-1) + alpha)
        lam_f = lam_t[pi]
        dl = (-cerr - alpha * lam_f) / jnp.maximum(denom, 1e-30)
        active = valid & (denom > cfg.eps_denominator)
        dl = jnp.where(active, dl, 0.0) * omega
        lam_parts.append(lam_f + dl)
        dlb = dl[..., None]
        acc = scatter(acc, dlb * g0, (0, 0, 0))
        acc = scatter(acc, dlb * g1, o1)
        acc = scatter(acc, dlb * g2, o2)
        acc = scatter(acc, dlb * g3, o3)
    spill = lax.ppermute(acc[p_planes], axis, _left_perm(n_shards))
    delta = acc[:p_planes].at[0].add(spill)
    pred = pred + (w / jnp.maximum(tdeg, 1.0))[..., None] * delta
    return pred, jnp.stack(lam_parts)


def make_spatial_lattice_step(spec: LatticeSpec, cfg: SolverConfig,
                              dt: float, mesh: Mesh, n_steps: int = 1,
                              axis: str = "x", kin_colliders=None):
    """Compile a sharded ``SimState -> SimState`` step for one large lattice
    split over ``mesh``'s devices along the lattice x-axis: per-family XLA
    passes with ``lax.ppermute`` halo exchange.

    ``kin_colliders=(S, B)``: the state's ``ColliderSet`` poses enter the
    sharded program as small REPLICATED traced arrays (every chip sees the
    full rigid world; only the soft body is spatially sharded), replacing
    the config's rigid-world constants with the same formulas the
    single-chip engines use — a collider can sweep across the whole
    device mesh without recompiles."""
    kin = kin_colliders is not None
    kin_s, kin_b = (int(kin_colliders[0]), int(kin_colliders[1])) if kin \
        else (0, 0)
    res = spec.res
    n_shards = mesh.devices.size
    if res % n_shards != 0:
        raise ValueError(f"res {res} not divisible by {n_shards} shards")
    nfam = spec.n_families

    host_masks = _family_masks(spec)  # (res, res*res) layout
    valid_np = np.stack(
        [v.reshape(res, res, res) for v, _ in host_masks])
    par0_np = np.stack(
        [p.reshape(res, res, res) for _, p in host_masks])

    # per-cell tet family (solid lattices): static anchor mask + degree
    # plane shard alongside w; the sweep itself is _sharded_tet_sweep
    has_tets = cfg.enable_tet_volume
    if has_tets:
        from ..solvers.lattice import _tet_fields

        tet_paths, tvalid_np, tdeg_np, tet_rest6 = _tet_fields(spec)
        tvalid_np = np.asarray(tvalid_np).reshape(res, res, res)
        tdeg_np = np.asarray(tdeg_np).reshape(res, res, res)
        tet_omega = cfg.omega if cfg.omega > 0 else 1.0

    def local_substep(x, v, w, f, lam, valid, par0, apply_ext,
                      tvalid=None, tdeg=None, kc=None):
        # kc — optional traced rigid world, replicated per chip:
        # (spheres (S,4), boxes (B,6), ground (), sph_vel (S,3),
        #  box_vel (B,3)); overrides the config constants when present
        # x,v,f: (P,res,res,3); w: (P,res,res); lam: (nfam,P,res,res) —
        # or (lam_dist, lam_tet) with lam_tet (6,P,res,res) for solid
        # lattices (same pytree shape returned)
        lam_t = None
        if isinstance(lam, tuple):
            lam, lam_t = lam
        p = x.shape[0]
        pred, vel = _integrate.predict(
            x.reshape(-1, 3), v.reshape(-1, 3), w.reshape(-1),
            f.reshape(-1, 3), dt_sub, cfg, apply_ext=apply_ext)
        pred = pred.reshape(p, res, res, 3)

        # inv-mass halo is static within the substep: fetch once
        w_halo_plane = lax.ppermute(w[0], axis, _right_perm(n_shards))
        w_halo = jnp.concatenate([w[1:], w_halo_plane[None]], axis=0)

        if cfg.lambda_mode == LambdaMode.RESET:
            lam = jnp.zeros_like(lam)
        else:
            lam = lam * cfg.lambda_decay
        if lam_t is not None:
            # tets follow the general engine's lifecycle: fresh except DECAY
            if cfg.lambda_mode == LambdaMode.DECAY:
                lam_t = lam_t * cfg.lambda_decay
            else:
                lam_t = jnp.zeros_like(lam_t)

        if cfg.lambda_mode == LambdaMode.WARM_START:
            lam_parts = []
            for fi, fam in enumerate(spec.families):
                pred, lam_f = _apply_warm(
                    pred, w, w_halo, lam[fi], fam, valid[fi], axis,
                    n_shards, spec.rest_lengths[fi], cfg)
                lam_parts.append(lam_f)
            lam = jnp.stack(lam_parts)

        def iteration(_, carry):
            pred, lam, lam_t = carry
            lam_parts = []
            for fi, fam in enumerate(spec.families):
                lam_f = lam[fi]
                if cfg.solve_mode == SolveMode.COLORED:
                    pred, lam_f = _sharded_family_pass(
                        pred, w, w_halo, lam_f, fam, valid[fi] & par0[fi],
                        spec.rest_lengths[fi], spec.compliances[fi], dt_sub,
                        cfg, axis, n_shards)
                    pred, lam_f = _sharded_family_pass(
                        pred, w, w_halo, lam_f, fam, valid[fi] & ~par0[fi],
                        spec.rest_lengths[fi], spec.compliances[fi], dt_sub,
                        cfg, axis, n_shards)
                else:
                    pred, lam_f = _sharded_family_pass(
                        pred, w, w_halo, lam_f, fam, valid[fi],
                        spec.rest_lengths[fi], spec.compliances[fi], dt_sub,
                        cfg, axis, n_shards,
                        # omega/2: see solvers/lattice.py (intra-family
                        # conflict degree is 2; default omega=1.0)
                        relax=0.5 * (cfg.omega if cfg.omega > 0 else 1.0))
                lam_parts.append(lam_f)
            lam = jnp.stack(lam_parts)
            if lam_t is not None:
                pred, lam_t = _sharded_tet_sweep(
                    pred, w, lam_t, tet_paths, tvalid, tdeg, tet_rest6,
                    cfg, dt_sub, axis, n_shards, tet_omega)
            # the single-chip engine's own projection, on a component-
            # first view of this slab (elementwise, so no halo)
            pred = jnp.moveaxis(_project_rigid(
                jnp.moveaxis(pred, -1, 0), jnp.moveaxis(x, -1, 0), w,
                dt_sub, cfg, kc), 0, -1)
            return pred, lam, lam_t

        pred, lam, lam_t = lax.fori_loop(0, cfg.iterations, iteration,
                                         (pred, lam, lam_t))

        xf, vf = _integrate.finalize(
            x.reshape(-1, 3), pred.reshape(-1, 3), w.reshape(-1), dt_sub)
        if cfg.floor_mode == FloorMode.VELOCITY_REFLECT:
            xf, vf = _collision.floor_velocity_reflect(
                xf, vf, w.reshape(-1), dt_sub, cfg,
                ground_height=None if kc is None else kc[2])
        lam_out = lam if lam_t is None else (lam, lam_t)
        return (xf.reshape(p, res, res, 3), vf.reshape(p, res, res, 3),
                lam_out)

    dt_sub = dt / cfg.substeps

    def local_fn(x, v, w, f, lam, valid, par0, tvalid=None, tdeg=None,
                 kc=None):
        def one_step(x, v, lam, f, apply_ext):
            x, v, lam = local_substep(x, v, w, f, lam, valid, par0,
                                      apply_ext, tvalid, tdeg, kc)
            if cfg.substeps > 1:
                def body(carry, _):
                    x, v, lam = carry
                    return local_substep(x, v, w, f, lam, valid, par0,
                                         False, tvalid, tdeg, kc), None

                (x, v, lam), _ = lax.scan(body, (x, v, lam), None,
                                          length=cfg.substeps - 1)
            return x, v, lam

        x, v, lam = one_step(x, v, lam, f, True)
        if n_steps > 1:
            def body(carry, _):
                x, v, lam = carry
                return one_step(x, v, lam, jnp.zeros_like(f), False), None

            (x, v, lam), _ = lax.scan(body, (x, v, lam), None,
                                      length=n_steps - 1)
        return x, v, lam

    sx = P(axis)
    # P(None, axis) applies as a pytree prefix to the lambda pack: both the
    # distance slab stack (nfam,res,res,res) and, for solid lattices, the
    # tet slab stack (6,res,res,res) shard their x axis (dim 1)
    in_specs = [sx, sx, sx, sx, P(None, axis), P(None, axis),
                P(None, axis)]
    if has_tets:
        in_specs += [sx, sx]   # tet anchor mask + degree plane
    if kin:
        in_specs += [P()]      # rigid-world pose tuple: replicated

    def dispatch(*args):
        base, rest = args[:7], args[7:]
        tv = td = kc = None
        if has_tets:
            tv, td = rest[0], rest[1]
            rest = rest[2:]
        if kin:
            kc = rest[0]
        return local_fn(*base, tvalid=tv, tdeg=td, kc=kc)

    fn = shard_map(
        dispatch, mesh=mesh,
        in_specs=tuple(in_specs),
        out_specs=(sx, sx, P(None, axis)),
        check_vma=False)
    jfn = jax.jit(fn)

    valid_dev = jnp.asarray(valid_np)
    par0_dev = jnp.asarray(par0_np)
    if has_tets:
        tvalid_dev = jnp.asarray(tvalid_np)
        tdeg_dev = jnp.asarray(tdeg_np)

    def step(state: SimState) -> SimState:
        x = state.positions.reshape(res, res, res, 3)
        v = state.velocities.reshape(res, res, res, 3)
        w = state.inv_mass.reshape(res, res, res)
        f = state.ext_force.reshape(res, res, res, 3)
        lam = state.lambda_dist.reshape(nfam, res, res, res)
        extra = []
        if kin:
            c = state.colliders
            if c is None:
                raise ValueError(
                    "spatial step built with kin_colliders needs a state "
                    "carrying a ColliderSet (core.colliders.make_colliders)")
            if c.n_spheres != kin_s or c.n_boxes != kin_b:
                raise ValueError(
                    f"state ColliderSet has ({c.n_spheres}, {c.n_boxes}) "
                    f"colliders; step built for kin_colliders="
                    f"({kin_s}, {kin_b})")
            extra = [(c.spheres, c.boxes, c.ground_height,
                      c.sphere_velocities, c.box_velocities)]
        if has_tets:
            if state.lambda_tet is None:
                raise ValueError("enable_tet_volume needs a state built "
                                 "with tet_volume=True (make_lattice_state)")
            lam = (lam, state.lambda_tet.reshape(6, res, res, res))
            x, v, lam = jfn(x, v, w, f, lam, valid_dev, par0_dev,
                            tvalid_dev, tdeg_dev, *extra)
            lam, lam_t = lam
        else:
            x, v, lam = jfn(x, v, w, f, lam, valid_dev, par0_dev, *extra)
            lam_t = None
        return state.replace(
            positions=x.reshape(-1, 3),
            velocities=v.reshape(-1, 3),
            lambda_dist=lam.reshape(-1),
            lambda_tet=None if lam_t is None else lam_t.reshape(-1),
            ext_force=jnp.zeros_like(state.ext_force),
        )

    return step


def shard_lattice_state(state: SimState, spec: LatticeSpec, mesh: Mesh,
                        axis: str = "x") -> SimState:
    """Place a lattice SimState so its x-planes are split across the mesh.

    Positions are (res^3, 3) x-major, so sharding leading-dim blocks of the
    flat array IS sharding x-plane slabs."""
    sh = NamedSharding(mesh, P(axis))
    rep = NamedSharding(mesh, P())
    return SimState(
        positions=jax.device_put(state.positions, sh),
        velocities=jax.device_put(state.velocities, sh),
        inv_mass=jax.device_put(state.inv_mass, sh),
        ext_force=jax.device_put(state.ext_force, sh),
        lambda_dist=jax.device_put(state.lambda_dist, rep),
        lambda_bend=jax.device_put(state.lambda_bend, rep),
        lambda_volume=jax.device_put(state.lambda_volume, rep),
        lambda_tet=(None if state.lambda_tet is None
                    else jax.device_put(state.lambda_tet, rep)),
        # rigid-world poses are tiny and global: replicate to every chip
        colliders=(None if state.colliders is None
                   else jax.tree.map(lambda x: jax.device_put(x, rep),
                                     state.colliders)),
    )
