"""General-topology XPBD engine (arbitrary meshes) — one compiled program.

The single-program replacement for ALL of the reference's per-kernel dispatch
choreography: the flagship host loop (decay -> integrate -> per-color solve x
iterations -> floor -> mesh update, ``SoftBodySimulator.cs:547-632``), the
substep engine loop (predict -> zero lambdas -> N x solve -> collide ->
finalize, ``SoftBodyGPU.cs:237-249``) and the canonical CPU loop
(``SoftBodyCPU.cs:269-325``).  The entire step — substeps, solver iterations,
every constraint family, collisions — is traced once and compiled into a
single XLA program; interaction impulses ride in as state, so there are no
host round-trips at all (deleting the SetData/GetData traffic of SURVEY §2.5).

Two solve modes (``SolverConfig.solve_mode``):

* COLORED — exact parallel Gauss-Seidel.  Host-side graph coloring
  (``topology/coloring.py``) partitions constraints into conflict-free
  groups; a ``lax.fori_loop`` over colors does one batched gather ->
  project -> scatter per group.  Because no particle repeats within a group,
  the batched update is arithmetically identical to the reference's
  sequential sweep in color order — this is the oracle-matching mode.
* JACOBI — all constraints projected simultaneously; corrections merged by
  ``segment_sum`` under under-relaxation omega (default 1/avg-degree).  One
  fused pass, no sequential color sweeps: the throughput mode, and the
  deterministic, well-behaved answer to the racy free-for-all solver
  (``XPBDSimulatorCS.compute:128-182``).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from ..core.config import FloorMode, LambdaMode, SolveMode, SolverConfig
from ..core.state import SimState, Topology
from ..ops import bending as _bending
from ..ops import collision as _collision
from ..ops import distance as _distance
from ..ops import integrate as _integrate
from ..ops import mxu_exact as _mxu
from ..ops import spatial_hash as _spatial_hash
from ..ops import tet_volume as _tet_volume
from ..ops import volume as _volume


# --------------------------------------------------------------- distance
def _solve_distance_colored(pred, lam, inv_mass, topo: Topology,
                            cfg: SolverConfig, dt):
    edges = topo.edges
    rest = topo.rest_lengths
    comp = topo.compliance

    def color_pass(c, carry):
        pred, lam = carry
        ids = topo.col_edge_ids[c]
        validity = topo.col_valid[c]
        ea = edges[ids, 0]
        eb = edges[ids, 1]
        pa = pred[ea]
        pb = pred[eb]
        wa = inv_mass[ea]
        wb = inv_mass[eb]
        dl, n = _distance.distance_delta_lambda(
            pa, pb, wa, wb, rest[ids], comp[ids], lam[ids], dt, cfg)
        dl = dl * validity
        lam = lam.at[ids].add(dl)
        if cfg.lambda_clamp > 0:
            lam = jnp.clip(lam, -cfg.lambda_clamp, cfg.lambda_clamp)
        dp = dl[:, None] * n
        pred = pred.at[ea].add(-wa[:, None] * dp)
        pred = pred.at[eb].add(wb[:, None] * dp)
        return pred, lam

    return lax.fori_loop(0, topo.num_colors, color_pass, (pred, lam))


def _solve_distance_jacobi(pred, lam, inv_mass, topo: Topology,
                           cfg: SolverConfig, dt, omega):
    # Jacobi with per-particle degree averaging: every constraint is projected
    # at full strength, then each particle applies the MEAN of the corrections
    # targeting it (scaled by omega, default 1).  This matches Gauss-Seidel
    # stiffness far better than a global 1/avg-degree damping — the
    # north-star's "under-relaxation at matched stiffness" conversion —
    # and is unconditionally race-free unlike XPBDSimulatorCS.compute:128-182.
    edges = topo.edges
    ea = edges[:, 0]
    eb = edges[:, 1]
    pa = pred[ea]
    pb = pred[eb]
    wa = inv_mass[ea]
    wb = inv_mass[eb]
    dl, n = _distance.distance_delta_lambda(
        pa, pb, wa, wb, topo.rest_lengths, topo.compliance, lam, dt, cfg)
    # per-edge under-relaxation 1/max(deg_a, deg_b): scales delta-lambda
    # BEFORE both the multiplier update and the position correction, so the
    # XPBD feedback term stays consistent with what was actually applied
    # (scaling only positions would stall iterations at large C).
    edge_scale = omega / jnp.maximum(
        jnp.maximum(topo.degree[ea], topo.degree[eb]), 1.0)
    dl = dl * edge_scale
    lam = _distance.accumulate_lambda(lam, dl, cfg)
    dp = dl[:, None] * n
    # scatter-free accumulation: gather each particle's contributions via
    # the precomputed incidence lists (padded gather + row-sum; no
    # scatter-add ordering)
    contrib = jnp.concatenate([-wa[:, None] * dp, wb[:, None] * dp], axis=0)
    contrib = jnp.concatenate(
        [contrib, jnp.zeros((1, 3), contrib.dtype)], axis=0)
    delta = contrib[topo.incidence].sum(axis=1)
    return pred + delta, lam


def _solve_distance_windowed(pred, lam, inv_mass, topo: Topology,
                             cfg: SolverConfig, dt, omega):
    """Jacobi distance sweep as dense one-hot block matmuls.

    Arithmetic matches ``_solve_distance_jacobi`` (same
    ``distance_delta_lambda`` clamps/guards, same omega/max-degree scaling);
    only the gather/scatter mechanics differ: endpoint gather, correction
    scatter, window extraction and overlap-add are ALL expressed as exact
    {0, +-1} one-hot matmuls (see ``topology/windows.py``).  The f32 data
    operand of every one-hot dot is split into three 8-bit slices
    (``ops/mxu_exact.dot_oh``): a DEFAULT-precision product may run in
    TF32 or bf16, which would silently round every gather.  Requires
    ``topo.windows``.
    """
    win = topo.windows
    K, S, W = win.n_blocks, win.block_edges, win.window
    n = pred.shape[0]
    seg = win.seg
    n_pad = win.n_segs * seg

    # window extraction: one one-hot matmul pulls every block's particle
    # window, with inv_mass riding along as a 4th column
    xw = jnp.concatenate([pred, inv_mass[:, None]], axis=1)       # (N, 4)
    xw = jnp.pad(xw, ((0, n_pad - n), (0, 0)))
    seg_flat = xw.reshape(win.n_segs, seg * 4)
    win_flat = _mxu.dot_oh(win.win_onehot, seg_flat,
                           (((1,), (0,)), ((), ())),
                           split="rhs")                           # (P, 4seg)
    wdat = win_flat.reshape(K, W, 4)

    pab = _mxu.dot_oh(win.AB, wdat,
                      (((2,), (1,)), ((0,), (0,))),
                      split="rhs", stack_axis=2)                  # (K,2S,4)
    pa, pb = pab[:, :S], pab[:, S:]
    wa, wb = pa[..., 3], pb[..., 3]

    lam_pad = jnp.pad(lam, (0, K * S - lam.shape[0])).reshape(K, S)
    rest = jnp.pad(topo.rest_lengths, (0, K * S - lam.shape[0]),
                   constant_values=1.0).reshape(K, S)
    comp = jnp.pad(topo.compliance,
                   (0, K * S - lam.shape[0])).reshape(K, S)
    dl, nrm = _distance.distance_delta_lambda(
        pa[..., :3], pb[..., :3], wa, wb, rest, comp, lam_pad, dt, cfg)
    dl = dl * (omega * win.inv_maxdeg)
    lam_pad = _distance.accumulate_lambda(lam_pad, dl, cfg)

    u = dl[..., None] * nrm                                       # (K,S,3)
    uu = jnp.concatenate([-wa[..., None] * u, wb[..., None] * u], axis=1)
    wd = _mxu.dot_oh(win.C, uu,
                     (((2,), (1,)), ((0,), (0,))),
                     split="rhs", stack_axis=2)                   # (K,W,3)
    pieces = wd.reshape(K * (W // seg), seg * 3)
    delta = _mxu.dot_oh(win.seg_onehot, pieces,
                        (((1,), (0,)), ((), ())),
                        split="rhs").reshape(n_pad, 3)[:n]
    return pred + delta, lam_pad.reshape(-1)[:lam.shape[0]]


# ---------------------------------------------------------------- bending
def _solve_bending_colored(pred, lam, inv_mass, topo: Topology,
                           cfg: SolverConfig, dt):
    hinges = topo.hinges

    def color_pass(c, carry):
        pred, lam = carry
        ids = topo.bcol_hinge_ids[c]
        validity = topo.bcol_valid[c]
        ia, ib, ic, idd = (hinges[ids, k] for k in range(4))
        dl, ga, gb, gc, gd = _bending.bending_delta_lambda(
            pred[ia], pred[ib], pred[ic], pred[idd],
            inv_mass[ia], inv_mass[ib], inv_mass[ic], inv_mass[idd],
            topo.rest_angles[ids], topo.bend_compliance[ids], lam[ids],
            dt, cfg)
        dl = dl * validity
        lam = lam.at[ids].add(dl)
        dlb = dl[:, None]
        pred = pred.at[ia].add(inv_mass[ia][:, None] * dlb * ga)
        pred = pred.at[ib].add(inv_mass[ib][:, None] * dlb * gb)
        pred = pred.at[ic].add(inv_mass[ic][:, None] * dlb * gc)
        pred = pred.at[idd].add(inv_mass[idd][:, None] * dlb * gd)
        return pred, lam

    return lax.fori_loop(0, topo.num_bend_colors, color_pass, (pred, lam))


def _solve_bending_jacobi(pred, lam, inv_mass, topo: Topology,
                          cfg: SolverConfig, dt, omega):
    hinges = topo.hinges
    ia, ib, ic, idd = (hinges[:, k] for k in range(4))
    dl, ga, gb, gc, gd = _bending.bending_delta_lambda(
        pred[ia], pred[ib], pred[ic], pred[idd],
        inv_mass[ia], inv_mass[ib], inv_mass[ic], inv_mass[idd],
        topo.rest_angles, topo.bend_compliance, lam, dt, cfg)
    bd = topo.bend_degree
    hinge_scale = omega / jnp.maximum(
        jnp.maximum(jnp.maximum(bd[ia], bd[ib]),
                    jnp.maximum(bd[ic], bd[idd])), 1.0)
    dl = dl * hinge_scale
    lam = lam + dl
    dlb = dl[:, None]
    contrib = jnp.concatenate([
        inv_mass[ia][:, None] * dlb * ga,
        inv_mass[ib][:, None] * dlb * gb,
        inv_mass[ic][:, None] * dlb * gc,
        inv_mass[idd][:, None] * dlb * gd,
    ], axis=0)
    contrib = jnp.concatenate(
        [contrib, jnp.zeros((1, 3), contrib.dtype)], axis=0)
    delta = contrib[topo.bend_incidence].sum(axis=1)
    return pred + delta, lam


def _solve_bending_windowed(pred, lam, inv_mass, topo: Topology,
                            cfg: SolverConfig, dt, omega):
    """Jacobi bending sweep as dense signed-one-hot block matmuls.

    Arithmetic matches ``_solve_bending_jacobi`` (same
    ``bending_delta_lambda`` guards, same omega/max-degree scaling); the
    4-endpoint gathers/scatters ride matmuls instead of ``bend_incidence``
    walks.  One signed matrix per block serves both directions: the gather
    computes the difference vectors e0/e1/e2 directly (bending is
    translation-invariant), and scattering [dl*gB | dl*gC | dl*gD] through
    its transpose lands -dl*(gB+gC+gD) = dl*gA on the hinge root, so the
    A-side never needs its own matrix (see ``core.state.HingeWindows``).
    The per-endpoint inverse-mass weight is the DESTINATION particle's, so
    it is applied after the overlap-add.  Every one-hot dot splits its
    f32 data operand into three 8-bit slices (``ops/mxu_exact.dot_oh``),
    exact at any matmul precision.  Requires
    ``topo.bend_windows``.
    """
    win = topo.bend_windows
    kb, s, w = win.n_blocks, win.block_hinges, win.window
    n = pred.shape[0]
    seg = win.seg
    n_pad = win.n_segs * seg

    xw = jnp.concatenate([pred, inv_mass[:, None]], axis=1)       # (N, 4)
    xw = jnp.pad(xw, ((0, n_pad - n), (0, 0)))
    seg_flat = xw.reshape(win.n_segs, seg * 4)
    win_flat = _mxu.dot_oh(win.win_onehot, seg_flat,
                           (((1,), (0,)), ((), ())),
                           split="rhs")                           # (P, 4seg)
    wdat = win_flat.reshape(kb, w, 4)

    wparts = _mxu.split3(wdat)
    e012 = _mxu.dot_oh(
        win.G, wdat[..., :3],
        (((1,), (1,)), ((0,), (0,))), split="rhs", stack_axis=2,
        parts=jnp.concatenate([p[..., :3] for p in wparts],
                              axis=2))                            # (Kb,3S,3)
    e0, e1, e2 = e012[:, :s], e012[:, s:2 * s], e012[:, 2 * s:]
    wabcd = _mxu.dot_oh(
        win.wsel, wdat[..., 3:],
        (((1,), (1,)), ((0,), (0,))), split="rhs", stack_axis=2,
        parts=jnp.concatenate([p[..., 3:] for p in wparts],
                              axis=2))                            # (Kb,4S,1)
    wabcd = wabcd[..., 0]
    wa, wb = wabcd[:, :s], wabcd[:, s:2 * s]
    wc, wd = wabcd[:, 2 * s:3 * s], wabcd[:, 3 * s:]

    lam_pad = jnp.pad(lam, (0, kb * s - lam.shape[0])).reshape(kb, s)
    rest = jnp.pad(topo.rest_angles, (0, kb * s - lam.shape[0])
                   ).reshape(kb, s)
    comp = jnp.pad(topo.bend_compliance, (0, kb * s - lam.shape[0])
                   ).reshape(kb, s)
    dl, _ga, gb, gc, gd = _bending.bending_delta_lambda_rel(
        e0, e1, e2, wa, wb, wc, wd, rest, comp, lam_pad, dt, cfg)
    dl = dl * (omega * win.inv_maxdeg)
    lam_pad = lam_pad + dl

    dlb = dl[..., None]
    uu = jnp.concatenate([dlb * gb, dlb * gc, dlb * gd], axis=1)  # (Kb,3S,3)
    wdelta = _mxu.dot_oh(win.GT, uu,
                         (((1,), (1,)), ((0,), (0,))),
                         split="rhs", stack_axis=2)               # (Kb,W,3)
    pieces = wdelta.reshape(kb * (w // seg), seg * 3)
    delta = _mxu.dot_oh(win.seg_onehot, pieces,
                        (((1,), (0,)), ((), ())),
                        split="rhs").reshape(n_pad, 3)[:n]
    return pred + inv_mass[:, None] * delta, \
        lam_pad.reshape(-1)[:lam.shape[0]]


def _solve_tets_windowed(pred, lam, inv_mass, topo: Topology,
                         cfg: SolverConfig, dt, omega):
    """Mass-splitting Jacobi tet sweep as dense signed-one-hot block
    matmuls — ``_solve_tets_jacobi`` semantics with the 4-endpoint
    gathers/scatters riding ``topo.tet_windows`` instead of
    ``tet_incidence`` walks (the bending machinery verbatim: the signed
    matrix gathers e1/e2/e3 = tip - root directly, and scattering
    [dl*g1 | dl*g2 | dl*g3] through its transpose lands
    -dl*(g1+g2+g3) = dl*g0 on the root).  Unlike bending there is NO
    per-constraint 1/max-degree prescale — tets keep the full-strength
    projection and each particle applies the MEAN of the corrections
    targeting it (``inv_mass / tet_degree`` after the overlap-add; see
    the fan-hub rationale in ``_solve_tets_jacobi``).  Summation order
    differs from the gather path (fp reorder), hence opt-in via
    ``cfg.tet_backend='windowed'``."""
    win = topo.tet_windows
    perm = topo.tet_window_perm
    kb, s, w = win.n_blocks, win.block_hinges, win.window
    n = pred.shape[0]
    seg = win.seg
    n_pad = win.n_segs * seg

    xw = jnp.concatenate([pred, inv_mass[:, None]], axis=1)       # (N, 4)
    xw = jnp.pad(xw, ((0, n_pad - n), (0, 0)))
    seg_flat = xw.reshape(win.n_segs, seg * 4)
    win_flat = _mxu.dot_oh(win.win_onehot, seg_flat,
                           (((1,), (0,)), ((), ())),
                           split="rhs")                           # (P, 4seg)
    wdat = win_flat.reshape(kb, w, 4)

    wparts = _mxu.split3(wdat)
    e123 = _mxu.dot_oh(
        win.G, wdat[..., :3],
        (((1,), (1,)), ((0,), (0,))), split="rhs", stack_axis=2,
        parts=jnp.concatenate([p[..., :3] for p in wparts],
                              axis=2))                            # (Kb,3S,3)
    e1, e2, e3 = e123[:, :s], e123[:, s:2 * s], e123[:, 2 * s:]
    wabcd = _mxu.dot_oh(
        win.wsel, wdat[..., 3:],
        (((1,), (1,)), ((0,), (0,))), split="rhs", stack_axis=2,
        parts=jnp.concatenate([p[..., 3:] for p in wparts],
                              axis=2))                            # (Kb,4S,1)
    wabcd = wabcd[..., 0]
    w0, w1 = wabcd[:, :s], wabcd[:, s:2 * s]
    w2, w3 = wabcd[:, 2 * s:3 * s], wabcd[:, 3 * s:]

    t = perm.shape[0]
    lam_w = jnp.pad(lam[perm], (0, kb * s - t)).reshape(kb, s)
    rest = jnp.pad(topo.rest_tet_volumes[perm],
                   (0, kb * s - t)).reshape(kb, s)
    comp = jnp.pad(topo.tet_compliance[perm],
                   (0, kb * s - t)).reshape(kb, s)
    dl, _g0, g1, g2, g3 = _tet_volume.tet_delta_lambda_rel(
        e1, e2, e3, w0, w1, w2, w3, rest, comp, lam_w, dt, cfg)
    dl = dl * (omega * win.valid)     # valid kills the padded slots
    lam_w = lam_w + dl

    dlb = dl[..., None]
    uu = jnp.concatenate([dlb * g1, dlb * g2, dlb * g3], axis=1)  # (Kb,3S,3)
    wdelta = _mxu.dot_oh(win.GT, uu,
                         (((1,), (1,)), ((0,), (0,))),
                         split="rhs", stack_axis=2)               # (Kb,W,3)
    pieces = wdelta.reshape(kb * (w // seg), seg * 3)
    delta = _mxu.dot_oh(win.seg_onehot, pieces,
                        (((1,), (0,)), ((), ())),
                        split="rhs").reshape(n_pad, 3)[:n]
    scale = inv_mass / jnp.maximum(topo.tet_degree, 1.0)
    pred = pred + scale[:, None] * delta
    lam = lam.at[perm].set(lam_w.reshape(-1)[:t])
    return pred, lam


# ------------------------------------------------------------- tet volume
def _solve_tets_colored(pred, lam, inv_mass, topo: Topology,
                        cfg: SolverConfig, dt):
    """Exact parallel Gauss-Seidel over the per-tet volume family: one
    batched projection per conflict-free color (no two tets in a color
    share a particle, so the batched update equals the sequential sweep
    in color-major order — same guarantee as the distance/bending
    COLORED modes)."""
    tets = topo.tets

    def color_pass(c, carry):
        pred, lam = carry
        ids = topo.tcol_tet_ids[c]
        validity = topo.tcol_valid[c]
        i0, i1, i2, i3 = (tets[ids, k] for k in range(4))
        dl, g0, g1, g2, g3 = _tet_volume.tet_delta_lambda(
            pred[i0], pred[i1], pred[i2], pred[i3],
            inv_mass[i0], inv_mass[i1], inv_mass[i2], inv_mass[i3],
            topo.rest_tet_volumes[ids], topo.tet_compliance[ids],
            lam[ids], dt, cfg)
        dl = dl * validity
        lam = lam.at[ids].add(dl)
        dlb = dl[:, None]
        pred = pred.at[i0].add(inv_mass[i0][:, None] * dlb * g0)
        pred = pred.at[i1].add(inv_mass[i1][:, None] * dlb * g1)
        pred = pred.at[i2].add(inv_mass[i2][:, None] * dlb * g2)
        pred = pred.at[i3].add(inv_mass[i3][:, None] * dlb * g3)
        return pred, lam

    return lax.fori_loop(0, topo.num_tet_colors, color_pass, (pred, lam))


def _solve_tets_jacobi(pred, lam, inv_mass, topo: Topology,
                      cfg: SolverConfig, dt, omega):
    """Mass-splitting Jacobi over the tet family: every tet is projected at
    FULL strength, then each particle applies the MEAN of the corrections
    targeting it (divide by its tet degree), accumulated scatter-free via
    ``tet_incidence``.

    This deliberately differs from the distance/bending sweeps' per-
    -constraint 1/max-degree pre-scaling: tet decompositions routinely
    contain extreme-degree hubs (the centroid of a
    ``tets_from_surface_centroid`` fan touches EVERY tet), and pre-scaling
    by the max endpoint degree collapses all corrections to ~1/n_tets —
    measured: a pressurized fan ball never reaches its target volume.
    Per-particle averaging keeps low-degree (surface) particles converging
    at their own rate while the hub — whose wanted net correction is near
    zero by symmetry — just averages.  The multiplier accumulates the
    omega-scaled full projection (standard solve-then-average XPBD
    Jacobi); for the common incompressible case (compliance 0) the
    feedback term vanishes anyway."""
    tets = topo.tets
    i0, i1, i2, i3 = (tets[:, k] for k in range(4))
    dl, g0, g1, g2, g3 = _tet_volume.tet_delta_lambda(
        pred[i0], pred[i1], pred[i2], pred[i3],
        inv_mass[i0], inv_mass[i1], inv_mass[i2], inv_mass[i3],
        topo.rest_tet_volumes, topo.tet_compliance, lam, dt, cfg)
    dl = dl * omega
    lam = lam + dl
    dlb = dl[:, None]
    contrib = jnp.concatenate([
        inv_mass[i0][:, None] * dlb * g0,
        inv_mass[i1][:, None] * dlb * g1,
        inv_mass[i2][:, None] * dlb * g2,
        inv_mass[i3][:, None] * dlb * g3,
    ], axis=0)
    contrib = jnp.concatenate(
        [contrib, jnp.zeros((1, 3), contrib.dtype)], axis=0)
    delta = contrib[topo.tet_incidence].sum(axis=1)
    delta = delta / jnp.maximum(topo.tet_degree, 1.0)[:, None]
    return pred + delta, lam


# ---------------------------------------------------------------- substep
def _warm_apply_distance(pred, lam, inv_mass, topo: Topology,
                         cfg: SolverConfig):
    """Pre-apply carried distance impulses along current edge directions.

    Applied with the same per-edge 1/max-degree relaxation as the Jacobi
    pass — simultaneous full-strength application over-corrects shared
    particles (degree-6 mesh vertices explode within a few steps) — and the
    carried multiplier is scaled identically so the XPBD feedback term stays
    consistent with what was actually applied.  Additionally clamped so the
    applied correction never exceeds warm_start_clamp * rest per particle
    (light particles amplify lambda noise).  Returns (pred, lam)."""
    ea = topo.edges[:, 0]
    eb = topo.edges[:, 1]
    scale = 1.0 / jnp.maximum(
        jnp.maximum(topo.degree[ea], topo.degree[eb]), 1.0)
    if cfg.warm_start_fraction != 1.0:
        scale = scale * cfg.warm_start_fraction  # SOR pre-application
    lam = lam * scale
    if cfg.warm_start_clamp > 0:
        wmax = jnp.maximum(
            jnp.maximum(inv_mass[ea], inv_mass[eb]), 1e-12)
        lim = cfg.warm_start_clamp * topo.rest_lengths / wmax
        lam = jnp.clip(lam, -lim, lim)
    d = pred[eb] - pred[ea]
    length = jnp.sqrt(jnp.maximum(jnp.sum(d * d, axis=-1), 1e-24))
    n = d / length[:, None]
    dp = lam[:, None] * n
    wa = inv_mass[ea]
    wb = inv_mass[eb]
    contrib = jnp.concatenate([-wa[:, None] * dp, wb[:, None] * dp], axis=0)
    contrib = jnp.concatenate(
        [contrib, jnp.zeros((1, 3), contrib.dtype)], axis=0)
    pred = pred + contrib[topo.incidence].sum(axis=1)
    return pred, lam


def _substep(state: SimState, topo: Topology, cfg: SolverConfig, dt,
             apply_ext, contact_on: bool = True):
    # contact_on is a trace-time flag: the self-collision cadence
    # (cfg.self_collision_every) compiles substeps with the contact pass
    # structurally absent rather than branching at runtime.
    # lambda lifecycle (LambdaMode docstring)
    lam_t = state.lambda_tet
    if cfg.lambda_mode == LambdaMode.RESET:
        lam_d = jnp.zeros_like(state.lambda_dist)
        lam_b = jnp.zeros_like(state.lambda_bend)
        lam_v = jnp.zeros_like(state.lambda_volume)
        lam_t = None if lam_t is None else jnp.zeros_like(lam_t)
    elif cfg.lambda_mode == LambdaMode.WARM_START:
        # only distance impulses are pre-applied; bending/volume restart
        # fresh (carrying them un-applied would weaken them, see LambdaMode)
        lam_d = state.lambda_dist * cfg.lambda_decay
        lam_b = jnp.zeros_like(state.lambda_bend)
        lam_v = jnp.zeros_like(state.lambda_volume)
        lam_t = None if lam_t is None else jnp.zeros_like(lam_t)
    else:
        lam_d = state.lambda_dist * cfg.lambda_decay
        lam_b = state.lambda_bend * cfg.lambda_decay
        lam_v = state.lambda_volume * cfg.lambda_decay
        lam_t = None if lam_t is None else lam_t * cfg.lambda_decay

    pred, vel = _integrate.predict(
        state.positions, state.velocities, state.inv_mass, state.ext_force,
        dt, cfg, apply_ext=apply_ext)

    if cfg.lambda_mode == LambdaMode.WARM_START:
        # consistent warm start: the carried impulse is applied up front, so
        # the XPBD feedback term (-C - alpha~*lambda) remains truthful
        pred, lam_d = _warm_apply_distance(pred, lam_d, state.inv_mass, topo,
                                           cfg)

    # omega scales the degree-averaged Jacobi update; 1.0 (the default) gives
    # GS-matched stiffness, <1 softens, >1 over-relaxes.
    omega = jnp.asarray(cfg.omega if cfg.omega > 0 else 1.0, pred.dtype)

    has_bending = cfg.enable_bending and topo.n_hinges > 0
    has_volume = cfg.enable_volume and topo.triangles.shape[0] > 0
    has_tets = (cfg.enable_tet_volume and topo.n_tets > 0
                and lam_t is not None)

    use_windowed = (cfg.distance_backend == "windowed"
                    or (cfg.distance_backend == "auto"
                        and topo.windows is not None))
    if use_windowed and topo.windows is None:
        raise ValueError("distance_backend='windowed' requires a topology "
                         "built with build_windowed_topology")
    use_windowed_bend = (cfg.bending_backend == "windowed"
                         or (cfg.bending_backend == "auto"
                             and topo.bend_windows is not None))
    if use_windowed_bend and topo.bend_windows is None:
        raise ValueError("bending_backend='windowed' requires a topology "
                         "with hinge windows (build_windowed_topology)")
    use_windowed_tets = cfg.tet_backend == "windowed"
    if use_windowed_tets and has_tets and topo.tet_windows is None:
        raise ValueError("tet_backend='windowed' requires a topology with "
                         "tet windows (build_windowed_topology; centroid "
                         "fans exceed the window bound and stay on gather)")

    sc_on = cfg.enable_self_collision and contact_on
    if sc_on and _spatial_hash.needs_morton_order(cfg):
        # Morton neighbor ordering built ONCE per substep from the predicted
        # positions; the window/blocked passes reuse it across iterations
        sc_order = _spatial_hash.morton_order(pred, cfg)
    else:
        sc_order = None

    # kinematic rigid world: when the state carries a ColliderSet its traced
    # poses REPLACE the config constants (core/colliders.py) — same
    # formulas, animatable per step with no recompile.  Presence and
    # collider COUNTS are static at trace time, so the branch structure
    # below stays compile-time either way.
    coll = state.colliders
    if coll is None:
        gh_op, sph_op, sphv_op, box_op, boxv_op = None, None, None, None, None
        has_spheres = bool(cfg.sphere_colliders)
        has_boxes = bool(cfg.box_colliders)
    else:
        gh_op = coll.ground_height
        sph_op, sphv_op = coll.spheres, coll.sphere_velocities
        box_op, boxv_op = coll.boxes, coll.box_velocities
        has_spheres = coll.n_spheres > 0
        has_boxes = coll.n_boxes > 0

    def project_contacts(pred):
        """Unilateral contact projections (self-collision, floor, SDFs)."""
        if sc_on:
            pred = _spatial_hash.project_self_collision(
                pred, state.inv_mass, sc_order, cfg)
        if cfg.floor_mode == FloorMode.XPBD_INEQUALITY:
            pred = _collision.floor_project_xpbd(
                pred, state.positions, state.inv_mass, dt, cfg,
                ground_height=gh_op)
        if has_spheres:
            pred = _collision.sphere_sdf_project(
                pred, state.positions, state.inv_mass, dt, cfg,
                spheres=sph_op, sphere_velocities=sphv_op)
        if has_boxes:
            pred = _collision.box_sdf_project(
                pred, state.positions, state.inv_mass, dt, cfg,
                boxes=box_op, box_velocities=boxv_op)
        return pred

    has_contacts = (sc_on
                    or cfg.floor_mode == FloorMode.XPBD_INEQUALITY
                    or has_spheres or has_boxes)

    def project_all(pred, lam_d, lam_b, lam_v, lam_t):
        """One full projection sweep over every constraint family."""
        if cfg.solve_mode == SolveMode.COLORED:
            pred, lam_d = _solve_distance_colored(
                pred, lam_d, state.inv_mass, topo, cfg, dt)
        elif use_windowed:
            pred, lam_d = _solve_distance_windowed(
                pred, lam_d, state.inv_mass, topo, cfg, dt, omega)
        else:
            pred, lam_d = _solve_distance_jacobi(
                pred, lam_d, state.inv_mass, topo, cfg, dt, omega)
        if has_bending:
            if cfg.solve_mode == SolveMode.COLORED:
                pred, lam_b = _solve_bending_colored(
                    pred, lam_b, state.inv_mass, topo, cfg, dt)
            elif use_windowed_bend:
                pred, lam_b = _solve_bending_windowed(
                    pred, lam_b, state.inv_mass, topo, cfg, dt, omega)
            else:
                pred, lam_b = _solve_bending_jacobi(
                    pred, lam_b, state.inv_mass, topo, cfg, dt, omega)
        if has_tets:
            if cfg.solve_mode == SolveMode.COLORED:
                pred, lam_t = _solve_tets_colored(
                    pred, lam_t, state.inv_mass, topo, cfg, dt)
            elif use_windowed_tets:
                pred, lam_t = _solve_tets_windowed(
                    pred, lam_t, state.inv_mass, topo, cfg, dt, omega)
            else:
                pred, lam_t = _solve_tets_jacobi(
                    pred, lam_t, state.inv_mass, topo, cfg, dt, omega)
        if has_volume:
            pred, lam_v = _volume.volume_project(
                pred, state.inv_mass, topo.triangles, topo.rest_volume,
                lam_v, dt, cfg)
        pred = project_contacts(pred)
        return pred, lam_d, lam_b, lam_v, lam_t

    accelerate = (cfg.solve_mode == SolveMode.JACOBI and cfg.jacobi_rho > 0
                  and cfg.iterations > cfg.jacobi_cheby_delay)
    if accelerate:
        # Chebyshev semi-iterative acceleration (the standard accelerated-PBD
        # recurrence): Jacobi is all-parallel but propagates information one
        # edge per iteration; the momentum term restores Gauss-Seidel-class
        # convergence while keeping the solver a single fused data-parallel
        # pass — the data-parallel answer to the reference's sequential
        # color sweeps.
        rho2 = cfg.jacobi_rho ** 2
        gamma = cfg.jacobi_gamma

        def iteration(k, carry):
            pred_prev, pred, lam_d, lam_b, lam_v, lam_t, om = carry
            new, lam_d, lam_b, lam_v, lam_t = project_all(
                pred, lam_d, lam_b, lam_v, lam_t)
            om_next = jnp.where(
                k < cfg.jacobi_cheby_delay, 1.0,
                jnp.where(k == cfg.jacobi_cheby_delay, 2.0 / (2.0 - rho2),
                          4.0 / (4.0 - rho2 * om)))
            acc = om_next * (gamma * (new - pred) + pred - pred_prev) \
                + pred_prev
            # the momentum extrapolation can re-penetrate unilateral
            # contacts the sweep just resolved (accelerated-PBD excludes
            # contact from the momentum update); re-project them once so the
            # substep's final iterate is contact-feasible
            if has_contacts:
                acc = project_contacts(acc)
            return pred, acc, lam_d, lam_b, lam_v, lam_t, om_next

        _, pred, lam_d, lam_b, lam_v, lam_t, _ = lax.fori_loop(
            0, cfg.iterations, iteration,
            (pred, pred, lam_d, lam_b, lam_v, lam_t,
             jnp.ones((), pred.dtype)))
    else:
        def iteration(_, carry):
            return project_all(*carry)

        pred, lam_d, lam_b, lam_v, lam_t = lax.fori_loop(
            0, cfg.iterations, iteration, (pred, lam_d, lam_b, lam_v, lam_t))

    # finalize with the velocities produced by predict (reference keeps
    # velocity purely derived from positions: SoftBodyCPU.cs:314-324)
    x, v = _integrate.finalize(state.positions, pred, state.inv_mass, dt)

    if cfg.floor_mode == FloorMode.VELOCITY_REFLECT:
        # flagship-style velocity-level floor response, applied post-substep
        # (XPBDSoftBody.compute:272-316; the flagship has no predict/finalize
        # split, so 'after finalize' is the faithful placement here)
        x, v = _collision.floor_velocity_reflect(x, v, state.inv_mass, dt, cfg,
                                                 ground_height=gh_op)

    return state.replace(
        positions=x,
        velocities=v,
        lambda_dist=lam_d,
        lambda_bend=lam_b,
        lambda_volume=lam_v,
        lambda_tet=lam_t,
    )


def step_fn(state: SimState, topo: Topology, cfg: SolverConfig,
            dt: float) -> SimState:
    """One physics step = ``cfg.substeps`` substeps under lax.scan.

    External forces (``state.ext_force``) are consumed on the first substep
    and zeroed afterwards, matching the reference's accumulate-then-clear
    force lifecycle (``SoftBodyParticleCPU.cs:25-33``,
    ``XPBDSoftBody.compute:100-101``).
    """
    dt_sub = dt / cfg.substeps
    every = cfg.self_collision_every if cfg.enable_self_collision else 1
    state = _substep(state, topo, cfg, dt_sub, apply_ext=True)
    if cfg.substeps > 1:
        if every == 1:
            def body(carry, _):
                return _substep(carry, topo, cfg, dt_sub,
                                apply_ext=False), None

            state, _ = lax.scan(body, state, None, length=cfg.substeps - 1)
        else:
            # Contact cadence: substep i runs self-collision iff i % every
            # == 0.  Substep 0 (above) always does.  The remaining substeps
            # form `n_full` repeating groups of (every-1 contact-free + 1
            # contact) — a static structure, so the scan body compiles both
            # substep flavors once and no runtime branch is needed — plus a
            # contact-free tail.
            rem = cfg.substeps - 1
            n_full, tail = divmod(rem, every)
            if n_full:
                def body(carry, _):
                    s = carry
                    for _ in range(every - 1):
                        s = _substep(s, topo, cfg, dt_sub, apply_ext=False,
                                     contact_on=False)
                    s = _substep(s, topo, cfg, dt_sub, apply_ext=False,
                                 contact_on=True)
                    return s, None

                state, _ = lax.scan(body, state, None, length=n_full)
            for _ in range(tail):
                state = _substep(state, topo, cfg, dt_sub, apply_ext=False,
                                 contact_on=False)
    return state.replace(ext_force=jnp.zeros_like(state.ext_force))


def multi_step_fn(state: SimState, topo: Topology, cfg: SolverConfig,
                  dt: float, n_steps: int) -> SimState:
    """n_steps physics steps fused into one device program (for benchmarks
    and long offline rollouts — zero host involvement)."""
    def body(carry, _):
        return step_fn(carry, topo, cfg, dt), None

    state, _ = lax.scan(body, state, None, length=n_steps)
    return state


@functools.partial(jax.jit, static_argnames=("cfg", "dt"))
def step(state: SimState, topo: Topology, cfg: SolverConfig,
         dt: float) -> SimState:
    return step_fn(state, topo, cfg, dt)


def make_step(topo: Topology, cfg: SolverConfig, dt: float, n_steps: int = 1):
    """Build a jitted ``state -> state`` advancing ``n_steps`` steps.

    The topology rides as a TRACED argument (device buffers), not a jit
    closure: closed-over arrays are inlined as HLO constants, and at scale
    the windowed one-hot matrices dominate the serialized program (a 32k-
    edge mesh embeds ~33 MB of window blocks).  Passing them as arguments
    keeps the program small and the buffers resident across calls."""
    topo_d = jax.device_put(topo)

    @jax.jit
    def fn2(state: SimState, t: Topology) -> SimState:
        return multi_step_fn(state, t, cfg, dt, n_steps)

    def fn(state: SimState) -> SimState:
        return fn2(state, topo_d)

    return fn
