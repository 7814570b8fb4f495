"""Spatial sharding of one lattice across chips with halo exchange — must be
arithmetically equivalent to the single-device stencil engine."""

import numpy as np
import pytest

import jax

from softbodysimulation_tpu import (
    FloorMode,
    LambdaMode,
    SolveMode,
    SolverConfig,
)
from softbodysimulation_tpu.parallel import batch as pbatch
from softbodysimulation_tpu.parallel import spatial
from softbodysimulation_tpu.solvers import lattice as lat_engine
from softbodysimulation_tpu.topology import lattice

DT = 0.02

pytestmark = pytest.mark.skipif(
    jax.device_count() < 4, reason="needs >=4 devices")


def run_pair(cfg, res=8, n_shards=4, steps=30, center=(0, 1.2, 0)):
    spec = lattice.lattice_spec(res, braced=True)
    state0 = lat_engine.make_lattice_state(
        spec, center=center, tet_volume=cfg.enable_tet_volume)
    mesh = pbatch.make_mesh(n_shards, axis="x")

    sharded = spatial.shard_lattice_state(state0, spec, mesh)
    step_sh = spatial.make_spatial_lattice_step(spec, cfg, DT, mesh,
                                                n_steps=steps)
    out_sh = step_sh(sharded)

    step_1 = lat_engine.make_step(spec, cfg, DT, n_steps=steps)
    out_1 = step_1(state0)
    return out_sh, out_1


@pytest.mark.parametrize("mode", [SolveMode.COLORED, SolveMode.JACOBI])
def test_sharded_matches_single_device(mode):
    cfg = SolverConfig(substeps=2, iterations=2, damping=0.02,
                       solve_mode=mode, ground_height=0.0, friction=0.3)
    out_sh, out_1 = run_pair(cfg)
    # the sharded engine keeps the (res,res,res,3) layout while the
    # single-chip engine uses (3,res,res^2); identical semantics, slightly
    # different fp op order -> small tolerance over 30 contact steps
    d = np.abs(np.asarray(out_sh.positions)
               - np.asarray(out_1.positions)).max()
    assert d < 1e-4, f"halo-exchange step diverges from single-chip: {d}"
    dl = np.abs(np.asarray(out_sh.lambda_dist)
                - np.asarray(out_1.lambda_dist)).max()
    assert dl < 1e-3


def test_sharded_warm_start_matches():
    cfg = SolverConfig(substeps=4, iterations=1, damping=0.02,
                       solve_mode=SolveMode.JACOBI,
                       lambda_mode=LambdaMode.WARM_START, lambda_decay=1.0,
                       ground_height=0.0, friction=0.3)
    out_sh, out_1 = run_pair(cfg, steps=50)
    d = np.abs(np.asarray(out_sh.positions)
               - np.asarray(out_1.positions)).max()
    # cross-layout fp noise amplified by 50 steps of floor contact
    assert d < 1e-3, f"warm-start sharded drift {d}"


def test_sharded_pinned_and_floor():
    cfg = SolverConfig(substeps=2, iterations=2, damping=0.05,
                       solve_mode=SolveMode.COLORED,
                       floor_mode=FloorMode.XPBD_INEQUALITY,
                       ground_height=0.0, friction=0.5)
    spec = lattice.lattice_spec(8, braced=True)
    state0 = lat_engine.make_lattice_state(spec, center=(0, 0.8, 0))
    # pin particles living on TWO different shards
    pins = np.array([0, spec.n_particles - 1])
    state0 = state0.replace(inv_mass=state0.inv_mass.at[pins].set(0.0))
    mesh = pbatch.make_mesh(4, axis="x")
    sharded = spatial.shard_lattice_state(state0, spec, mesh)
    step_sh = spatial.make_spatial_lattice_step(spec, cfg, DT, n_steps=60,
                                                mesh=mesh)
    out = step_sh(sharded)
    p = np.asarray(out.positions)
    p0 = np.asarray(state0.positions)
    assert np.allclose(p[pins], p0[pins], atol=1e-6)
    assert np.isfinite(p).all()
    assert p[:, 1].min() > -5e-3


@pytest.mark.parametrize("lmode", [LambdaMode.RESET, LambdaMode.DECAY])
def test_sharded_tets_match_single_device(lmode):
    """Solid lattices shard too: the per-cell tet family runs as
    _sharded_tet_sweep (one pred/w right-halo fetch for all 6 Kuhn paths,
    one correction spill pushed right after them).  Boundary lanes sum
    their gradient contributions in a different order than the single-chip
    engine (deferred halo add), so the gate is the file's fp-reorder
    tolerance, not bit equality."""
    cfg = SolverConfig(substeps=2, iterations=2, damping=0.02,
                       solve_mode=SolveMode.JACOBI, lambda_mode=lmode,
                       enable_tet_volume=True,
                       ground_height=0.0, friction=0.3)
    out_sh, out_1 = run_pair(cfg)
    p = np.asarray(out_sh.positions)
    assert np.isfinite(p).all()
    d = np.abs(p - np.asarray(out_1.positions)).max()
    assert d < 1e-4, f"sharded tet sweep diverges from single-chip: {d}"
    dt_ = np.abs(np.asarray(out_sh.lambda_tet)
                 - np.asarray(out_1.lambda_tet)).max()
    assert dt_ < 1e-3, f"sharded tet multipliers diverge: {dt_}"
    # discriminator: tets-off trajectory must differ clearly, so the
    # tolerance above cannot mask a silently-dropped tet family
    off_sh, _ = run_pair(cfg.replace(enable_tet_volume=False))
    d_off = np.abs(p - np.asarray(off_sh.positions)).max()
    assert d_off > 1e-3, f"tets indistinguishable from tets-off: {d_off}"


def test_res_not_divisible_raises():
    spec = lattice.lattice_spec(6, braced=True)
    mesh = pbatch.make_mesh(4, axis="x")
    cfg = SolverConfig()
    with pytest.raises(ValueError, match="divisible"):
        spatial.make_spatial_lattice_step(spec, cfg, DT, mesh)


def test_sharded_sphere_collider_matches():
    cfg = SolverConfig(substeps=2, iterations=2, damping=0.03,
                       solve_mode=SolveMode.JACOBI,
                       gravity_is_acceleration=True,
                       ground_height=-5.0, friction=0.4,
                       sphere_colliders=((0.0, 0.0, 0.0, 0.8),))
    out_sh, out_1 = run_pair(cfg, res=8, steps=40, center=(0, 1.6, 0))
    p = np.asarray(out_sh.positions)
    assert np.isfinite(p).all()
    # body rests on the sphere (or rolled off above the low floor)
    d = np.abs(p - np.asarray(out_1.positions)).max()
    assert d < 1e-3, f"sphere-collider sharded drift {d}"
    r = np.linalg.norm(p, axis=1)
    assert r.min() > 0.77


def test_sharded_kinematic_collider_sweeps_across_mesh():
    """Kinematic colliders on the spatial engine: the spatially-
    sharded engine reads the state's TRACED ColliderSet (replicated to
    every chip) instead of config constants — a sphere sweeping along the
    sharded x-axis crosses every shard boundary and must track the
    single-chip stencil engine with the identical animated poses.  The
    config ground (123) is bogus on purpose: only the traced world can
    explain agreement."""
    from softbodysimulation_tpu import make_colliders

    cfg = SolverConfig(substeps=2, iterations=2, damping=0.02,
                       solve_mode=SolveMode.COLORED, ground_height=123.0,
                       friction=0.3)
    spec = lattice.lattice_spec(8, braced=True)
    state0 = lat_engine.make_lattice_state(spec, center=(0, 1.0, 0))
    coll = make_colliders(spheres=[(-1.2, 0.9, 0.0, 0.45)],
                          ground_height=0.0)
    state0 = state0.replace(colliders=coll)

    mesh = pbatch.make_mesh(4, axis="x")
    step_sh = spatial.make_spatial_lattice_step(spec, cfg, DT, mesh,
                                                kin_colliders=(1, 0))
    step_1 = lat_engine.make_step(spec, cfg, DT)

    st_sh = spatial.shard_lattice_state(state0, spec, mesh)
    st_1 = state0
    n = 24
    xs = np.linspace(-1.2, 1.2, n, dtype=np.float32)
    for i in range(n):
        vel = (float((xs[min(i + 1, n - 1)] - xs[i]) / DT), 0.0, 0.0)
        cs = coll.with_sphere(0, center=(float(xs[i]), 0.9, 0.0),
                              velocity=vel)
        st_sh = step_sh(st_sh.replace(colliders=cs))
        st_1 = step_1(st_1.replace(colliders=cs))
    ps = np.asarray(st_sh.positions)
    p1 = np.asarray(st_1.positions)
    assert np.isfinite(ps).all()
    d = np.abs(ps - p1).max()
    assert d < 1e-4, f"sharded kinematic sweep diverges: {d}"
    # the sweep visibly shoved the body sideways
    assert abs(ps[:, 0].mean()) > 0.02

    # contract checks: missing / mismatched ColliderSet
    with pytest.raises(ValueError):
        step_sh(st_sh.replace(colliders=None))
    with pytest.raises(ValueError, match="kin_colliders"):
        step_sh(st_sh.replace(colliders=make_colliders(
            spheres=[(0.0, 0.9, 0.0, 0.4)] * 2, ground_height=0.0)))
