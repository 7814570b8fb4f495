"""Kinematic rigid colliders (the moving rigid world).

The reference's rigid world MOVES: PhysX colliders translate through the
scene (``SoftBodyController.cs:110-118``) and the floor is re-raycast every
substep (``SoftBodySimulator.cs:777-788``).  Here that capability is the
``ColliderSet`` state leaf (``core/colliders.py``): traced poses that
animate per step with no recompile.  These tests pin:

* exact equivalence of the traced path with the config-constant path,
* the override contract (state colliders replace the config's rigid world),
* zero recompiles across an animated sweep,
* on-device ``kinematic_rollout`` == host-loop animation,
* oracle parity for an animated floor (the oracle re-folds the constant
  per frame — it is NumPy and unjitted, so that is free),
* gradients w.r.t. a collider trajectory (contact-rich control).
"""

import numpy as np
import jax
import jax.numpy as jnp

from softbodysimulation_tpu import (
    FloorMode,
    SolveMode,
    SolverConfig,
    colliders_from_config,
    make_colliders,
    state_from_topology,
)
from softbodysimulation_tpu.interact import animator, forces
from softbodysimulation_tpu.solvers import general as G
from softbodysimulation_tpu.solvers import reference_cpu
from softbodysimulation_tpu.topology import build, lattice, mesh

DT = 1 / 60


def _pinned_cloth(res=8, y=1.0, size=1.2):
    """Horizontal cloth at height y, rim pinned."""
    m = mesh.grid_plane(size, res)
    pos, topo = build.topology_from_mesh(m, compliance=1e-4)
    pos = pos + np.array([0, y, 0], np.float32)
    state = state_from_topology(topo, pos)
    ii, jj = np.divmod(np.arange(res * res), res)
    rim = np.flatnonzero((ii % (res - 1) == 0) | (jj % (res - 1) == 0))
    state = forces.pin_indices(state, rim, pinned=True)
    return state, topo


def _run(state, step, n):
    for _ in range(n):
        state = step(state)
    return np.asarray(state.positions)


def test_traced_colliders_match_config_constants():
    """colliders_from_config(cfg) must reproduce the config-constant rigid
    world EXACTLY (same formulas, traced instead of folded)."""
    state, topo = _pinned_cloth()
    cfg = SolverConfig(substeps=2, iterations=6, damping=0.02,
                       solve_mode=SolveMode.JACOBI,
                       ground_height=0.0, friction=0.3,
                       sphere_colliders=((0.0, 0.72, 0.0, 0.3),),
                       box_colliders=((0.45, 0.8, 0.0, 0.15, 0.15, 0.15),))
    step = G.make_step(topo, cfg, DT)
    p_const = _run(state, step, 50)

    state_k = state.replace(colliders=colliders_from_config(cfg))
    p_traced = _run(state_k, step, 50)
    np.testing.assert_array_equal(p_const, p_traced)


def test_state_colliders_override_config():
    """A present ColliderSet REPLACES the config's rigid world entirely."""
    state, topo = _pinned_cloth()
    base = dict(substeps=2, iterations=6, damping=0.02,
                solve_mode=SolveMode.JACOBI,
                ground_height=0.0, friction=0.3)
    cfg_with = SolverConfig(sphere_colliders=((0.0, 0.72, 0.0, 0.3),),
                            **base)
    cfg_without = SolverConfig(**base)

    # same sphere count, parked far away -> behaves like no sphere at all
    parked = state.replace(colliders=make_colliders(
        spheres=[(50.0, 50.0, 50.0, 0.3)], ground_height=0.0))
    p_parked = _run(parked, G.make_step(topo, cfg_with, DT), 50)
    p_none = _run(state, G.make_step(topo, cfg_without, DT), 50)
    np.testing.assert_allclose(p_parked, p_none, atol=1e-6)


def test_animated_sphere_sweeps_without_recompile():
    """A sphere rising through a pinned cloth bulges it upward; the SAME
    compiled program serves every pose (the capability PhysX gave the
    reference for free)."""
    state, topo = _pinned_cloth(res=9)
    cfg = SolverConfig(substeps=2, iterations=6, damping=0.05,
                       solve_mode=SolveMode.JACOBI,
                       ground_height=-2.0, friction=0.3)
    step = G.make_step(topo, cfg, DT)
    state = state.replace(colliders=make_colliders(
        spheres=[(0.0, 0.2, 0.0, 0.35)], ground_height=-2.0))

    n = 60
    ys = np.linspace(0.2, 1.35, n, dtype=np.float32)
    for i in range(n):
        vel = ((ys[min(i + 1, n - 1)] - ys[i]) / DT)
        state = state.replace(colliders=state.colliders.with_sphere(
            0, center=(0.0, ys[i], 0.0), velocity=(0.0, vel, 0.0)))
        state = step(state)
    p = np.asarray(state.positions)
    assert np.isfinite(p).all()
    # center of the cloth pushed well above the pinned plane
    assert p[:, 1].max() > 1.45, p[:, 1].max()
    # and no particle is inside the final sphere pose
    d = np.linalg.norm(p - np.array([0.0, ys[-1], 0.0]), axis=1)
    assert d.min() > 0.35 - 5e-3, d.min()
    if hasattr(step, "_cache_size"):
        assert step._cache_size() == 1, "pose animation must not recompile"


def test_kinematic_rollout_matches_host_loop():
    state, topo = _pinned_cloth(res=7)
    cfg = SolverConfig(substeps=2, iterations=5, damping=0.05,
                       solve_mode=SolveMode.JACOBI,
                       ground_height=-2.0, friction=0.3)
    step = G.make_step(topo, cfg, DT)
    n = 30
    ys = np.linspace(0.2, 1.2, n, dtype=np.float32)
    traj = np.zeros((n, 1, 4), np.float32)
    traj[:, 0, 1] = ys
    traj[:, 0, 3] = 0.35
    state = state.replace(colliders=make_colliders(
        spheres=[(0.0, 0.2, 0.0, 0.35)], ground_height=-2.0))

    out = animator.kinematic_rollout(
        state, step, n_steps=n, dt=DT, sphere_traj=jnp.asarray(traj))

    vel = np.zeros((n, 1, 3), np.float32)
    vel[:-1, 0, :] = (traj[1:, 0, :3] - traj[:-1, 0, :3]) / DT
    s = state
    for i in range(n):
        s = s.replace(colliders=s.colliders.replace(
            spheres=jnp.asarray(traj[i]),
            sphere_velocities=jnp.asarray(vel[i])))
        s = step(s)
    np.testing.assert_allclose(np.asarray(out.positions),
                               np.asarray(s.positions), atol=1e-6)


def test_animated_ground_matches_oracle():
    """Animated floor: the engine traces ground_height from the ColliderSet;
    the frozen oracle — NumPy, unjitted — simply re-folds the constant per
    frame via cfg.replace.  COLORED mode must track it exactly."""
    pos = mesh.cube_corners(1.0) + np.array([0, 1.0, 0], np.float32)
    edges = lattice.cube8_edges()
    topo = build.build_topology(pos, edges, compliance=0.01)
    cfg = SolverConfig(substeps=1, iterations=10, damping=0.01,
                       solve_mode=SolveMode.COLORED, ground_height=0.0,
                       friction=0.3)
    state = state_from_topology(topo, pos)
    state = state.replace(colliders=make_colliders(ground_height=0.0))
    step = G.make_step(topo, cfg, DT)

    oracle = reference_cpu.ReferenceSolver(
        pos, np.asarray(topo.edges), np.asarray(topo.rest_lengths),
        np.asarray(topo.compliance), np.ones(len(pos), np.float32), cfg,
        colors=np.asarray(topo.colors))

    n = 50
    heights = np.concatenate([np.linspace(0.0, 0.6, 25),
                              np.full(25, 0.6)]).astype(np.float32)
    for i in range(n):
        state = state.replace(
            colliders=state.colliders.with_ground(heights[i]))
        state = step(state)
        oracle.cfg = cfg.replace(ground_height=float(heights[i]))
        oracle.step(DT)
    drift = np.abs(np.asarray(state.positions) - oracle.x).max()
    assert drift < 5e-5, drift
    # the rising floor actually lifted the body
    assert np.asarray(state.positions)[:, 1].min() > 0.55


def test_velocity_reflect_floor_animates():
    pos = mesh.cube_corners(0.5) + np.array([0, 1.0, 0], np.float32)
    edges = lattice.cube8_edges()
    topo = build.build_topology(pos, edges, compliance=0.01)
    cfg = SolverConfig(substeps=2, iterations=6, damping=0.02,
                       floor_mode=FloorMode.VELOCITY_REFLECT,
                       ground_height=0.0)
    state = state_from_topology(topo, pos)
    state = state.replace(colliders=make_colliders(ground_height=0.0))
    step = G.make_step(topo, cfg, DT)
    for i in range(80):
        h = min(0.4, i * 0.01)
        state = state.replace(colliders=state.colliders.with_ground(h))
        state = step(state)
    p = np.asarray(state.positions)
    assert np.isfinite(p).all()
    assert p[:, 1].min() > 0.38, p[:, 1].min()


def test_gradient_through_collider_trajectory():
    """Differentiable contact-rich control: d(loss)/d(sphere trajectory)
    must be finite and nonzero through a kinematic_rollout."""
    state, topo = _pinned_cloth(res=6)
    cfg = SolverConfig(substeps=1, iterations=4, damping=0.05,
                       solve_mode=SolveMode.JACOBI,
                       ground_height=-2.0, friction=0.3)
    step = G.make_step(topo, cfg, DT)
    n = 12
    ys = jnp.linspace(0.3, 1.05, n)
    traj0 = jnp.zeros((n, 1, 4), jnp.float32)
    traj0 = traj0.at[:, 0, 1].set(ys).at[:, 0, 3].set(0.3)
    state = state.replace(colliders=make_colliders(
        spheres=[(0.0, 0.3, 0.0, 0.3)], ground_height=-2.0))

    def loss(traj):
        out = animator.kinematic_rollout(
            state, step, n_steps=n, dt=DT, sphere_traj=traj)
        return out.positions[:, 1].mean()

    g = jax.grad(loss)(traj0)
    g = np.asarray(g)
    assert np.isfinite(g).all()
    # pushing the sphere higher raises the cloth: gradient w.r.t. the
    # sphere heights must be nonzero somewhere along the trajectory
    assert np.abs(g[:, 0, 1]).max() > 1e-6


def test_stencil_engine_kinematic_matches_general():
    """The stencil lattice engine honors the same ColliderSet contract:
    with family-parity colors (COLORED), an animated sphere sweep must
    track the general engine to fp noise — the cross-engine semantics
    test CLAUDE.md requires for every new knob."""
    from softbodysimulation_tpu.solvers import lattice as lat_engine
    from softbodysimulation_tpu.topology import lattice as lat_topo

    res = 3
    spec = lat_topo.lattice_spec(res)
    state_s = lat_engine.make_lattice_state(spec, center=(0, 1.5, 0))
    pos = lat_topo.lattice_points(res, center=(0, 1.5, 0))
    edges, comp = lat_topo.lattice_edges(res)
    colors = lat_topo.lattice_family_colors(res)
    topo = build.build_topology(pos, edges, comp, colors=colors)
    state_g = state_from_topology(topo, pos)

    cfg = SolverConfig(substeps=2, iterations=6, damping=0.05,
                       solve_mode=SolveMode.COLORED, ground_height=-2.0,
                       friction=0.3)
    coll = make_colliders(spheres=[(0.0, 0.2, 0.0, 0.4)],
                          ground_height=-2.0)
    state_s = state_s.replace(colliders=coll)
    state_g = state_g.replace(colliders=coll)
    step_s = lat_engine.make_step(spec, cfg, DT)
    step_g = G.make_step(topo, cfg, DT)

    n = 30
    ys = np.linspace(0.2, 1.3, n, dtype=np.float32)
    for i in range(n):
        vel = (0.0, float((ys[min(i + 1, n - 1)] - ys[i]) / DT), 0.0)
        cs = state_s.colliders.with_sphere(0, center=(0.0, ys[i], 0.0),
                                           velocity=vel)
        state_s = step_s(state_s.replace(colliders=cs))
        state_g = step_g(state_g.replace(colliders=cs))
    ps = np.asarray(state_s.positions)
    pg = np.asarray(state_g.positions)
    assert np.isfinite(ps).all()
    drift = np.abs(ps - pg).max()
    assert drift < 1e-5, drift
    # the sweep moved the body: it is no longer at rest height 1.5-ish
    assert ps[:, 1].max() > 1.8


def test_sphere_sweep_scene_pushes_slab():
    """The catalogued animated-collider scene: the scripted sphere plows
    through the slab and shoves it along +x."""
    from softbodysimulation_tpu.core.scenes import sphere_sweep

    state, step, info = sphere_sweep()
    x0 = np.asarray(state.positions)[:, 0].mean()
    anim = info["animate"]
    for i in range(60):
        state = anim(i, state)
        state = step(state)
    p = np.asarray(state.positions)
    assert np.isfinite(p).all()
    assert p[:, 0].mean() > x0 + 0.05, (x0, p[:, 0].mean())


