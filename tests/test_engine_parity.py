"""Engine-against-reference matrices for the XLA engines.

(a) general engine (COLORED) vs the frozen NumPy oracle over pins, ext
    forces, clamps, gravity conventions, lambda modes and bending;
(b) stencil engine vs general engine on ``lattice_family_colors`` over
    lambda/floor modes, clamps, static and kinematic colliders and the
    ext-force lifecycle;
(c) the general engine's ``gather`` vs ``windowed`` backends, and vmapped
    ensemble rows vs single bodies.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from softbodysimulation_tpu import (DampingMode, FloorMode, LambdaMode,
                                    SolveMode, SolverConfig, make_colliders,
                                    state_from_topology)
from softbodysimulation_tpu.parallel import batch as pbatch
from softbodysimulation_tpu.solvers import general
from softbodysimulation_tpu.solvers import lattice as lat_engine
from softbodysimulation_tpu.solvers import reference_cpu
from softbodysimulation_tpu.topology import build, lattice, mesh

# ------------------------------------------------- (a) general vs oracle
ORACLE_DT = 0.02
ORACLE_CASES = {
    "plain": ({}, {}),
    "pins_poke": ({}, {"pins": [0, 1], "poke": True}),
    "clamps": (dict(max_dlambda=1e-3, max_dlambda_rel=0.1,
                    lambda_clamp=100.0, min_alpha_tilde=1e-10), {}),
    "force_gravity": (dict(gravity_is_acceleration=False),
                      {"mass": 2.0, "poke": True}),
    "accel_gravity": (dict(gravity_is_acceleration=True), {"mass": 2.0}),
    "decay": (dict(lambda_mode=LambdaMode.DECAY, lambda_decay=0.98), {}),
    "warm_start": (dict(lambda_mode=LambdaMode.WARM_START, lambda_decay=1.0),
                   {"warm": True}),
    "per_dt_max_velocity": (dict(damping_mode=DampingMode.PER_DT,
                                 max_velocity=2.0), {}),
    "compliant_floor": (dict(collision_compliance=1e-6, friction=0.8), {}),
}


def _oracle_scene(kind):
    if kind == "cube8":
        pos = mesh.cube_corners(1.0) + np.array([0, 1.2, 0], np.float32)
        return pos, build.build_topology(pos, lattice.cube8_edges(),
                                         compliance=0.01)
    if kind == "lattice3":
        pos = lattice.lattice_points(3, center=(0, 1.2, 0))
        edges, comp = lattice.lattice_edges(3)
        return pos, build.build_topology(pos, edges, comp)
    raise KeyError(kind)


def _oracle(pos, topo, cfg, inv_mass, warm):
    bend = cfg.enable_bending
    return reference_cpu.ReferenceSolver(
        pos, np.asarray(topo.edges), np.asarray(topo.rest_lengths),
        np.asarray(topo.compliance), inv_mass, cfg,
        hinges=np.asarray(topo.hinges) if bend else None,
        rest_angles=np.asarray(topo.rest_angles) if bend else None,
        bend_compliance=np.asarray(topo.bend_compliance) if bend else None,
        colors=np.asarray(topo.colors),
        bend_colors=np.asarray(topo.bend_colors) if bend else None,
        warm_start=warm)


def _run_against_oracle(kind, cfg, opt, steps=60):
    pos, topo = _oracle_scene(kind)
    st = state_from_topology(topo, pos, mass=opt.get("mass", 1.0))
    w = np.asarray(st.inv_mass).copy()
    pins = np.asarray(opt.get("pins", []), np.int64)
    if pins.size:
        w[pins] = 0.0
        st = st.replace(inv_mass=jnp.asarray(w))
    orc = _oracle(pos, topo, cfg, w, opt.get("warm", False))
    step = general.make_step(topo, cfg, ORACLE_DT)
    worst = 0.0
    for i in range(steps):
        if opt.get("poke") and i in (0, 10):
            f = np.zeros_like(pos)
            f[:3] = (3.0, 5.0, -2.0)
            st = st.replace(ext_force=st.ext_force + f)
            orc.f += f
        st = step(st)
        orc.step(ORACLE_DT)
        worst = max(worst, float(np.abs(np.asarray(st.positions)
                                        - orc.x).max()))
    assert np.abs(np.asarray(st.ext_force)).max() == 0.0
    if pins.size:
        np.testing.assert_array_equal(np.asarray(st.positions)[pins],
                                      pos[pins])
    return worst


@pytest.mark.parametrize("kind", ["cube8", "lattice3"])
@pytest.mark.parametrize("case", list(ORACLE_CASES))
def test_general_colored_matches_oracle(kind, case):
    kw, opt = ORACLE_CASES[case]
    cfg = SolverConfig(**{**dict(substeps=2, iterations=6, damping=0.02,
                                 solve_mode=SolveMode.COLORED,
                                 ground_height=0.0, friction=0.3), **kw})
    worst = _run_against_oracle(kind, cfg, opt)
    # measured <= 1.6e-5 over the matrix (f32 reordering of the per-
    # particle accumulation); the device budget is 1e-3
    assert worst < 1e-4, f"{kind}/{case}: engine-vs-oracle drift {worst}"


@pytest.mark.parametrize("pins", [False, True])
def test_general_colored_bending_matches_oracle(pins):
    """A folded butterfly unfolding under DECAY bending (the hinge does
    real work: |lambda_bend| ~ 0.07) tracks the oracle's sequential
    bending sweep (measured <= 7e-6)."""
    from softbodysimulation_tpu.core.fixtures import FIXTURES

    pos, topo, cfg = FIXTURES["butterfly"](folded=True)
    cfg = cfg.replace(solve_mode=SolveMode.COLORED,
                      lambda_mode=LambdaMode.DECAY)
    st = state_from_topology(topo, pos)
    w = np.asarray(st.inv_mass).copy()
    if pins:
        w[0] = 0.0
        st = st.replace(inv_mass=jnp.asarray(w))
    orc = _oracle(pos, topo, cfg, w, False)
    step = general.make_step(topo, cfg, ORACLE_DT)
    worst = 0.0
    for _ in range(60):
        st = step(st)
        orc.step(ORACLE_DT)
        worst = max(worst, float(np.abs(np.asarray(st.positions)
                                        - orc.x).max()))
    assert np.abs(np.asarray(st.lambda_bend)).max() > 1e-2
    assert worst < 1e-4, f"bending engine-vs-oracle drift {worst}"


# ------------------------------------------- (b) stencil vs general
STENCIL_DT = 1 / 60
STENCIL_CASES = {
    "reset": {},
    "decay": dict(lambda_mode=LambdaMode.DECAY, lambda_decay=0.98),
    "velocity_reflect": dict(floor_mode=FloorMode.VELOCITY_REFLECT),
    "no_floor": dict(floor_mode=FloorMode.NONE),
    "clamps": dict(max_dlambda_rel=0.1, lambda_clamp=100.0,
                   min_alpha_tilde=1e-10, max_velocity=5.0),
    "sphere_collider": dict(sphere_colliders=((0.0, 0.3, 0.0, 0.35),)),
    "box_collider": dict(box_colliders=((0.3, 0.2, 0.0, 0.2, 0.2, 0.2),)),
    "per_dt_accel": dict(damping_mode=DampingMode.PER_DT,
                         gravity_is_acceleration=True),
}


def _stencil_and_general(res, braced, center):
    spec = lattice.lattice_spec(res, braced=braced)
    st_s = lat_engine.make_lattice_state(spec, center=center)
    pos = lattice.lattice_points(res, center=center)
    edges, comp = lattice.lattice_edges(res, braced=braced)
    topo = build.build_topology(
        pos, edges, comp,
        colors=lattice.lattice_family_colors(res, braced=braced))
    return spec, st_s, topo, state_from_topology(topo, pos)


@pytest.mark.parametrize("extra", ["none", "ext_force", "kinematic"])
@pytest.mark.parametrize("case", list(STENCIL_CASES))
@pytest.mark.parametrize("braced", [False, True])
def test_stencil_matches_general_on_family_colors(braced, case, extra):
    """Family-parity coloring makes the general COLORED engine replay the
    stencil's constraint order, so the two agree to f32 noise (measured
    <= 9e-6 over this matrix at 30 frames)."""
    cfg = SolverConfig(**{**dict(substeps=2, iterations=3, damping=0.02,
                                 solve_mode=SolveMode.COLORED,
                                 ground_height=0.0, friction=0.3),
                          **STENCIL_CASES[case]})
    spec, ss, topo, sg = _stencil_and_general(3, braced, (0, 0.7, 0))
    coll = make_colliders(spheres=[(-0.6, 0.5, 0.0, 0.3)],
                          ground_height=0.0)
    if extra == "kinematic":
        ss, sg = ss.replace(colliders=coll), sg.replace(colliders=coll)
    step_s = lat_engine.make_step(spec, cfg, STENCIL_DT)
    step_g = general.make_step(topo, cfg, STENCIL_DT)
    worst = 0.0
    for i in range(30):
        if extra == "ext_force" and i in (0, 5):
            f = np.zeros((spec.n_particles, 3), np.float32)
            f[:4] = (2.0, 3.0, -1.0)
            ss = ss.replace(ext_force=ss.ext_force + f)
            sg = sg.replace(ext_force=sg.ext_force + f)
        if extra == "kinematic":
            c = coll.with_sphere(0, center=(-0.6 + 0.04 * i, 0.5, 0.0),
                                 velocity=(0.04 / STENCIL_DT, 0.0, 0.0))
            ss, sg = ss.replace(colliders=c), sg.replace(colliders=c)
        ss, sg = step_s(ss), step_g(sg)
        worst = max(worst, float(np.abs(np.asarray(ss.positions)
                                        - np.asarray(sg.positions)).max()))
        assert np.abs(np.asarray(ss.ext_force)).max() == 0.0
    assert np.isfinite(np.asarray(ss.positions)).all()
    assert worst < 5e-5, f"stencil vs general drift {worst}"


# ---------------------------------------- (c) gather vs windowed backends
MESH_DT = 1 / 60
BACKEND_CASES = {
    "reset_cheby": dict(lambda_mode=LambdaMode.RESET, jacobi_rho=0.9),
    "reset_plain": dict(lambda_mode=LambdaMode.RESET, jacobi_rho=0.0),
    "decay_reflect": dict(lambda_mode=LambdaMode.DECAY, lambda_decay=0.98,
                          floor_mode=FloorMode.VELOCITY_REFLECT),
    "warm_start": dict(lambda_mode=LambdaMode.WARM_START, jacobi_rho=0.0),
    "sdf_clamps": dict(ground_height=-0.2, friction=0.2,
                       sphere_colliders=((0.0, 0.35, 0.0, 0.3),),
                       box_colliders=((0.5, 0.4, 0.0, 0.2, 0.2, 0.2),),
                       max_dlambda_rel=0.1, lambda_clamp=100.0,
                       max_velocity=20.0, world_bounds=1000.0),
    "force_gravity": dict(gravity_is_acceleration=False, max_force=100.0),
    "bending_reset": dict(enable_bending=True, jacobi_rho=0.0),
    "bending_decay": dict(enable_bending=True, jacobi_rho=0.9,
                          lambda_mode=LambdaMode.DECAY),
    "volume": dict(enable_volume=True, pressure=1.1),
}


def _sphere(bending=False):
    m = mesh.icosphere(2)
    pos, topo = build.topology_from_mesh(
        m, compliance=1e-3, bending=bending, bend_compliance=1e-3,
        windowed=True)
    return pos + np.array([0, 1.2, 0], np.float32), topo


@pytest.mark.parametrize("pins_poke", [False, True])
@pytest.mark.parametrize("case", list(BACKEND_CASES))
def test_gather_matches_windowed(case, pins_poke):
    kw = BACKEND_CASES[case]
    bending = kw.get("enable_bending", False)
    pos, topo = _sphere(bending)
    cfg_w = SolverConfig(**{**dict(
        substeps=2, iterations=3, damping=0.02, solve_mode=SolveMode.JACOBI,
        distance_backend="windowed",
        bending_backend="windowed" if bending else "auto",
        ground_height=0.0, friction=0.3), **kw})
    cfg_g = dataclasses.replace(cfg_w, distance_backend="gather",
                                bending_backend="gather")
    st = state_from_topology(topo, pos)
    if pins_poke:
        st = st.replace(inv_mass=st.inv_mass.at[np.array([0, 5])].set(0.0))
        f = np.zeros_like(pos)
        f[:10] = (4.0, 8.0, 2.0)
        st = st.replace(ext_force=jnp.asarray(f))
    ow = general.make_step(topo, cfg_w, MESH_DT, n_steps=8)(st)
    og = general.make_step(topo, cfg_g, MESH_DT, n_steps=8)(st)
    dpos = np.abs(np.asarray(ow.positions) - np.asarray(og.positions)).max()
    dlam = np.abs(np.asarray(ow.lambda_dist)
                  - np.asarray(og.lambda_dist)).max()
    assert np.isfinite(np.asarray(ow.positions)).all()
    assert dpos < 1e-4, f"gather vs windowed position drift {dpos}"
    assert dlam < 1e-5, f"gather vs windowed lambda drift {dlam}"
    if pins_poke:
        np.testing.assert_array_equal(np.asarray(ow.positions)[[0, 5]],
                                      pos[[0, 5]])
        assert np.abs(np.asarray(ow.ext_force)).max() == 0.0


@pytest.mark.parametrize("per_body_mass", [False, True])
@pytest.mark.parametrize("backend", ["gather", "windowed"])
def test_general_ensemble_rows_match_single_bodies(backend, per_body_mass):
    pos, topo = _sphere()
    cfg = SolverConfig(substeps=2, iterations=3, damping=0.02,
                       solve_mode=SolveMode.JACOBI, distance_backend=backend,
                       ground_height=0.0, friction=0.3)
    rng = np.random.default_rng(2)
    states = []
    for b in range(3):
        st = state_from_topology(
            topo, pos + rng.uniform(-0.5, 0.5, 3).astype(np.float32),
            mass=(1.0 + 0.5 * b) if per_body_mass else 1.0)
        f = np.zeros_like(pos)
        f[b:b + 5] = (1.0, 2.0, 0.0)
        states.append(st.replace(ext_force=jnp.asarray(f)))
    batched = pbatch.stack_states(states)
    out = pbatch.make_batched_general_step(topo, cfg, MESH_DT, 6)(batched)
    single = general.make_step(topo, cfg, MESH_DT, n_steps=6)
    for b, st in enumerate(states):
        want = np.asarray(single(st).positions)
        got = np.asarray(out.positions[b])
        assert np.abs(got - want).max() < 1e-5, f"body {b}"


@pytest.mark.parametrize("cfg_kw", [
    dict(solve_mode=SolveMode.JACOBI, lambda_mode=LambdaMode.RESET),
    dict(solve_mode=SolveMode.JACOBI, lambda_mode=LambdaMode.WARM_START,
         lambda_decay=1.0),
    dict(solve_mode=SolveMode.COLORED, lambda_mode=LambdaMode.DECAY),
], ids=["jacobi_reset", "jacobi_warm", "colored_decay"])
def test_lane_folded_lattice_rows_match_single_bodies(cfg_kw):
    spec = lattice.lattice_spec(4, braced=True)
    cfg = SolverConfig(substeps=2, iterations=2, damping=0.02,
                       ground_height=0.0, friction=0.3, **cfg_kw)
    states = [lat_engine.make_lattice_state(
        spec, center=(0.3 * b, 0.8 + 0.2 * b, 0.0)) for b in range(3)]
    f = np.zeros((spec.n_particles, 3), np.float32)
    f[:6] = (0.5, 1.0, 0.0)
    states[1] = states[1].replace(ext_force=jnp.asarray(f))
    out = lat_engine.make_batched_step(spec, cfg, 1 / 60, 3, n_steps=5)(
        pbatch.stack_states(states))
    single = lat_engine.make_step(spec, cfg, 1 / 60, n_steps=5)
    for b, st in enumerate(states):
        d = np.abs(np.asarray(out.positions[b])
                   - np.asarray(single(st).positions)).max()
        assert d < 1e-5, f"body {b}: {d}"
    assert np.abs(np.asarray(out.ext_force)).max() == 0.0


def test_colored_windowed_topology_matches_frozen_oracle():
    """The color-major windowed edge order keeps the COLORED sweep equal
    to the oracle's color-major sequential Gauss-Seidel."""
    pos, topo = build.topology_from_mesh(mesh.icosphere(1), compliance=1e-4,
                                         windowed="colored")
    pos = pos + np.array([0, 2.0, 0], np.float32)
    cfg = SolverConfig(substeps=1, iterations=4, damping=0.02,
                       solve_mode=SolveMode.COLORED, ground_height=0.0)
    st = state_from_topology(topo, pos)
    orc = _oracle(pos, topo, cfg, np.asarray(st.inv_mass), False)
    step = general.make_step(topo, cfg, ORACLE_DT)
    for _ in range(20):
        st = step(st)
        orc.step(ORACLE_DT)
    drift = np.abs(np.asarray(st.positions) - orc.x).max()
    assert drift < 5e-5, f"colored windowed vs oracle drift {drift}"
