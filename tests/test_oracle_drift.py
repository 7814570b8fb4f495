"""Cross-implementation oracle tests (SURVEY §4.3): device engines validated
against the frozen NumPy sequential Gauss-Seidel oracle — the same shape as
the reference's trusted-CPU-vs-GPU scheme (``SoftBodySimulator.cs:640-775``,
auto-fallback on NaN), but with numbers.

The headline accuracy metric (BASELINE.md): 10k-step position drift <= 1e-3.
The full 10k run lives in the slow marker / bench; here we verify tight drift
over shorter horizons on several scenes plus a medium-length settle-to-rest
run, which bounds the 10k number since both trajectories reach the same
fixed point.
"""

import numpy as np
import pytest

from softbodysimulation_tpu import (
    FloorMode,
    SolveMode,
    SolverConfig,
    state_from_topology,
)
from softbodysimulation_tpu.solvers import general, reference_cpu
from softbodysimulation_tpu.topology import build, lattice, mesh

DT = 0.02


def make_scene(kind: str):
    if kind == "cube8":
        pos = mesh.cube_corners(1.0) + np.array([0, 2.0, 0], np.float32)
        edges = lattice.cube8_edges()
        topo = build.build_topology(pos, edges, compliance=0.01)
        cfg = SolverConfig(substeps=1, iterations=10, damping=0.01,
                           solve_mode=SolveMode.COLORED, ground_height=0.0)
    elif kind == "lattice3":
        pos = lattice.lattice_points(3, center=(0, 1.5, 0))
        edges, comp = lattice.lattice_edges(3)
        topo = build.build_topology(pos, edges, comp)
        cfg = SolverConfig(substeps=2, iterations=8, damping=0.02,
                           solve_mode=SolveMode.COLORED, ground_height=0.0,
                           friction=0.3)
    elif kind == "bending_plane":
        m = mesh.grid_plane(1.0, 4)
        pos, topo = build.topology_from_mesh(
            m, compliance=1e-4, bending=True, bend_compliance=1e-3)
        pos = pos + np.array([0, 1.0, 0], np.float32)
        cfg = SolverConfig(substeps=1, iterations=6, damping=0.02,
                           solve_mode=SolveMode.COLORED, ground_height=0.0,
                           enable_bending=True)
    elif kind == "clamped":
        # exercises the reference's clamp knobs (max_dlambda from
        # CPUDistanceConstraint, per Scenes/CpuMesh.unity lambda clamp 1e-3)
        pos = mesh.cube_corners(1.0) + np.array([0, 1.0, 0], np.float32)
        edges = lattice.cube8_edges()
        topo = build.build_topology(pos, edges, compliance=1e-6)
        cfg = SolverConfig(substeps=1, iterations=15, damping=0.01,
                           solve_mode=SolveMode.COLORED, ground_height=0.0,
                           max_dlambda=1e-3)
    else:
        raise KeyError(kind)
    return pos, topo, cfg


def make_oracle(pos, topo, cfg, inv_mass):
    hinges = np.asarray(topo.hinges)
    return reference_cpu.ReferenceSolver(
        pos, np.asarray(topo.edges), np.asarray(topo.rest_lengths),
        np.asarray(topo.compliance), inv_mass, cfg,
        hinges=hinges if len(hinges) and cfg.enable_bending else None,
        rest_angles=np.asarray(topo.rest_angles),
        bend_compliance=np.asarray(topo.bend_compliance),
        colors=np.asarray(topo.colors),
        bend_colors=np.asarray(topo.bend_colors),
    )


@pytest.mark.parametrize(
    # lattice3 bounces chaotically at contact, which amplifies f32 rounding
    # differences before both settle to the same rest state — hence the wider
    # (still < 1e-3 headline) bound there.
    "kind,steps,tol",
    [("cube8", 150, 5e-5), ("lattice3", 300, 1e-3),
     ("bending_plane", 150, 5e-5), ("clamped", 150, 5e-5)])
def test_colored_engine_matches_oracle(kind, steps, tol):
    pos, topo, cfg = make_scene(kind)
    state = state_from_topology(topo, pos)
    oracle = make_oracle(pos, topo, cfg, np.asarray(state.inv_mass))
    step = general.make_step(topo, cfg, DT)
    for _ in range(steps):
        state = step(state)
        oracle.step(DT)
    drift = np.abs(np.asarray(state.positions) - oracle.x).max()
    assert drift < tol, f"drift {drift} on {kind}"


def test_colored_engine_drift_after_settling():
    """Settle-to-rest run: cube dropped on the floor; both implementations
    must land on the same rest state (this is what bounds the 10k metric)."""
    pos, topo, cfg = make_scene("cube8")
    state = state_from_topology(topo, pos)
    oracle = make_oracle(pos, topo, cfg, np.asarray(state.inv_mass))
    step = general.make_step(topo, cfg, DT, n_steps=10)
    for _ in range(100):  # 1000 steps
        state = step(state)
    for _ in range(1000):
        oracle.step(DT)
    drift = np.abs(np.asarray(state.positions) - oracle.x).max()
    assert drift < 1e-3, f"settled drift {drift}"
    # settled: velocities near zero in both
    assert np.abs(np.asarray(state.velocities)).max() < 1e-3
    assert np.abs(oracle.v).max() < 1e-3


def test_jacobi_reaches_same_rest_state():
    """Jacobi with under-relaxation must settle to the same constraint
    manifold as Gauss-Seidel (equilibria coincide even though trajectories
    differ) — the north star's GS->Jacobi conversion requirement."""
    pos, topo, cfg = make_scene("cube8")
    cfg_j = cfg.replace(solve_mode=SolveMode.JACOBI, iterations=20)
    state = state_from_topology(topo, pos)
    oracle = make_oracle(pos, topo, cfg, np.asarray(state.inv_mass))
    step = general.make_step(topo, cfg_j, DT, n_steps=10)
    for _ in range(100):
        state = step(state)
    for _ in range(1000):
        oracle.step(DT)
    p = np.asarray(state.positions)
    # same resting height and same edge lengths
    err_edge = np.abs(
        np.linalg.norm(p[np.asarray(topo.edges)[:, 1]]
                       - p[np.asarray(topo.edges)[:, 0]], axis=1)
        - np.asarray(topo.rest_lengths))
    oracle_err = np.abs(
        np.linalg.norm(oracle.x[np.asarray(topo.edges)[:, 1]]
                       - oracle.x[np.asarray(topo.edges)[:, 0]], axis=1)
        - np.asarray(topo.rest_lengths))
    assert err_edge.max() < max(2 * oracle_err.max(), 2e-3)
    assert abs(p[:, 1].min() - oracle.x[:, 1].min()) < 2e-3


def test_pinned_scene_matches_oracle():
    pos, topo, cfg = make_scene("lattice3")
    state = state_from_topology(topo, pos)
    inv = np.asarray(state.inv_mass).copy()
    inv[:3] = 0.0  # pin a few lattice corners
    state = state.replace(positions=state.positions,
                          inv_mass=state.inv_mass.at[:3].set(0.0))
    oracle = make_oracle(pos, topo, cfg, inv)
    step = general.make_step(topo, cfg, DT)
    for _ in range(100):
        state = step(state)
        oracle.step(DT)
    drift = np.abs(np.asarray(state.positions) - oracle.x).max()
    assert drift < 5e-5
    assert np.allclose(np.asarray(state.positions)[:3], pos[:3], atol=1e-6)


def test_acceleration_gravity_matches_oracle():
    """gravity_is_acceleration parity between the device engine and the
    oracle (mass-independent gravity, 2x particle mass)."""
    pos = mesh.cube_corners(1.0) + np.array([0, 1.5, 0], np.float32)
    edges = lattice.cube8_edges()
    topo = build.build_topology(pos, edges, compliance=0.01)
    cfg = SolverConfig(substeps=2, iterations=8, damping=0.02,
                       solve_mode=SolveMode.COLORED, ground_height=0.0,
                       gravity_is_acceleration=True)
    state = state_from_topology(topo, pos, mass=2.0)
    oracle = make_oracle(pos, topo, cfg, np.asarray(state.inv_mass))
    step = general.make_step(topo, cfg, DT)
    for _ in range(150):
        state = step(state)
        oracle.step(DT)
    drift = np.abs(np.asarray(state.positions) - oracle.x).max()
    assert drift < 1e-4, f"accel-gravity drift {drift}"


@pytest.mark.slow
def test_drift_10k_steps():
    """The full headline metric (BASELINE.md): 10k steps, drift <= 1e-3."""
    pos, topo, cfg = make_scene("cube8")
    state = state_from_topology(topo, pos)
    oracle = make_oracle(pos, topo, cfg, np.asarray(state.inv_mass))
    step = general.make_step(topo, cfg, DT, n_steps=100)
    for _ in range(100):
        state = step(state)
    for _ in range(10000):
        oracle.step(DT)
    drift = np.abs(np.asarray(state.positions) - oracle.x).max()
    assert drift <= 1e-3, f"10k-step drift {drift}"


@pytest.mark.slow
def test_drift_welded_bunny_bending_contact():
    """Long-horizon drift on REAL bunny geometry (welded to test scale)
    with bending + resting floor contact + pinned base — the quasi-static
    regime where trajectory drift measures ENGINE fidelity.  (A free-falling
    under-converged shell is chaotic: fp noise amplifies exponentially after
    first contact in both engines identically-configured — measured and
    documented in ROADMAP.md "Chaos caveat"; scripts/drift_bunny_10k.py
    runs the 10k-step full-scale version.)"""
    from softbodysimulation_tpu import LambdaMode
    from softbodysimulation_tpu.topology import edges as tedges
    from softbodysimulation_tpu.topology.objloader import load_obj
    from softbodysimulation_tpu.core.scenes import BUNNY_PATHS
    import os as _os

    path = next((p for p in BUNNY_PATHS if _os.path.exists(p)), None)
    if path is None:
        pytest.skip("bunny asset absent")
    m = load_obj(path)
    v2, t2, _ = tedges.weld(m.vertices, m.triangles, 0.018)
    t2 = t2[(t2[:, 0] != t2[:, 1]) & (t2[:, 1] != t2[:, 2])
            & (t2[:, 0] != t2[:, 2])]
    e2 = tedges.unique_edges(t2)
    h2 = tedges.hinges(t2)
    pos = (v2 * 5.0).astype(np.float32)
    pos[:, 1] -= pos[:, 1].min()
    topo = build.build_topology(pos, e2, 1e-6, hinges=h2,
                                bend_compliance=1e-3, triangles=t2)
    inv_mass = np.where(pos[:, 1] < 0.05, 0.0, 1.0).astype(np.float32)
    cfg = SolverConfig(substeps=1, iterations=15, damping=0.1,
                       solve_mode=SolveMode.COLORED,
                       lambda_mode=LambdaMode.RESET,
                       enable_bending=True, max_dlambda=1e-3,
                       gravity=(0, -1.0, 0), ground_height=0.0, friction=0.5)
    orc = make_oracle(pos, topo, cfg, inv_mass)
    st = state_from_topology(topo, pos, inv_mass=inv_mass)
    fn = general.make_step(topo, cfg, 0.02, n_steps=1)
    worst = 0.0
    for i in range(150):
        st = fn(st)
        orc.step(0.02)
        if (i + 1) % 25 == 0:
            d = float(np.abs(np.asarray(st.positions) - orc.x).max())
            worst = max(worst, d)
    assert np.isfinite(orc.x).all()
    assert worst < 1e-3, f"welded-bunny drift {worst}"


# ---- WARM_START oracle extension (opt-in; frozen modes untouched) ------

def _warm_cfg():
    from softbodysimulation_tpu import LambdaMode

    return SolverConfig(substeps=2, iterations=8, damping=0.02,
                        solve_mode=SolveMode.COLORED,
                        lambda_mode=LambdaMode.WARM_START,
                        lambda_decay=1.0,
                        ground_height=0.0, friction=0.3)


def test_warm_start_refused_by_default():
    """The FROZEN oracle must keep refusing WARM_START unless the instance
    explicitly opted in — silent DECAY semantics would poison drift runs."""
    pos, topo, _ = make_scene("cube8")
    cfg = _warm_cfg()
    state = state_from_topology(topo, pos)
    oracle = make_oracle(pos, topo, cfg, np.asarray(state.inv_mass))
    with pytest.raises(NotImplementedError, match="warm_start=True"):
        oracle.step(DT)


def test_colored_engine_matches_warm_start_oracle():
    """COLORED + WARM_START engine vs the opted-in scalar oracle: the
    pre-application is simultaneous in both (directions from the entry
    pred), so the only fp-order difference is the per-particle accumulation
    of staged corrections (incidence-slot vs edge order).  The lattice
    bounces chaotically at contact (amplifying that ulp noise to ~2e-3
    around step 150, same as the RESET lattice3 row) before both settle to
    the same rest state — measure at the settling horizon."""
    pos = lattice.lattice_points(3, center=(0, 1.5, 0))
    edges, comp = lattice.lattice_edges(3)
    topo = build.build_topology(pos, edges, comp)
    cfg = _warm_cfg()
    state = state_from_topology(topo, pos)
    oracle = reference_cpu.ReferenceSolver(
        pos, np.asarray(topo.edges), np.asarray(topo.rest_lengths),
        np.asarray(topo.compliance), np.asarray(state.inv_mass), cfg,
        colors=np.asarray(topo.colors), warm_start=True)
    step = general.make_step(topo, cfg, DT)
    for _ in range(300):
        state = step(state)
        oracle.step(DT)
    drift = np.abs(np.asarray(state.positions) - oracle.x).max()
    assert np.isfinite(oracle.x).all()
    # measured: ~4e-5 at step 300 (peaked ~2e-3 mid-bounce, contracting)
    assert drift < 1e-3, f"WARM_START engine-vs-oracle drift {drift}"
