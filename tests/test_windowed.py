"""Windowed one-hot distance backend (topology/windows.py +
general._solve_distance_windowed): equivalence with the gather backend,
structure validity, fallback behavior, vmap compatibility."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from softbodysimulation_tpu import (
    LambdaMode,
    SolveMode,
    SolverConfig,
    state_from_topology,
)
from softbodysimulation_tpu.solvers import general
from softbodysimulation_tpu.topology import build, mesh, windows

DT = 1 / 60


def sphere_topos(**winkw):
    m = mesh.icosphere(2)
    pos_w, topo_w = build.topology_from_mesh(
        m, compliance=1e-4, windowed=True, **winkw)
    return pos_w, topo_w


def test_windowed_matches_gather_backend():
    """Same topology, same state: the matmul sweep must track the gather
    sweep to f32 reordering noise over hundreds of sweeps."""
    pos, topo = sphere_topos()
    import dataclasses

    cfg_w = SolverConfig(substeps=2, iterations=6, damping=0.01,
                         solve_mode=SolveMode.JACOBI, ground_height=-2.0)
    cfg_g = dataclasses.replace(cfg_w, distance_backend="gather")
    st = state_from_topology(topo, pos + np.array([0, 1.0, 0], np.float32))
    ow = general.make_step(topo, cfg_w, DT, n_steps=30)(st)
    og = general.make_step(topo, cfg_g, DT, n_steps=30)(st)
    assert np.abs(np.asarray(ow.positions) - np.asarray(og.positions)).max() \
        < 1e-4
    assert np.abs(np.asarray(ow.lambda_dist)
                  - np.asarray(og.lambda_dist)).max() < 1e-5


def test_windowed_bf16_matrices_close_to_f32():
    """bf16 one-hots are exact {0,1}; only the correction RHS is rounded,
    so trajectories stay close."""
    pos, topo32 = sphere_topos(window_dtype="float32")
    _, topo16 = sphere_topos(window_dtype="bf16")
    assert topo16.windows.AB.dtype == jnp.bfloat16
    cfg = SolverConfig(substeps=2, iterations=4, damping=0.01,
                       solve_mode=SolveMode.JACOBI, ground_height=-2.0)
    st = state_from_topology(topo32, pos + np.array([0, 1.0, 0], np.float32))
    o32 = general.make_step(topo32, cfg, DT, n_steps=20)(st)
    o16 = general.make_step(topo16, cfg, DT, n_steps=20)(st)
    assert np.abs(np.asarray(o32.positions)
                  - np.asarray(o16.positions)).max() < 5e-3


def test_windowed_settles_on_floor():
    pos, topo = sphere_topos()
    cfg = SolverConfig(substeps=4, iterations=8, damping=0.02,
                       solve_mode=SolveMode.JACOBI, ground_height=0.0,
                       friction=0.3)
    st = state_from_topology(topo, pos + np.array([0, 1.5, 0], np.float32))
    out = general.make_step(topo, cfg, DT, n_steps=300)(st)
    y = np.asarray(out.positions)[:, 1]
    assert np.isfinite(np.asarray(out.positions)).all()
    assert y.min() > -1e-3


def test_window_structure_validity():
    pos, topo = sphere_topos(block_edges=128, seg_align=32)
    w = topo.windows
    e = np.asarray(topo.edges)
    n = topo.n_particles
    assert w.valid.sum() == len(e)
    # every edge's endpoints fall inside its block's window
    K, S = w.n_blocks, w.block_edges
    # reconstruct gather one-hots -> endpoint indices, compare to edges
    AB = np.asarray(w.AB, np.float32)
    seg_map = np.argmax(np.asarray(w.win_onehot), axis=1)  # piece -> segment
    for k in range(K):
        base = seg_map[k * (w.window // w.seg)] * w.seg
        rows = AB[k]
        for s in range(S):
            if k * S + s >= len(e):
                break
            a = rows[s].argmax() + base
            b = rows[s + S].argmax() + base
            assert (a, b) == (e[k * S + s][0], e[k * S + s][1])


def test_windowed_rejects_huge_bandwidth():
    rng = np.random.default_rng(0)
    n = 4000
    e = rng.integers(0, n, (6000, 2)).astype(np.int32)
    e = e[e[:, 0] != e[:, 1]]
    deg = np.bincount(e.reshape(-1), minlength=n).astype(np.float32)
    # random graph: RCM can't band it; builder must refuse, not mis-build
    order = windows.rcm_order(e, n)
    rank = np.empty(n, np.int64)
    rank[order] = np.arange(n)
    e2 = rank[e.astype(np.int64)].astype(np.int32)
    e2 = e2[windows.sort_edges_by_window(e2)]
    with pytest.raises(ValueError, match="max_window"):
        windows.build_windows(e2, n, deg, max_window=512)


def test_forced_windowed_without_windows_raises():
    m = mesh.icosphere(1)
    pos, topo = build.topology_from_mesh(m, compliance=1e-4)
    cfg = SolverConfig(substeps=1, iterations=2,
                       solve_mode=SolveMode.JACOBI,
                       distance_backend="windowed")
    st = state_from_topology(topo, pos)
    with pytest.raises(ValueError, match="windowed"):
        general.make_step(topo, cfg, DT)(st)


def test_windowed_vmaps_over_bodies():
    pos, topo = sphere_topos()
    cfg = SolverConfig(substeps=2, iterations=3, damping=0.01,
                       solve_mode=SolveMode.JACOBI, ground_height=-2.0)
    sts = [state_from_topology(
        topo, pos + np.array([0, 1.0 + 0.2 * i, 0], np.float32))
        for i in range(3)]
    batched = jax.tree.map(lambda *xs: jnp.stack(xs), *sts)
    step = jax.jit(jax.vmap(
        lambda s: general.multi_step_fn(s, topo, cfg, DT, 5)))
    out = step(batched)
    single = general.make_step(topo, cfg, DT, n_steps=5)(sts[1])
    d = np.abs(np.asarray(out.positions[1])
               - np.asarray(single.positions)).max()
    assert d < 1e-5
    assert np.isfinite(np.asarray(out.positions)).all()


def test_windowed_backend_is_differentiable():
    """jax.grad flows through the one-hot matmul sweep (the differentiable
    -rollout capability extends to the windowed backend)."""
    pos, topo = sphere_topos()
    cfg = SolverConfig(substeps=1, iterations=3, damping=0.01,
                       solve_mode=SolveMode.JACOBI, ground_height=-5.0)

    def loss(dy):
        st = state_from_topology(
            topo, pos + jnp.asarray([0.0, 1.0, 0.0]) + dy)
        out = general.multi_step_fn(st, topo, cfg, DT, 3)
        return jnp.sum(out.positions[:, 1])

    g = jax.jit(jax.grad(loss))(jnp.zeros(3))
    g = np.asarray(g)
    assert np.isfinite(g).all()
    assert abs(g[1]) > 1e-3   # raising the start raises the outcome


# ----------------------------------------- windowed bending (round 3)
def test_windowed_bending_matches_gather_backend():
    """The signed-one-hot bending sweep must track the incidence-gather
    bending sweep (same bending_delta_lambda guards, same relaxation)."""
    import dataclasses

    m = mesh.icosphere(2)
    pos, topo = build.topology_from_mesh(
        m, compliance=1e-4, bending=True, bend_compliance=1e-3,
        windowed=True)
    assert topo.bend_windows is not None
    cfg_w = SolverConfig(substeps=2, iterations=5, damping=0.01,
                         solve_mode=SolveMode.JACOBI, enable_bending=True,
                         ground_height=-2.0)
    cfg_g = dataclasses.replace(cfg_w, bending_backend="gather")
    st = state_from_topology(topo, pos + np.array([0, 1.0, 0], np.float32))
    # squash the sphere so the hinges are materially bent
    st = st.replace(positions=st.positions * np.array([1.0, 0.6, 1.0],
                                                      np.float32))
    ow = general.make_step(topo, cfg_w, DT, n_steps=25)(st)
    og = general.make_step(topo, cfg_g, DT, n_steps=25)(st)
    assert np.abs(np.asarray(ow.positions)
                  - np.asarray(og.positions)).max() < 1e-4
    assert np.abs(np.asarray(ow.lambda_bend)
                  - np.asarray(og.lambda_bend)).max() < 1e-5
    # the sweep did real work
    assert np.abs(np.asarray(ow.lambda_bend)).max() > 0


def test_windowed_bending_respects_pins_and_stays_finite():
    m = mesh.icosphere(2)
    pos, topo = build.topology_from_mesh(
        m, compliance=1e-4, bending=True, windowed=True)
    cfg = SolverConfig(substeps=2, iterations=4, enable_bending=True,
                       solve_mode=SolveMode.JACOBI, ground_height=0.0)
    st = state_from_topology(topo, pos + np.array([0, 1.0, 0], np.float32))
    st = st.replace(inv_mass=st.inv_mass.at[np.array([3, 7])].set(0.0))
    p0 = np.asarray(st.positions)[[3, 7]].copy()
    out = general.make_step(topo, cfg, DT, n_steps=30)(st)
    p = np.asarray(out.positions)
    assert np.isfinite(p).all()
    assert np.abs(p[[3, 7]] - p0).max() < 1e-6
