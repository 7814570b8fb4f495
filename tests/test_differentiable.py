"""Differentiability — a JAX-native capability the reference cannot
offer: gradients flow through the whole compiled physics step, enabling
system identification and control optimisation."""

import numpy as np

import jax
import jax.numpy as jnp

from softbodysimulation_tpu import (
    FloorMode,
    SolveMode,
    SolverConfig,
    state_from_topology,
)
from softbodysimulation_tpu.core import fixtures
from softbodysimulation_tpu.solvers import general

DT = 0.02


def test_grad_through_rollout_wrt_initial_velocity():
    pos, topo, cfg = fixtures.three_particles_triangle(compliance=1e-3)
    cfg = cfg.replace(iterations=5)
    state0 = state_from_topology(topo, pos)

    def loss(v0):
        s = state0.replace(velocities=v0)
        s = general.multi_step_fn(s, topo, cfg, DT, 10)
        target = jnp.asarray([1.0, 0.5, 0.0])
        com = s.positions.mean(axis=0)
        return jnp.sum((com - target) ** 2)

    vg = jax.jit(jax.value_and_grad(loss))
    _, g = vg(jnp.zeros((3, 3)))
    g = np.asarray(g)
    assert np.isfinite(g).all()
    assert np.abs(g).max() > 0  # gradient actually flows
    # gradient descent on launch velocity reduces the loss (quadratic-ish
    # landscape with small curvature ~ (n_steps*dt)^2/n_particles)
    v = jnp.zeros((3, 3))
    l0, _ = vg(v)
    for _ in range(50):
        _, g = vg(v)
        v = v - 30.0 * g
    l1, _ = vg(v)
    assert float(l1) < 0.1 * float(l0)


def test_grad_wrt_compliance_material_identification():
    """d(final length)/d(compliance) — material parameter sensitivity."""
    pos, topo, cfg = fixtures.two_particles(stretched=True)
    # heavy damping + long horizon: measure at (near) equilibrium, where the
    # sensitivity sign is unambiguous (mid-transient it can flip)
    cfg = cfg.replace(gravity=(0.0, -9.81, 0.0), iterations=10, damping=0.3)
    state0 = state_from_topology(topo, pos,
                                 inv_mass=np.array([0.0, 1.0], np.float32))

    def final_length(compliance):
        t = topo.replace(compliance=jnp.full_like(topo.compliance,
                                                  compliance))
        s = general.multi_step_fn(state0, t, cfg, DT, 100)
        return jnp.linalg.norm(s.positions[1] - s.positions[0])

    g = float(jax.grad(final_length)(jnp.float32(0.01)))
    assert np.isfinite(g)
    # softer spring stretches more under gravity => positive sensitivity
    assert g > 0


def test_grad_finite_with_floor_contact():
    pos, topo, cfg = fixtures.three_particles_triangle(compliance=1e-3)
    cfg = cfg.replace(gravity=(0.0, -9.81, 0.0), iterations=5,
                      floor_mode=FloorMode.XPBD_INEQUALITY,
                      ground_height=-1.0, friction=0.2)
    state0 = state_from_topology(topo, pos)

    def loss(v0):
        s = state0.replace(velocities=v0)
        s = general.multi_step_fn(s, topo, cfg, DT, 30)
        return jnp.sum(s.positions ** 2)

    g = np.asarray(jax.grad(loss)(jnp.zeros((3, 3))))
    assert np.isfinite(g).all()


def test_grad_finite_through_self_collision_backends():
    """Gradients through every self-collision backend must be finite.

    Regression: the hash backend used jnp.linalg.norm, whose sqrt VJP is
    differentiated at the always-present self-pair distance of exactly 0 —
    every gradient through a self-colliding rollout came back NaN (the
    downstream where-masks cannot block the 0*inf cotangents)."""
    from softbodysimulation_tpu.ops import spatial_hash

    rng = np.random.default_rng(9)
    pred = jnp.asarray(rng.uniform(0, 0.4, (24, 3)), jnp.float32)
    w = jnp.ones(24)
    from softbodysimulation_tpu import SolverConfig
    for backend in ("hash", "sorted", "dense", "blocked"):
        cfg = SolverConfig(particle_radius=0.06, self_collision_omega=1.0,
                           collision_block_size=8, block_neighbors=4,
                           sorted_window=8)

        def loss(p, backend=backend, cfg=cfg):
            if backend == "sorted":
                order = spatial_hash.morton_order(p, cfg)
                out = spatial_hash.self_collision_project_sorted(
                    p, w, order, cfg)
            elif backend == "blocked":
                order = spatial_hash.morton_order(p, cfg)
                out = spatial_hash.self_collision_project_blocked(
                    p, w, order, cfg)
            elif backend == "dense":
                out = spatial_hash.self_collision_project_dense(p, w, cfg)
            else:
                out = spatial_hash.self_collision_project(p, w, cfg)
            return jnp.sum(out ** 2)

        g = np.asarray(jax.grad(loss)(pred))
        assert np.isfinite(g).all(), f"{backend}: NaN gradients"
