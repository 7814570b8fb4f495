"""Example 11 — contact-rich control through a kinematic collider.

Optimises a RIGID collider's trajectory by gradient descent through the
compiled contact physics: a kinematic sphere must sweep through a soft
cube resting on the floor and shove it so its centre of mass lands on a
target.  The loss differentiates through the whole rollout — collider
SDF projection, friction against the moving collider's velocity frame,
floor contact, constraint projection — back to the sweep parameters.

This is the differentiable composition of two capabilities: the traced
rigid world (``core/colliders.ColliderSet`` — the counterpart of
the reference's moving PhysX colliders, ``SoftBodyController.cs:110-118``)
and ``interact.animator.kinematic_rollout``.  The reference can script a
collider but has no gradient path; here the scripted collider IS the
decision variable.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from ..core.colliders import make_colliders
from ..core.config import LambdaMode, SolveMode, SolverConfig
from ..core.state import state_from_topology
from ..interact import animator
from ..solvers import general
from ..topology import build, lattice


def _sweep_traj(params, n_steps: int, start_x: float, radius: float):
    """(push, height, lateral) -> (T, 1, 4) sphere poses: a straight
    sweep from ``start_x`` along +x, at learned height and z-offset."""
    push, height, lateral = params
    xs = start_x + jnp.linspace(0.0, 1.0, n_steps) * push
    traj = jnp.stack(
        [xs,
         jnp.broadcast_to(height, xs.shape),
         jnp.broadcast_to(lateral, xs.shape),
         jnp.full_like(xs, radius)], axis=-1)
    return traj[:, None, :]


def run(res: int = 4, steps: int = 50, dt: float = 1 / 60,
        target=(0.55, 0.25), lr: float = 0.8, opt_iters: int = 30,
        radius: float = 0.28, verbose: bool = True):
    """Returns (learned params, loss history).  ``target`` is the goal
    (x, z) for the soft cube's final centre of mass."""
    pos = np.asarray(lattice.lattice_points(res, center=(0.0, 0.5, 0.0)),
                     np.float32)
    edges, comp = lattice.lattice_edges(res)
    cfg = SolverConfig(
        substeps=2, iterations=3, damping=0.02,
        solve_mode=SolveMode.JACOBI, lambda_mode=LambdaMode.RESET,
        gravity_is_acceleration=True, ground_height=0.0, friction=0.4)
    topo = build.build_topology(pos, edges, comp)
    start_x = -1.2
    state0 = state_from_topology(topo, pos).replace(
        colliders=make_colliders(spheres=[(start_x, 0.5, 0.0, radius)],
                                 ground_height=0.0))
    step = general.make_step(topo, cfg, dt)
    target = jnp.asarray(target, jnp.float32)

    def loss(params):
        traj = _sweep_traj(params, steps, start_x, radius)
        out = animator.kinematic_rollout(state0, step, n_steps=steps,
                                         dt=dt, sphere_traj=traj)
        com = out.positions.mean(axis=0)
        return jnp.sum((com[jnp.array([0, 2])] - target) ** 2)

    vg = jax.jit(jax.value_and_grad(loss))
    # initial guess: a shallow straight poke that barely reaches the cube
    params = jnp.array([0.9, 0.5, 0.0], jnp.float32)
    history = []
    for _ in range(opt_iters):
        value, grad = vg(params)
        history.append(float(value))
        params = params - lr * grad
        # keep the sweep physical: push forward, sphere above the floor
        params = jnp.stack([jnp.clip(params[0], 0.2, 3.0),
                            jnp.clip(params[1], radius * 0.7, 1.2),
                            jnp.clip(params[2], -0.8, 0.8)])
    final = float(vg(params)[0])
    history.append(final)
    if verbose:
        print(f"loss: {history[0]:.4f} -> {final:.5f} over "
              f"{opt_iters} gradient steps")
        print("learned sweep (push, height, lateral): "
              f"{np.asarray(params).round(3)}")
    return np.asarray(params), history


if __name__ == "__main__":
    run()
