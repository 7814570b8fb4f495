"""Example 6 — differentiable simulation (beyond the reference).

Optimises a launch velocity by gradient descent THROUGH the compiled
physics: find the initial velocity that lands a soft cube's centre of mass
on a target after one second of flight, bounce and all.  The entire rollout
(substeps, constraint projection, floor contact, friction) is
reverse-differentiated by JAX — a capability with no reference counterpart.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from ..core.config import LambdaMode, SolveMode, SolverConfig
from ..kernels.diff import make_differentiable_lattice_step
from ..solvers import lattice as lat_engine
from ..topology import lattice


def run(res: int = 3, steps: int = 60, dt: float = 1 / 60,
        target=(1.5, 0.4, 0.0), lr: float = 4.0, opt_iters: int = 40,
        verbose: bool = True):
    """The rollout is ``kernels.diff.make_differentiable_lattice_step``:
    ``steps`` frames of the stencil engine, differentiated by reverse
    mode."""
    spec = lattice.lattice_spec(res, braced=True)
    cfg = SolverConfig(
        substeps=2, iterations=2, damping=0.01,
        solve_mode=SolveMode.JACOBI, lambda_mode=LambdaMode.RESET,
        gravity_is_acceleration=True, ground_height=0.0, friction=0.3)
    state0 = lat_engine.make_lattice_state(spec, center=(0.0, 0.6, 0.0))
    target = jnp.asarray(target, jnp.float32)

    rollout = make_differentiable_lattice_step(spec, cfg, dt, steps)

    def loss(v0):
        s = state0.replace(
            velocities=jnp.broadcast_to(v0, state0.velocities.shape))
        s = rollout(s)
        com = s.positions.mean(axis=0)
        return jnp.sum((com - target) ** 2)

    vg = jax.jit(jax.value_and_grad(loss))
    v0 = jnp.zeros(3)
    history = []
    for i in range(opt_iters):
        value, grad = vg(v0)
        history.append(float(value))
        v0 = v0 - lr * grad
    final = float(vg(v0)[0])
    if verbose:
        print(f"loss: {history[0]:.4f} -> {final:.6f} over "
              f"{opt_iters} gradient steps")
        print(f"learned launch velocity: {np.asarray(v0).round(3)}")
    return np.asarray(v0), history + [final]


if __name__ == "__main__":
    run()
