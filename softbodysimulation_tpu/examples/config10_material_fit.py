"""Example 10 — material system identification (beyond the reference).

Recovers a soft body's MATERIAL parameters from an observed trajectory:
a "ground-truth" icosphere is rolled out, the rest lengths are perturbed,
and gradient descent through the simulator fits them back — the classic
system-identification workload (estimate stiffness / rest shape from
motion capture).  The rollouts run the general engine's windowed backend
with the materials as traced inputs, and ``jax.grad`` differentiates
them (``kernels/diff.py``, ``make_differentiable_material_runner``).  No
reference counterpart:
the reference solver (``SoftBodyCPU.cs``) is not differentiable at all.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from ..core.config import SolveMode, SolverConfig
from ..core.state import state_from_topology
from ..kernels.diff import make_differentiable_material_runner
from ..topology import build, mesh
from ..topology.edges import unique_edges


def material_problem(subdiv: int = 1, n_substeps: int = 6,
                     dt_sub: float = 1 / 240, perturb: float = 0.08,
                     seed: int = 0):
    """``(loss, rest0, truth)``: the trajectory loss as a function of the
    rest lengths, the perturbed starting guess and the ground truth."""
    m = mesh.icosphere(subdiv)
    pos, topo = build.build_windowed_topology(
        m.vertices, unique_edges(m.triangles), 1e-4, triangles=m.triangles)
    cfg = SolverConfig(substeps=2, iterations=2, damping=0.01,
                       solve_mode=SolveMode.JACOBI, jacobi_rho=0.0,
                       distance_backend="windowed", ground_height=-2.0)
    st = state_from_topology(topo, pos + np.array([0, 0.5, 0], np.float32))

    rollout = make_differentiable_material_runner(topo, cfg, dt_sub,
                                                  n_substeps)

    truth = topo.rest_lengths
    target = rollout(st, {"rest_lengths": truth,
                          "compliance": topo.compliance}).positions

    def loss(rest):
        out = rollout(st, {"rest_lengths": rest,
                           "compliance": topo.compliance})
        return jnp.sum((out.positions - target) ** 2)

    rng = np.random.default_rng(seed)
    rest0 = truth * jnp.asarray(
        1.0 + perturb * rng.standard_normal(truth.shape), jnp.float32)
    return loss, rest0, truth


def run(subdiv: int = 1, n_substeps: int = 6, dt_sub: float = 1 / 240,
        perturb: float = 0.08, opt_iters: int = 8, seed: int = 0,
        verbose: bool = True):
    """Returns ``(initial_loss, final_loss, err0, err1)`` — the fit must
    shrink both the trajectory loss and the mean rest-length error."""
    loss, rest, truth = material_problem(subdiv, n_substeps, dt_sub,
                                         perturb, seed)
    err0 = float(jnp.abs(rest - truth).mean())
    l0 = float(loss(rest))
    vg = jax.value_and_grad(loss)
    for _ in range(opt_iters):
        val, g = vg(rest)
        lr = 0.25 * val / jnp.maximum(jnp.sum(g * g), 1e-30)
        for _ in range(8):                       # backtracking line search
            trial = rest - lr * g
            if float(loss(trial)) < float(val):
                rest = trial
                break
            lr = lr * 0.25
    l1 = float(loss(rest))
    err1 = float(jnp.abs(rest - truth).mean())
    if verbose:
        print(f"trajectory loss: {l0:.3e} -> {l1:.3e} "
              f"({opt_iters} gradient steps)")
        print(f"mean |rest-length error|: {err0:.4f} -> {err1:.4f}")
    return l0, l1, err0, err1


if __name__ == "__main__":
    run()
