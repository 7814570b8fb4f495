"""What a rollout primal and a gradient step cost on the differentiable
surface (``kernels/diff.py``), on the bunny mesh (an icosphere when the
asset is absent), general engine, windowed backend.

Rows (particle-substeps/s at the stated substeps per call):
  primal          — raw-substep rollout forward
  grad            — value_and_grad through the rollout (reverse mode)
  grad_long       — the same at LONG_GRAD_SUBSTEPS, remat-chunked
  fitloop{N}      — N gradient-descent steps in one jitted lax.scan
  grad_materials  — gradients w.r.t. rest lengths and compliances
  grad_collider   — gradients w.r.t. a kinematic collider's pose
  grad_material_farm_x{B} — B candidate materials per call, vmapped

Timed with ``jax.block_until_ready``, best of 5 after a compile call.
Prints one JSON line per row, each naming the device it ran on.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

from softbodysimulation_tpu import (  # noqa: E402
    SolveMode,
    SolverConfig,
    make_colliders,
    state_from_topology,
)
from softbodysimulation_tpu.core.scenes import BUNNY_PATHS  # noqa: E402
from softbodysimulation_tpu.kernels import diff as kdiff  # noqa: E402
from softbodysimulation_tpu.topology import build, mesh  # noqa: E402
from softbodysimulation_tpu.topology.objloader import load_obj  # noqa: E402

DT_SUB = 1.0 / 240.0
PRIMAL_SUBSTEPS = int(os.environ.get("BENCH_PRIMAL_SUBSTEPS", "2000"))
GRAD_SUBSTEPS = int(os.environ.get("BENCH_GRAD_SUBSTEPS", "40"))
LONG_GRAD_SUBSTEPS = int(os.environ.get("BENCH_LONG_GRAD_SUBSTEPS", "240"))
FITLOOP_STEPS = int(os.environ.get("BENCH_FITLOOP_STEPS", "30"))
DEVICE = jax.devices()[0]


def emit(**kw):
    print(json.dumps({**kw, "device": DEVICE.device_kind}), flush=True)


def measure(fn, arg, work, repeats=5):
    jax.block_until_ready(fn(arg))                 # compile
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(arg))
        best = min(best, time.perf_counter() - t0)
    return work / best


def main():
    p = next((q for q in BUNNY_PATHS if os.path.exists(q)), None)
    m = load_obj(p) if p else mesh.icosphere(4, radius=0.5)
    pos, topo = build.topology_from_mesh(
        m, compliance=1e-6, windowed=True, block_edges=256, seg_align=32,
        window_dtype="bf16")
    pos = pos + np.array([0, 1.0, 0], np.float32)
    cfg = SolverConfig(substeps=4, iterations=4, damping=0.02,
                       solve_mode=SolveMode.JACOBI,
                       gravity_is_acceleration=True,
                       distance_backend="windowed",
                       ground_height=0.0, friction=0.3)
    st = state_from_topology(topo, pos)
    n = topo.n_particles
    emit(row="scene", n=n, e=topo.n_edges, primal_substeps=PRIMAL_SUBSTEPS,
         grad_substeps=GRAD_SUBSTEPS)

    roll = kdiff.make_differentiable_mesh_runner(topo, cfg, DT_SUB,
                                                 PRIMAL_SUBSTEPS)
    emit(row="primal", particle_substeps_per_s=measure(
        lambda s: roll(s).positions, st, n * PRIMAL_SUBSTEPS))

    def velocity_loss(runner):
        return lambda v0: jnp.sum(runner(st.replace(
            velocities=jnp.broadcast_to(v0, st.velocities.shape))
        ).positions ** 2)

    v0 = jnp.asarray([0.1, 0.0, 0.0])
    roll_g = kdiff.make_differentiable_mesh_runner(topo, cfg, DT_SUB,
                                                   GRAD_SUBSTEPS)
    emit(row="grad", particle_substeps_per_s=measure(
        jax.jit(jax.value_and_grad(velocity_loss(roll_g))), v0,
        n * GRAD_SUBSTEPS))

    roll_l = kdiff.make_differentiable_mesh_runner(
        topo, cfg, DT_SUB, LONG_GRAD_SUBSTEPS, remat_chunk=GRAD_SUBSTEPS)
    emit(row="grad_long", substeps=LONG_GRAD_SUBSTEPS,
         particle_substeps_per_s=measure(
             jax.jit(jax.value_and_grad(velocity_loss(roll_l))), v0,
             n * LONG_GRAD_SUBSTEPS))

    loss = velocity_loss(roll_g)

    @jax.jit
    def fit(v):
        def gstep(c, _):
            return c - 1e-6 * jax.grad(loss)(c), None
        out, _ = lax.scan(gstep, v, None, length=FITLOOP_STEPS)
        return out

    emit(row=f"fitloop{FITLOOP_STEPS}", particle_substeps_per_s=measure(
        fit, v0, n * GRAD_SUBSTEPS * FITLOOP_STEPS))

    mats0 = {"rest_lengths": topo.rest_lengths,
             "compliance": topo.compliance}
    mat_runner = kdiff.make_differentiable_material_runner(
        topo, cfg, DT_SUB, GRAD_SUBSTEPS)
    emit(row="grad_materials", particle_substeps_per_s=measure(
        jax.jit(jax.value_and_grad(
            lambda mats: jnp.sum(mat_runner(st, mats).positions ** 2))),
        mats0, n * GRAD_SUBSTEPS))

    coll0 = make_colliders(spheres=[(0.0, 0.8, 0.0, 0.3)],
                           ground_height=0.0)
    stc = st.replace(colliders=coll0)
    emit(row="grad_collider", particle_substeps_per_s=measure(
        jax.jit(jax.value_and_grad(
            lambda c: jnp.sum(roll_g(stc.replace(colliders=c)
                                     ).positions ** 2))),
        coll0, n * GRAD_SUBSTEPS))

    nb = int(os.environ.get("BENCH_FARM_BODIES", "16"))
    batched = jax.tree.map(lambda x: jnp.broadcast_to(x, (nb,) + x.shape),
                           st.replace(inv_mass=None)).replace(
                               inv_mass=st.inv_mass)
    scales = 1.0 + 0.02 * jnp.arange(nb, dtype=jnp.float32)[:, None]
    mats_b = {"rest_lengths": topo.rest_lengths[None] * scales,
              "compliance": jnp.broadcast_to(topo.compliance[None],
                                             (nb,) + topo.compliance.shape)}
    farm = kdiff.make_differentiable_material_ensemble_runner(
        topo, cfg, DT_SUB, GRAD_SUBSTEPS)
    emit(row=f"grad_material_farm_x{nb}", particle_substeps_per_s=measure(
        jax.jit(jax.value_and_grad(
            lambda mats: jnp.sum(farm(batched, mats).positions ** 2))),
        mats_b, nb * n * GRAD_SUBSTEPS))


if __name__ == "__main__":
    main()
