"""Ensemble batching and multi-chip data parallelism.

The reference simulates ONE body per component instance; the batch axis is
the capability it lacks entirely (SURVEY §2.4 'Batch over bodies: absent').
Here an ensemble is just a vmapped ``SimState`` whose leaves carry a leading
body axis, and multi-chip scaling is a ``shard_map`` over a 1-D device mesh:
each chip owns a contiguous slab of bodies, the physics needs NO cross-chip
traffic (bodies are independent), and only ensemble diagnostics reduce
across devices with ``psum``/``pmax``.
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.config import SolverConfig
from ..core.state import SimState
from ..solvers import general as _general
from ..solvers import lattice as _lattice


def stack_states(states) -> SimState:
    """Stack per-body SimStates into one batched SimState (B on axis 0)."""
    return jax.tree.map(lambda *xs: jnp.stack(xs), *states)


def replicate_state(state: SimState, n_bodies: int) -> SimState:
    return jax.tree.map(
        lambda x: jnp.broadcast_to(x[None], (n_bodies,) + x.shape), state)


def body_slice(batched: SimState, i: int) -> SimState:
    return jax.tree.map(lambda x: x[i], batched)


def make_batched_step(step_fn: Callable[[SimState], SimState]):
    """vmap a single-body ``state -> state`` over the body axis."""
    return jax.jit(jax.vmap(step_fn))


def make_batched_lattice_step(spec, cfg: SolverConfig, dt: float,
                              n_steps: int = 1):
    def one(state):
        return _lattice.multi_step_fn(state, spec, cfg, dt, n_steps)

    return jax.jit(jax.vmap(one))


def make_batched_general_step(topo, cfg: SolverConfig, dt: float,
                              n_steps: int = 1):
    def one(state):
        return _general.multi_step_fn(state, topo, cfg, dt, n_steps)

    return jax.jit(jax.vmap(one))


# ------------------------------------------------------------- multi-chip
def make_mesh(n_devices: Optional[int] = None, axis: str = "dp") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))


def shard_batched_state(batched: SimState, mesh: Mesh,
                        axis: str = "dp") -> SimState:
    """Place a batched state so the body axis is split across the mesh."""
    sharding = NamedSharding(mesh, P(axis))
    return jax.tree.map(
        lambda x: jax.device_put(x, sharding), batched)


def make_sharded_lattice_step(spec, cfg: SolverConfig, dt: float, mesh: Mesh,
                              n_steps: int = 1, axis: str = "dp",
                              kin_colliders: bool = False):
    """Batched lattice step sharded over chips.

    Bodies are independent, so the compiled program is pure per-chip compute;
    XLA inserts zero collectives in the hot loop.  Combine with
    ``ensemble_diagnostics`` for the cross-chip reduction path.

    ``kin_colliders=True``: the returned step takes ``(batched, colliders)``
    — ONE shared ``ColliderSet`` whose traced poses are replicated to every
    chip and act on every body (a rigid paddle sweeping through the whole
    farm animates with zero recompiles)."""
    spec_b = jax.tree.map(lambda _: P(axis), _state_structure(spec))

    if not kin_colliders:
        vstep = jax.vmap(
            lambda s: _lattice.multi_step_fn(s, spec, cfg, dt, n_steps))
        fn = shard_map(vstep, mesh=mesh, in_specs=(spec_b,),
                       out_specs=spec_b, check_vma=False)
        return jax.jit(fn)

    def local(st, cset):
        return jax.vmap(lambda s: _lattice.multi_step_fn(
            s.replace(colliders=cset), spec, cfg, dt, n_steps
        ).replace(colliders=None))(st)

    fn = shard_map(local, mesh=mesh, in_specs=(spec_b, P()),
                   out_specs=spec_b, check_vma=False)

    @jax.jit
    def step(batched: SimState, colliders) -> SimState:
        return fn(batched, colliders)

    return step


def make_sharded_lattice_rollout(spec, cfg: SolverConfig, dt_sub: float,
                                 n_substeps: int, mesh: Mesh, n_bodies: int,
                                 axis: str = "dp", kin_colliders=None):
    """DP over chips x a vmapped raw-substep rollout per shard.

    Each chip advances its contiguous slab of bodies through the stencil
    engine's ``make_substep_runner`` in one compiled program with zero
    hot-loop collectives.  Raw substep semantics (no external forces),
    matching the single-chip runner; use ``make_sharded_lattice_step``
    when the per-step force lifecycle is needed.  ``n_bodies`` is the
    GLOBAL body count and must divide by the mesh size.

    ``kin_colliders=(S, B)``: the returned stepper takes ``(batched,
    colliders)`` — ONE shared ``ColliderSet``, replicated to every chip
    and acting on every body in the farm (traced poses; animation never
    recompiles)."""
    n_shards = mesh.devices.size
    if n_bodies % n_shards:
        raise ValueError(f"n_bodies={n_bodies} must divide the "
                         f"{n_shards}-device mesh")
    runner = _lattice.make_substep_runner(spec, cfg, dt_sub, n_substeps)
    spec_b = jax.tree.map(lambda _: P(axis), _state_structure(spec))
    if kin_colliders is None:
        return jax.jit(shard_map(jax.vmap(runner), mesh=mesh,
                                 in_specs=(spec_b,), out_specs=spec_b,
                                 check_vma=False))

    def local(st, cset):
        return jax.vmap(lambda s: runner(
            s.replace(colliders=cset)).replace(colliders=None))(st)

    fn = shard_map(local, mesh=mesh, in_specs=(spec_b, P()),
                   out_specs=spec_b, check_vma=False)

    @jax.jit
    def stepper(batched: SimState, colliders) -> SimState:
        return fn(batched, colliders)

    return stepper


def make_differentiable_sharded_mesh_rollout(topo, cfg: SolverConfig,
                                             dt_sub: float, n_substeps: int,
                                             mesh: Mesh, n_bodies: int,
                                             axis: str = "dp",
                                             per_body_mass: bool = False,
                                             remat_chunk: int = 0):
    """DISTRIBUTED differentiable farm: the vmapped general engine, one
    contiguous slab of bodies per chip under ``shard_map`` with zero
    hot-loop collectives.  ``jax.grad`` of a loss over the whole
    multi-chip farm returns per-body gradients, the shard_map transpose
    inserting exactly the collectives the sharding implies (a ``psum``
    over chips for a replicated ``inv_mass`` leaf, none for the split
    body leaves).  External forces are consumed on the first substep and
    zeroed after; ``per_body_mass=True`` takes ``inv_mass`` as a (B, n)
    leaf that splits with the bodies; ``remat_chunk`` chunks the ext-free
    tail of the rollout (see ``kernels.diff._substep_rollout``).
    ``n_bodies`` is the GLOBAL body count and must divide by the mesh
    size."""
    from ..kernels.diff import _check_chunk, _substep_rollout

    if n_bodies % mesh.devices.size:
        raise ValueError(f"n_bodies={n_bodies} must divide the "
                         f"{mesh.devices.size}-device mesh")
    _check_chunk(max(n_substeps - 1, 1), remat_chunk)
    has_tets = cfg.enable_tet_volume and topo.n_tets > 0

    def one(state: SimState) -> SimState:
        s = _general._substep(state, topo, cfg, dt_sub, apply_ext=True)
        if n_substeps > 1:
            roll = _substep_rollout(
                lambda c: _general._substep(c, topo, cfg, dt_sub,
                                            apply_ext=False),
                n_substeps - 1, remat_chunk)
            s = roll(s)
        return s.replace(ext_force=jnp.zeros_like(state.ext_force))

    def local_arrays(pos, vel, ext, lam, lamb, w, *rest):
        def body(p, v, f, ld, lb, *r):
            st = SimState(
                positions=p, velocities=v,
                inv_mass=r[-1] if per_body_mass else w,
                ext_force=f, lambda_dist=ld, lambda_bend=lb,
                lambda_volume=jnp.zeros((), jnp.float32),
                lambda_tet=r[0] if has_tets else None)
            out = one(st)
            return ((out.positions, out.velocities, out.ext_force,
                     out.lambda_dist, out.lambda_bend)
                    + ((out.lambda_tet,) if has_tets else ()))

        margs = (pos, vel, ext, lam, lamb) + rest
        if per_body_mass:
            margs = margs + (w,)
        return jax.vmap(body)(*margs)

    n_out = 6 if has_tets else 5
    w_spec = P(axis) if per_body_mass else P()
    fn = shard_map(local_arrays, mesh=mesh,
                   in_specs=(P(axis), P(axis), P(axis), P(axis), P(axis),
                             w_spec) + ((P(axis),) if has_tets else ()),
                   out_specs=(P(axis),) * n_out,
                   check_vma=False)

    @jax.jit
    def run(batched: SimState) -> SimState:
        args = [batched.positions, batched.velocities, batched.ext_force,
                batched.lambda_dist, batched.lambda_bend, batched.inv_mass]
        if has_tets:
            args.append(batched.lambda_tet)
        res = fn(*args)
        out = batched.replace(positions=res[0], velocities=res[1],
                              ext_force=res[2], lambda_dist=res[3],
                              lambda_bend=res[4])
        if has_tets:
            out = out.replace(lambda_tet=res[5])
        return out

    return run


def make_sharded_general_step(topo, cfg: SolverConfig, dt: float, mesh: Mesh,
                              n_steps: int = 1, axis: str = "dp"):
    """Batched GENERAL-engine (arbitrary mesh) step sharded over chips: the
    DP analog for mesh ensembles (bunny farms).  The topology — including
    the windowed one-hot matrices when present — is replicated per chip;
    the body axis splits.  Pure per-chip compute, zero hot-loop
    collectives; pair with ``make_sharded_ensemble_diagnostics``."""
    vstep = jax.vmap(
        lambda s: _general.multi_step_fn(s, topo, cfg, dt, n_steps))
    spec_b = SimState(
        positions=P(axis), velocities=P(axis), inv_mass=P(axis),
        ext_force=P(axis), lambda_dist=P(axis), lambda_bend=P(axis),
        lambda_volume=P(axis),
        lambda_tet=(P(axis) if topo.n_tets else None))

    fn = shard_map(vstep, mesh=mesh, in_specs=(spec_b,), out_specs=spec_b,
                   check_vma=False)
    return jax.jit(fn)


def _state_structure(spec) -> SimState:
    """A SimState of ShapeDtypeStructs for building PartitionSpec pytrees."""
    n = spec.n_particles
    f = jnp.float32
    mk = jax.ShapeDtypeStruct
    return SimState(
        positions=mk((n, 3), f), velocities=mk((n, 3), f),
        inv_mass=mk((n,), f), ext_force=mk((n, 3), f),
        lambda_dist=mk((_lattice.n_lambda(spec),), f),
        lambda_bend=mk((0,), f), lambda_volume=mk((), f),
    )


def make_sharded_ensemble_diagnostics(mesh: Mesh, ground_height: float = 0.0,
                                      axis: str = "dp"):
    """Cross-chip ensemble health reduction: one jitted call returning global
    max velocity / non-finite count / mean height over ALL bodies on ALL
    chips — the psum/pmax collective path."""
    def local(positions, velocities):
        # positions/velocities: (B_local, N, 3)
        vmax = jnp.abs(velocities).max()
        bad = jnp.logical_not(
            jnp.isfinite(positions).all(axis=(1, 2))).sum()
        height = positions[..., 1].mean()
        ground = (jnp.abs(positions[..., 1] - ground_height) < 0.01).sum()
        vmax = jax.lax.pmax(vmax, axis)
        bad = jax.lax.psum(bad, axis)
        height = jax.lax.pmean(height, axis)
        ground = jax.lax.psum(ground, axis)
        return vmax, bad, height, ground

    fn = shard_map(
        local, mesh=mesh,
        in_specs=(P(axis), P(axis)),
        out_specs=(P(), P(), P(), P()),
        check_vma=False)

    @jax.jit
    def run(batched: SimState):
        return fn(batched.positions, batched.velocities)

    return run
