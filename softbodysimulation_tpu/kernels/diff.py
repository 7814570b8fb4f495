"""Differentiable rollouts over the XLA engines.

Each ``make_differentiable_*`` factory returns a jitted rollout whose
forward is the stencil engine (``solvers/lattice``) or the general engine
(``solvers/general``) scanned over substeps or frames, so ``jax.grad``
differentiates exactly the trajectory the forward computed.
``remat_chunk`` bounds reverse-mode memory (see ``_substep_rollout``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from ..core.state import SimState


def _check_chunk(n_substeps: int, remat_chunk: int):
    if remat_chunk and 0 < remat_chunk < n_substeps \
            and n_substeps % remat_chunk:
        raise ValueError(
            f"remat_chunk {remat_chunk} must divide n_substeps "
            f"{n_substeps}")


def _substep_rollout(substep_fn, n_substeps: int, remat_chunk: int = 0):
    """``state -> state`` advancing ``n_substeps`` calls of ``substep_fn``.

    ``remat_chunk = K > 0`` splits the scan into N/K checkpointed segments:
    reverse-mode then stores only the N/K chunk-boundary states plus one
    in-flight chunk (O(N/K + K) carries instead of O(N)), recomputing each
    chunk's forward once during the backward — the standard sqrt-memory
    rematerialisation tradeoff that makes gradients through long rollouts
    fit in device memory (a 64k-particle body at 2000 substeps would
    otherwise hold ~9 GB of carries).  Arithmetic is unchanged (the
    recomputation replays identical ops), so gradients match the flat scan
    exactly."""

    def body(carry, _):
        return substep_fn(carry), None

    if remat_chunk and 0 < remat_chunk < n_substeps:
        _check_chunk(n_substeps, remat_chunk)

        @jax.checkpoint
        def chunk(state):
            out, _ = lax.scan(body, state, None, length=remat_chunk)
            return out

        def roll(state):
            def outer(carry, _):
                return chunk(carry), None

            out, _ = lax.scan(outer, state, None,
                              length=n_substeps // remat_chunk)
            return out

        return roll

    def roll(state):
        out, _ = lax.scan(body, state, None, length=n_substeps)
        return out

    return roll


def _chunked(make_k, n: int, remat_chunk: int):
    """``make_k(n)`` flat, or ``n // remat_chunk`` checkpointed calls of
    ``make_k(remat_chunk)``."""
    _check_chunk(n, remat_chunk)
    if remat_chunk and 0 < remat_chunk < n:
        return jax.jit(_substep_rollout(jax.checkpoint(make_k(remat_chunk)),
                                        n // remat_chunk))
    return make_k(n)


def _mesh_substeps(topo, cfg, dt_sub: float, n_substeps: int,
                   remat_chunk: int):
    """Raw general-engine substeps (no external-force lifecycle)."""
    from ..solvers import general

    return _substep_rollout(
        lambda s: general._substep(s, topo, cfg, dt_sub, apply_ext=False),
        n_substeps, remat_chunk)


def make_differentiable_lattice_runner(spec, cfg, dt_sub: float,
                                       n_substeps: int,
                                       remat_chunk: int = 0):
    """Differentiable raw-substep lattice rollout on the stencil engine
    (``solvers/lattice.make_substep_runner`` semantics)."""
    from ..solvers import lattice as lat_engine

    return _chunked(
        lambda k: lat_engine.make_substep_runner(spec, cfg, dt_sub, k),
        n_substeps, remat_chunk)


def make_differentiable_mesh_runner(topo, cfg, dt_sub: float,
                                    n_substeps: int,
                                    remat_chunk: int = 0):
    """Differentiable raw-substep mesh rollout on the general engine:
    cotangents reach every SimState leaf (incl. ``inv_mass``) and, for a
    state carrying a ``ColliderSet``, the collider poses."""
    _check_chunk(n_substeps, remat_chunk)
    return jax.jit(_mesh_substeps(topo, cfg, dt_sub, n_substeps,
                                  remat_chunk))


def make_differentiable_lattice_step(spec, cfg, dt: float, n_steps: int = 1,
                                     remat_chunk: int = 0):
    """Differentiable FULL-STEP lattice rollout: ``n_steps`` frames with
    the reference external-force lifecycle (``ext_force`` consumed on each
    frame's first substep, zeroed after) — the control workload: a policy
    writes forces into the state and gradients flow back to the forces.
    ``remat_chunk`` counts frames."""
    from ..solvers import lattice as lat_engine

    return _chunked(lambda k: lat_engine.make_step(spec, cfg, dt, k),
                    n_steps, remat_chunk)


def make_differentiable_mesh_step(topo, cfg, dt: float, n_steps: int = 1,
                                  remat_chunk: int = 0):
    """Differentiable FULL-STEP mesh rollout (external-force lifecycle,
    contact cadence and self-collision as ``general.make_step``)."""
    from ..solvers import general

    return _chunked(lambda k: general.make_step(topo, cfg, dt, k),
                    n_steps, remat_chunk)


def _with_materials(topo, materials):
    return topo.replace(
        rest_lengths=jnp.asarray(materials["rest_lengths"], jnp.float32),
        compliance=jnp.asarray(materials["compliance"], jnp.float32))


def make_differentiable_material_runner(topo, cfg, dt_sub: float,
                                        n_substeps: int,
                                        remat_chunk: int = 0):
    """Differentiable-in-MATERIALS mesh rollout: returns
    ``fn(state, materials) -> SimState`` with
    ``materials = {"rest_lengths": (E,), "compliance": (E,)}`` (topology
    edge order).  Gradients reach the state leaves AND both material
    vectors — the material-fitting workload (estimate stiffness / rest
    shape from observed trajectories); the reference has no analog (its
    solver is not differentiable at all)."""
    _check_chunk(n_substeps, remat_chunk)

    @jax.jit
    def run(state: SimState, materials) -> SimState:
        return _mesh_substeps(_with_materials(topo, materials), cfg, dt_sub,
                              n_substeps, remat_chunk)(state)

    return run


# single-body rank per SimState leaf — used to spot leaves a batched state
# may keep shared across bodies (read-only inv_mass, scalar lambda_volume
# when the volume constraint is off, ...)
_LEAF_RANK = {"positions": 2, "velocities": 2, "ext_force": 2,
              "inv_mass": 1, "lambda_dist": 1, "lambda_bend": 1,
              "lambda_volume": 0, "lambda_tet": 1}


def _vmap_batched(one, state: SimState, *args) -> SimState:
    """``jax.vmap`` of a single-body rollout over a batched SimState whose
    shared leaves lack the body axis: broadcast those for the vmap (their
    cotangents sum back over bodies through the VJP) and restore the
    shared shape on output.  Extra ``args`` must already carry the body
    axis."""
    nb = state.positions.shape[0]
    shared = [k for k, r in _LEAF_RANK.items()
              if getattr(state, k) is not None
              and getattr(state, k).ndim == r]
    state = state.replace(**{
        k: jnp.broadcast_to(getattr(state, k),
                            (nb,) + getattr(state, k).shape)
        for k in shared})
    out = jax.vmap(one)(state, *args)
    return out.replace(**{k: getattr(out, k)[0] for k in shared})


def make_differentiable_material_ensemble_runner(topo, cfg, dt_sub: float,
                                                 n_substeps: int,
                                                 remat_chunk: int = 0):
    """Differentiable heterogeneous-MATERIAL farm: ``fn(state, materials)``
    where the SimState leaves are batched ``(B, ...)`` (``inv_mass`` may
    stay the shared ``(n,)`` leaf) and ``materials`` carries per-body
    ``(B, E)`` rest_lengths / compliance.  The general engine is vmapped
    over (state, materials), so gradients come back per body — the
    population-based material search workload."""
    _check_chunk(n_substeps, remat_chunk)

    def one(state: SimState, rest, comp) -> SimState:
        t2 = topo.replace(rest_lengths=rest, compliance=comp)
        return _mesh_substeps(t2, cfg, dt_sub, n_substeps,
                              remat_chunk)(state)

    @jax.jit
    def run(state: SimState, materials) -> SimState:
        return _vmap_batched(one, state,
                             jnp.asarray(materials["rest_lengths"],
                                         jnp.float32),
                             jnp.asarray(materials["compliance"],
                                         jnp.float32))

    return run


def make_differentiable_mesh_ensemble_runner(topo, cfg, dt_sub: float,
                                             n_substeps: int,
                                             remat_chunk: int = 0):
    """Differentiable HETEROGENEOUS mesh farm: the general engine vmapped
    over a batched SimState.  ``inv_mass`` may be a per-body ``(B, n)``
    leaf, so gradients flow to every batched leaf INCLUDING the per-body
    masses — the system-identification workload (fit per-instance
    masses/pins against observations)."""
    _check_chunk(n_substeps, remat_chunk)
    one = _mesh_substeps(topo, cfg, dt_sub, n_substeps, remat_chunk)

    @jax.jit
    def run(state: SimState) -> SimState:
        return _vmap_batched(one, state)

    return run
