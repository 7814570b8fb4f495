"""Functional interaction API: poke / drag / pin — all device-side.

The reference re-uploads the whole (stale!) host particle array on every
interaction (``SoftBodySimulator.AddForce``, ``SoftBodySimulator.cs:925-942``;
``SetPinned`` ``:944-959``).  Here interactions are pure
``SimState -> SimState`` updates computed on device against the LIVE
positions — both faster and more correct than the reference.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from ..core.state import SimState


@jax.jit
def add_force(state: SimState, force, position, radius=1.0) -> SimState:
    """Accumulate a radial linear-falloff force: falloff = 1 - d/radius for
    d < radius (``SoftBodySimulator.cs:930-937``).  Consumed by the next
    step's first substep."""
    force = jnp.asarray(force, dtype=state.positions.dtype)
    position = jnp.asarray(position, dtype=state.positions.dtype)
    d = jnp.linalg.norm(state.positions - position, axis=1)
    fall = jnp.where(d < radius, 1.0 - d / radius, 0.0)
    return state.replace(ext_force=state.ext_force + fall[:, None] * force)


@jax.jit
def add_uniform_force(state: SimState, force) -> SimState:
    force = jnp.asarray(force, dtype=state.positions.dtype)
    return state.replace(ext_force=state.ext_force + force[None, :])


def set_pinned(state: SimState, position, radius=0.5, pinned=True,
               mass: float = 1.0) -> SimState:
    """Pin/unpin particles within radius: inv_mass = 0 or 1/mass
    (``SoftBodySimulator.cs:944-959``)."""
    position = jnp.asarray(position, dtype=state.positions.dtype)
    d = jnp.linalg.norm(state.positions - position, axis=1)
    sel = d < radius
    new_w = jnp.asarray(0.0 if pinned else 1.0 / mass,
                        dtype=state.inv_mass.dtype)
    inv_mass = jnp.where(sel, new_w, state.inv_mass)
    vel = jnp.where(sel[:, None] & pinned, 0.0, state.velocities)
    return state.replace(inv_mass=inv_mass, velocities=vel)


def pin_indices(state: SimState, indices, pinned=True,
                mass: float = 1.0) -> SimState:
    """Pin/unpin explicit particle indices (anchor vertices; the analog of
    ``pinFirstParticle``, ``SoftBodyGPU.cs:284-285``)."""
    indices = jnp.asarray(indices, dtype=jnp.int32)
    new_w = 0.0 if pinned else 1.0 / mass
    inv_mass = state.inv_mass.at[indices].set(new_w)
    vel = state.velocities
    if pinned:
        vel = vel.at[indices].set(0.0)
    return state.replace(inv_mass=inv_mass, velocities=vel)


def add_wind(state: SimState, topo, direction, strength: float = 1.0,
             gustiness: float = 0.0, seed: int = 0) -> SimState:
    """Aerodynamic wind load on the surface: per-vertex force proportional
    to the area-weighted projection of the wind onto the vertex normal
    (faces square to the wind catch it, edge-on faces don't) with optional
    per-vertex gust noise.  A standard cloth/soft-body forcing the
    reference lacks; composes with the ext_force accumulator like any poke.
    """
    from ..ops.normals import vertex_normals

    d = jnp.asarray(direction, dtype=state.positions.dtype)
    d = d / jnp.maximum(jnp.linalg.norm(d), 1e-9)
    normals = vertex_normals(state.positions, topo.triangles)
    # projection magnitude; abs() so both sides of a sheet catch wind.
    # HIGHEST: a DEFAULT-precision f32 dot may run in TF32 on a GPU
    catch = jnp.abs(jnp.matmul(normals, d, precision=lax.Precision.HIGHEST))
    mag = strength * catch
    if gustiness > 0:
        key = jax.random.PRNGKey(seed)
        mag = mag * (1.0 + gustiness * jax.random.uniform(
            key, mag.shape, minval=-1.0, maxval=1.0))
    return state.replace(ext_force=state.ext_force + mag[:, None] * d)


@jax.jit
def drag_force(state: SimState, target, strength=5.0, radius=2.0) -> SimState:
    """Continuous drag toward a cursor/target point
    (``SoftBodyInteractor.cs:61-66``: direction * strength * 0.1)."""
    target = jnp.asarray(target, dtype=state.positions.dtype)
    com = state.positions.mean(axis=0)
    direction = target - com
    norm = jnp.linalg.norm(direction)
    direction = jnp.where(norm > 1e-9, direction / jnp.maximum(norm, 1e-9), 0.0)
    return add_force(state, direction * strength, target, radius)


@jax.jit
def squeeze_impulse(state: SimState, center, intensity=1.0,
                    radius=3.0) -> SimState:
    """Inward radial squeeze (``SoftBodyAnimator.SqueezeEffect``,
    ``SoftBodyAnimator.cs:76-94``)."""
    center = jnp.asarray(center, dtype=state.positions.dtype)
    d = state.positions - center
    dist = jnp.linalg.norm(d, axis=1)
    inward = -d / jnp.maximum(dist, 1e-9)[:, None]
    fall = jnp.where(dist < radius, 1.0 - dist / radius, 0.0)
    return state.replace(
        ext_force=state.ext_force + inward * (fall * intensity * 50.0)[:, None]
    )
