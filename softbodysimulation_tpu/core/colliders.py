"""Kinematic rigid-collider state: the rigid world, promoted to a pytree.

The reference gets a MOVING rigid world for free from PhysX — colliders
translate through the scene and inject trigger forces
(``SoftBodyController.cs:110-118``), and the floor is re-raycast every
substep so it may change at runtime (``SoftBodySimulator.cs:777-788``).
Round-3 of this framework froze that world into ``SolverConfig`` constants
(sphere/box tuples + ``ground_height``), which XLA folds into the compiled
program — a scripted rigid sphere sweeping through a soft body could not be
expressed without a recompile per pose.

``ColliderSet`` is the compiled-program fix: the collider POSES become traced
``SimState`` leaves (a ``(S, 4)`` sphere array, a ``(B, 6)`` box array, a
scalar ground height), so the same compiled step program serves every pose —
animate by replacing the leaf between steps (host-side) or by indexing a
pose trajectory inside a ``lax.scan`` (on-device, differentiable; gradients
w.r.t. a collider trajectory drive contact-rich control problems).  Only the
*poses* are traced; collider COUNTS stay static shapes and the contact
material parameters (friction, compliance, restitution) stay on the config —
exactly the split XLA wants.

When ``SimState.colliders`` is ``None`` (the default) every engine keeps its
round-3 behavior bitwise: the rigid world comes from the config constants.
When present, the ColliderSet REPLACES the config's rigid world entirely
(``sphere_colliders`` / ``box_colliders`` / ``ground_height`` are ignored).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class ColliderSet:
    """Traced rigid-world poses.

    spheres       — (S, 4) f32 rows ``(cx, cy, cz, radius)``.
    boxes         — (B, 6) f32 rows ``(cx, cy, cz, hx, hy, hz)`` (axis-
                    aligned half-extents, like ``SolverConfig.box_colliders``).
    ground_height — () f32; the floor plane the floor modes project against.
    sphere_velocities / box_velocities — (S, 3) / (B, 3) f32 world-frame
                    collider velocities.  Used ONLY by the friction term:
                    tangential damping acts on the particle velocity
                    RELATIVE to the collider, so a sweeping collider drags
                    contacting particles along (the kinematic analog of
                    PhysX's moving-collider friction).  Zeros (the default)
                    reproduce the static-collider arithmetic exactly.

    Counts S and B are static shapes — animating poses never recompiles;
    changing the NUMBER of colliders does (build a new set).
    """

    spheres: jax.Array
    boxes: jax.Array
    ground_height: jax.Array
    sphere_velocities: jax.Array
    box_velocities: jax.Array

    @property
    def n_spheres(self) -> int:
        return self.spheres.shape[0]

    @property
    def n_boxes(self) -> int:
        return self.boxes.shape[0]

    def replace(self, **kw) -> "ColliderSet":
        return dataclasses.replace(self, **kw)

    # ---- pose animation helpers (all pure; all trace-safe) -------------
    def with_sphere(self, i: int, center=None, radius=None,
                    velocity=None) -> "ColliderSet":
        """Functionally update one sphere's pose (and optionally the
        velocity used by the friction frame)."""
        s = self.spheres
        if center is not None:
            c = jnp.asarray(center, s.dtype)
            s = s.at[i, :3].set(c)
        if radius is not None:
            s = s.at[i, 3].set(jnp.asarray(radius, s.dtype))
        sv = self.sphere_velocities
        if velocity is not None:
            sv = sv.at[i].set(jnp.asarray(velocity, sv.dtype))
        return self.replace(spheres=s, sphere_velocities=sv)

    def with_box(self, i: int, center=None, half_extents=None,
                 velocity=None) -> "ColliderSet":
        b = self.boxes
        if center is not None:
            b = b.at[i, :3].set(jnp.asarray(center, b.dtype))
        if half_extents is not None:
            b = b.at[i, 3:].set(jnp.asarray(half_extents, b.dtype))
        bv = self.box_velocities
        if velocity is not None:
            bv = bv.at[i].set(jnp.asarray(velocity, bv.dtype))
        return self.replace(boxes=b, box_velocities=bv)

    def with_ground(self, height) -> "ColliderSet":
        return self.replace(
            ground_height=jnp.asarray(height, self.spheres.dtype))


jax.tree_util.register_dataclass(
    ColliderSet,
    data_fields=["spheres", "boxes", "ground_height",
                 "sphere_velocities", "box_velocities"],
    meta_fields=[],
)


def make_colliders(spheres=None, boxes=None, ground_height=0.0,
                   sphere_velocities=None, box_velocities=None,
                   dtype=jnp.float32) -> ColliderSet:
    """Build a ColliderSet from host data.

    ``spheres`` — iterable of (cx, cy, cz, r) or an (S, 4) array; ``boxes``
    — iterable of (cx, cy, cz, hx, hy, hz) or (B, 6).  Velocities default
    to zeros (static-collider friction frame).
    """
    sph = jnp.asarray(spheres, dtype).reshape(-1, 4) if spheres is not None \
        else jnp.zeros((0, 4), dtype)
    box = jnp.asarray(boxes, dtype).reshape(-1, 6) if boxes is not None \
        else jnp.zeros((0, 6), dtype)
    sv = (jnp.asarray(sphere_velocities, dtype).reshape(-1, 3)
          if sphere_velocities is not None
          else jnp.zeros((sph.shape[0], 3), dtype))
    bv = (jnp.asarray(box_velocities, dtype).reshape(-1, 3)
          if box_velocities is not None
          else jnp.zeros((box.shape[0], 3), dtype))
    if sv.shape[0] != sph.shape[0] or bv.shape[0] != box.shape[0]:
        raise ValueError("collider velocity row counts must match poses")
    return ColliderSet(spheres=sph, boxes=box,
                       ground_height=jnp.asarray(ground_height, dtype),
                       sphere_velocities=sv, box_velocities=bv)


def colliders_from_config(cfg) -> ColliderSet:
    """Materialize the config's static rigid world as a ColliderSet.

    ``state.replace(colliders=colliders_from_config(cfg))`` reproduces the
    config-constant behavior exactly (same formulas, zero collider
    velocities) — the equivalence every engine pins in tests — and from
    there the poses can be animated without recompiles.
    """
    return make_colliders(
        spheres=(tuple(cfg.sphere_colliders) or None),
        boxes=(tuple(cfg.box_colliders) or None),
        ground_height=cfg.ground_height,
    )
