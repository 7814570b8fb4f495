"""SimState / Topology pytrees.

The functional heart of the rebuild: the reference's mutable MonoBehaviour +
ComputeBuffer state (``SoftBodySimulator.cs:33-42``, ``Models/Particle.cs``,
``Models/DistanceConstraint.cs``, ``SoftBodyParticleCPU.cs``) collapses into
two immutable pytrees:

* ``SimState``  — everything that evolves in time (positions, velocities,
  inverse masses, external-force accumulator, accumulated Lagrange
  multipliers).  Advanced purely functionally by the solvers; lives on device
  for the whole simulation (zero per-step host round-trips, deleting the
  SetData/GetData chatter catalogued in SURVEY.md §2.5).
* ``Topology``  — everything static: edge list, rest lengths, compliances,
  color buckets, bending hinges, surface triangles.  Built once on host by
  ``topology/``, then uploaded.

Both are registered dataclasses, so they are checkpointable for free
(``io/checkpoint.py``) and compose with jit/vmap/shard_map.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .colliders import ColliderSet


def _register(cls, data_fields, meta_fields=()):
    jax.tree_util.register_dataclass(
        cls, data_fields=list(data_fields), meta_fields=list(meta_fields)
    )
    return cls


@dataclasses.dataclass(frozen=True)
class SimState:
    """Dynamic simulation state.

    Field mapping to the reference:
      positions / velocities / inv_mass  -> SoftBodyParticleCPU.cs:5-21 and the
                                            GPU Particle struct (XPBDSoftBody.compute:11-17)
      ext_force                          -> ExternalForceAccumulator
                                            (SoftBodyParticleCPU.cs:12, cleared each step)
      lambda_dist / lambda_bend / lambda_volume
                                         -> per-constraint accumulated XPBD multipliers
                                            (Constraint.lambda, XPBDSoftBody.compute:25;
                                            _lagrangeBuffer, SoftBodyGPU.cs:144)
    ``inv_mass == 0`` marks a pinned particle (SoftBodySimulator.cs:953).
    """

    positions: jax.Array          # (N, 3) f32
    velocities: jax.Array         # (N, 3) f32
    inv_mass: jax.Array           # (N,)   f32; 0 = pinned
    ext_force: jax.Array          # (N, 3) f32; consumed & zeroed on first substep
    lambda_dist: jax.Array        # (E,)   f32
    lambda_bend: jax.Array        # (H,)   f32 (H may be 0)
    lambda_volume: jax.Array      # ()     f32
    lambda_tet: Optional[jax.Array] = None   # (T,) f32 per-tet volume
    #   multipliers; None (an empty pytree) when the topology carries no
    #   tets, so tet-free states keep their original tree structure
    colliders: Optional["ColliderSet"] = None  # kinematic rigid world
    #   (core/colliders.py).  None (default) = the rigid world is the
    #   config constants (round-3 behavior, bitwise).  Present = these
    #   traced poses REPLACE cfg.sphere_colliders / box_colliders /
    #   ground_height, so colliders animate per step with no recompile
    #   (the capability PhysX gave the reference for free,
    #   SoftBodyController.cs:110-118, SoftBodySimulator.cs:777-788).

    @property
    def n_particles(self) -> int:
        return self.positions.shape[0]

    def replace(self, **kw) -> "SimState":
        return dataclasses.replace(self, **kw)

    def block_until_ready(self) -> "SimState":
        jax.block_until_ready(self.positions)
        return self


_register(
    SimState,
    data_fields=(
        "positions",
        "velocities",
        "inv_mass",
        "ext_force",
        "lambda_dist",
        "lambda_bend",
        "lambda_volume",
        "lambda_tet",
        "colliders",
    ),
)


@dataclasses.dataclass(frozen=True)
class Windows:
    """Windowed one-hot incidence for the general engine's windowed
    distance backend (see ``topology/windows.py``).  All block matrices are exact
    {0, +-1} one-hots, so the matmul-based sweep matches the gather-based
    sweep to f32 rounding.

    AB         — (K, 2S, W) gather one-hots: rows 0..S-1 pick endpoint a,
                 rows S..2S-1 endpoint b, from the block's particle window.
    C          — (K, W, 2S) scatter one-hots: window row <- a-side (cols
                 0..S-1) and b-side (cols S..2S-1) corrections.
    valid      — (K, S) 1.0 for real edges, 0.0 for block padding.
    inv_maxdeg — (K, S) validity-masked 1/max(deg_a, deg_b) Jacobi scale.
    win_onehot — (K*W/128, n_segs) one-hot extracting each window's
                 128-particle segments (window extraction = one matmul).
    seg_onehot — (n_segs, K*W/128) transpose; overlap-ADDS window deltas
                 back onto the particle segments (rows sum pieces).
    """

    AB: jax.Array
    C: jax.Array
    valid: jax.Array
    inv_maxdeg: jax.Array
    win_onehot: jax.Array
    seg_onehot: jax.Array
    n_blocks: int
    block_edges: int
    window: int
    n_segs: int
    seg: int = 128                # particle-segment granularity (alignment)

    def replace(self, **kw) -> "Windows":
        return dataclasses.replace(self, **kw)


_register(
    Windows,
    data_fields=("AB", "C", "valid", "inv_maxdeg", "win_onehot",
                 "seg_onehot"),
    meta_fields=("n_blocks", "block_edges", "window", "n_segs", "seg"),
)


@dataclasses.dataclass(frozen=True)
class HingeWindows:
    """Windowed signed-one-hot incidence for the bending (dihedral) Jacobi
    sweep (``topology/windows.py:build_hinge_windows``).  Exploits that the
    bending gradients are translation-invariant (only the differences
    e0 = pB-pA, e1 = pC-pA, e2 = pD-pA enter, ``ops/bending.py``) and that
    grad_A = -(grad_B + grad_C + grad_D): ONE signed matrix per block
    serves both sides —

    G   — (Kb, W, 3S) signed gather: lane blocks [0,S) -> e0 (+1 at B,
          -1 at A), [S,2S) -> e1 (+1 at C, -1 at A), [2S,3S) -> e2
          (+1 at D, -1 at A); ``e = window^T @ G``.
    GT  — (Kb, 3S, W) = G transposed: scattering [dl*gB | dl*gC | dl*gD]
          through it lands +dl*g_X on each tip and -dl*(gB+gC+gD) = dl*gA
          on A; the per-particle inverse-mass weight is applied AFTER the
          overlap-add (correction_i = w_i * accumulated sum).
    wsel — (Kb, W, 4S) {0,1} gather for the four endpoint inverse masses
          (needed in the XPBD denominator).
    """

    G: jax.Array
    GT: jax.Array
    wsel: jax.Array
    valid: jax.Array              # (Kb, S) 1.0 real hinge / 0.0 padding
    inv_maxdeg: jax.Array         # (Kb, S) validity-masked 1/max-degree
    win_onehot: jax.Array
    seg_onehot: jax.Array
    n_blocks: int
    block_hinges: int
    window: int
    n_segs: int
    seg: int = 128

    def replace(self, **kw) -> "HingeWindows":
        return dataclasses.replace(self, **kw)


_register(
    HingeWindows,
    data_fields=("G", "GT", "wsel", "valid", "inv_maxdeg", "win_onehot",
                 "seg_onehot"),
    meta_fields=("n_blocks", "block_hinges", "window", "n_segs", "seg"),
)


@dataclasses.dataclass(frozen=True)
class Topology:
    """Static constraint topology (device arrays; shapes fixed at trace time).

    edges / rest_lengths / compliance — distance constraints
      (built from mesh edges ``SoftBodyCPU.cs:160-201`` or lattice generators
      ``SoftBodySimulator.cs:214-290``).
    colors — per-edge color id from graph coloring
      (``SoftBodySimulator.cs:292-364``, ``GraphClustering.cs``); used by the
      COLORED solve mode.  ``num_colors`` is static metadata.
    col_* — padded per-color buckets (num_colors, max_per_color): edge indices
      and validity mask, precomputed so each color pass is a fixed-shape
      gather/scatter with no shared particles inside a pass.
    hinges / rest_angles / bend_compliance — dihedral bending constraints
      (``SoftBodyCPU.cs:203-266``; hinge = [A, B, C, D], hinge edge A-B,
      opposite tips C, D).
    bend_colors / bcol_* — same coloring machinery for hinges.
    triangles — surface triangles (for normals, volume constraint, export).
    rest_volume — signed volume of the closed surface at rest.
    degree — per-particle constraint degree (for Jacobi auto-relaxation).
    """

    edges: jax.Array              # (E, 2) i32
    rest_lengths: jax.Array       # (E,)   f32
    compliance: jax.Array         # (E,)   f32
    colors: jax.Array             # (E,)   i32
    col_edge_ids: jax.Array       # (C, M) i32 — indices into edges
    col_valid: jax.Array          # (C, M) f32 — 1.0 valid / 0.0 padding
    hinges: jax.Array             # (H, 4) i32
    rest_angles: jax.Array        # (H,)   f32
    bend_compliance: jax.Array    # (H,)   f32
    bend_colors: jax.Array        # (H,)   i32
    bcol_hinge_ids: jax.Array     # (Cb, Mb) i32
    bcol_valid: jax.Array         # (Cb, Mb) f32
    triangles: jax.Array          # (T, 3) i32
    rest_volume: jax.Array        # ()     f32
    degree: jax.Array             # (N,)   f32
    bend_degree: jax.Array        # (N,)   f32 — per-particle hinge incidence
    incidence: jax.Array          # (N, Dd) i32 — indices into the stacked
                                  #   2E edge-contribution array (pad = 2E);
                                  #   scatter-free Jacobi accumulation
    bend_incidence: jax.Array     # (N, Db) i32 — indices into the 4H hinge
                                  #   contributions (pad = 4H)
    num_colors: int               # static
    num_bend_colors: int          # static
    n_particles: int              # static
    windows: Optional[Windows] = None   # one-hot distance backend
                                        # (requires RCM-renumbered, window
                                        # -sorted edges; build.py wires it)
    bend_windows: Optional["HingeWindows"] = None  # one-hot bending backend
    # --- per-tet volume family (topology/tets.py; None when absent) ---
    tets: Optional[jax.Array] = None            # (T, 4) i32
    rest_tet_volumes: Optional[jax.Array] = None  # (T,) f32 — stored as 6*V0
    tet_compliance: Optional[jax.Array] = None  # (T,) f32
    tcol_tet_ids: Optional[jax.Array] = None    # (Ct, Mt) i32
    tcol_valid: Optional[jax.Array] = None      # (Ct, Mt) f32
    tet_degree: Optional[jax.Array] = None      # (N,) f32
    tet_incidence: Optional[jax.Array] = None   # (N, Dt) i32 into 4T contribs
    tet_windows: Optional["HingeWindows"] = None  # one-hot tet-sweep backend
    tet_window_perm: Optional[jax.Array] = None  # (T,) i32 window slot ->
    #                                              original tet id (windows
    #                                              block a min-endpoint-
    #                                              sorted copy of tets)
    num_tet_colors: int = 0       # static

    @property
    def n_edges(self) -> int:
        return self.edges.shape[0]

    @property
    def n_hinges(self) -> int:
        return self.hinges.shape[0]

    @property
    def n_tets(self) -> int:
        return 0 if self.tets is None else self.tets.shape[0]

    def replace(self, **kw) -> "Topology":
        return dataclasses.replace(self, **kw)


_register(
    Topology,
    data_fields=(
        "edges",
        "rest_lengths",
        "compliance",
        "colors",
        "col_edge_ids",
        "col_valid",
        "hinges",
        "rest_angles",
        "bend_compliance",
        "bend_colors",
        "bcol_hinge_ids",
        "bcol_valid",
        "triangles",
        "rest_volume",
        "degree",
        "bend_degree",
        "incidence",
        "bend_incidence",
        "windows",
        "bend_windows",
        "tets",
        "rest_tet_volumes",
        "tet_compliance",
        "tcol_tet_ids",
        "tcol_valid",
        "tet_degree",
        "tet_incidence",
        "tet_windows",
        "tet_window_perm",
    ),
    meta_fields=("num_colors", "num_bend_colors", "n_particles",
                 "num_tet_colors"),
)


def make_state(
    positions,
    inv_mass=None,
    velocities=None,
    n_edges: Optional[int] = None,
    n_hinges: int = 0,
    n_tets: int = 0,
    mass: float = 1.0,
    dtype=jnp.float32,
) -> SimState:
    """Construct an initial SimState.

    ``mass`` mirrors particle construction ``SoftBodyParticleCPU.cs:14-23``:
    uniform particle mass, inv_mass = 1/mass, with mass <= 1e-4 meaning pinned.
    """
    positions = jnp.asarray(positions, dtype=dtype)
    n = positions.shape[0]
    if velocities is None:
        velocities = jnp.zeros_like(positions)
    else:
        velocities = jnp.asarray(velocities, dtype=dtype)
    if inv_mass is None:
        inv = 0.0 if mass <= 1e-4 else 1.0 / mass
        inv_mass = jnp.full((n,), inv, dtype=dtype)
    else:
        inv_mass = jnp.asarray(inv_mass, dtype=dtype)
    if n_edges is None:
        raise ValueError("n_edges required (pass topology.n_edges)")
    return SimState(
        positions=positions,
        velocities=velocities,
        inv_mass=inv_mass,
        ext_force=jnp.zeros_like(positions),
        lambda_dist=jnp.zeros((n_edges,), dtype=dtype),
        lambda_bend=jnp.zeros((n_hinges,), dtype=dtype),
        lambda_volume=jnp.zeros((), dtype=dtype),
        lambda_tet=(jnp.zeros((n_tets,), dtype=dtype) if n_tets else None),
    )


def state_from_topology(topology: Topology, positions, **kw) -> SimState:
    return make_state(
        positions,
        n_edges=topology.n_edges,
        n_hinges=topology.n_hinges,
        n_tets=topology.n_tets,
        **kw,
    )


def is_finite(state: SimState) -> jax.Array:
    """Device-side health check: True iff every dynamic quantity is finite.

    Replaces the reference's three NaN/Inf choke points (GPU scrub
    ``XPBDSoftBody.compute:191-195``, readback scan
    ``SoftBodySimulator.cs:841-847``, init try/catch) with one reduction.
    """
    ok = jnp.isfinite(state.positions).all()
    ok &= jnp.isfinite(state.velocities).all()
    ok &= jnp.isfinite(state.lambda_dist).all()
    if state.lambda_bend.shape[0]:
        ok &= jnp.isfinite(state.lambda_bend).all()
    if state.lambda_tet is not None and state.lambda_tet.shape[0]:
        ok &= jnp.isfinite(state.lambda_tet).all()
    return ok


def snapshot(state: SimState):
    """Host-side deep copy for restart (SoftBodyGPU.cs:126-127)."""
    return jax.tree.map(lambda x: np.asarray(x).copy(), state)


def restore(state_like: SimState) -> SimState:
    """Re-upload a (possibly host) snapshot; zero the multipliers
    (RestartSimulation, SoftBodyGPU.cs:188-212)."""
    dev = jax.tree.map(jnp.asarray, state_like)
    return dev.replace(
        lambda_dist=jnp.zeros_like(dev.lambda_dist),
        lambda_bend=jnp.zeros_like(dev.lambda_bend),
        lambda_volume=jnp.zeros_like(dev.lambda_volume),
        lambda_tet=(None if dev.lambda_tet is None
                    else jnp.zeros_like(dev.lambda_tet)),
        ext_force=jnp.zeros_like(dev.ext_force),
    )
