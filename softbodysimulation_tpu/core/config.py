"""Solver configuration.

A JAX reimagining of the reference's three config tiers
(``SoftBodySettings.cs:5-47``, per-component inspector fields e.g.
``SoftBodyGPU.cs:42-71`` / ``SoftBodyCPU.cs:12-39``, and ``SOs/SoftBodyPreset.cs``):
a single frozen dataclass that is hashable, so it can be passed to ``jax.jit``
as a static argument — every knob is a compile-time constant and XLA folds it
into the compiled substep program.  No reflection, no mutation.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Tuple


class LambdaMode(enum.Enum):
    """How accumulated Lagrange multipliers are treated across steps.

    RESET  — zeroed at the start of every physics step / substep
             (CPU solvers: ``SoftBodyCPU.cs:283-290``; substep GPU engine
             zeroes its lagrange buffer per substep, ``SoftBodyGPU.cs:240``).
    DECAY  — multiplied by ``lambda_decay`` at substep start and persisted
             across steps (flagship engine: ``XPBDSoftBody.compute:200-207``,
             host loop ``SoftBodySimulator.cs:582``).  NB: faithful to the
             reference including its flaw — carried lambda enters the XPBD
             feedback term as if already applied this substep, so constraints
             WEAKEN under sustained load.  Use WARM_START for the corrected
             behavior.
    WARM_START — carried lambda (times ``lambda_decay``) is PRE-APPLIED as a
             position impulse at substep start, then iterations refine it.
             Consistent XPBD warm starting: near-converged stiffness with as
             little as 1 iteration per substep (the high-throughput regime).
    """

    RESET = "reset"
    DECAY = "decay"
    WARM_START = "warm_start"


class DampingMode(enum.Enum):
    """PER_STEP — v *= (1 - damping) each substep (``SoftBodyCPU.cs:299``).
    PER_DT   — v *= (1 - damping * dt) (flagship ``XPBDSoftBody.compute:95``)."""

    PER_STEP = "per_step"
    PER_DT = "per_dt"


class FloorMode(enum.Enum):
    """NONE            — no ground plane.
    XPBD_INEQUALITY — position-level inequality constraint with position-level
                      tangential friction (``SoftBodyCPU.cs:352-400``).
    VELOCITY_REFLECT— projection + restitution + penetration-proportional
                      velocity kick + velocity-level friction (flagship
                      ``XPBDSoftBody.compute:272-316``)."""

    NONE = "none"
    XPBD_INEQUALITY = "xpbd_inequality"
    VELOCITY_REFLECT = "velocity_reflect"


class SolveMode(enum.Enum):
    """JACOBI  — all constraints projected simultaneously, corrections merged by
                 segment-sum with under-relaxation ``omega`` (the data-parallel
                 replacement for the racy free-for-all of
                 ``XPBDSimulatorCS.compute:128-182``).
    COLORED — exact parallel Gauss-Seidel: constraints pre-partitioned into
              conflict-free color groups (reference semantics:
              ``XPBDSoftBody.compute:115`` + host loop
              ``SoftBodySimulator.cs:600-609``); within a color no particle is
              shared, so the batched update is bit-identical to a sequential
              sweep."""

    JACOBI = "jacobi"
    COLORED = "colored"


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Every physical/solver knob of the reference, unified.

    Mirrors the union of ``SoftBodySettings.cs:5-47``, ``SoftBodyCPU.cs:12-39``
    and ``SoftBodyGPU.cs:42-71``.  Frozen + hashable => usable as a jit-static.
    """

    # --- time stepping ---
    substeps: int = 1                 # SoftBodyGPU.cs:44 (1..200); flagship <=4
    iterations: int = 10              # solverIterations (SoftBodyCPU.cs:13)

    # --- integration ---
    gravity: Tuple[float, float, float] = (0.0, -9.81, 0.0)
    # The reference adds gravity as a FORCE (AddForce(gravity),
    # SoftBodyCPU.cs:297; flagship kernel likewise), so acceleration scales
    # with inverse mass — fine at unit mass, surprising otherwise.  True
    # applies `gravity` as an acceleration (mass-independent, the physical
    # convention); False keeps reference-faithful force semantics.
    gravity_is_acceleration: bool = False
    damping: float = 0.01
    damping_mode: DampingMode = DampingMode.PER_STEP
    max_velocity: float = 0.0         # 0 disables; XPBDSimulatorCS.compute:83 uses 20
    max_force: float = 0.0            # 0 disables; XPBDSimulatorCS.compute:91 uses 100
    world_bounds: float = 0.0         # 0 disables; XPBDSimulatorCS.compute:64 uses 1000

    # --- constraint solve ---
    solve_mode: SolveMode = SolveMode.JACOBI
    omega: float = 0.0                # scale on the 1/max-conflict-degree
                                      # -averaged Jacobi update, SAME meaning
                                      # in every engine (general: full graph
                                      # degree; stencil engines: intra-family
                                      # degree 2); 0 => 1.0 (GS-matched)
    distance_backend: str = "auto"    # JACOBI distance-sweep mechanics:
                                      # "auto" = windowed one-hot matmuls
                                      # when the topology carries windows,
                                      # else gather/incidence; "gather" /
                                      # "windowed" force one (same
                                      # arithmetic, different execution)
    bending_backend: str = "auto"     # JACOBI bending-sweep mechanics, same
                                      # contract as distance_backend ("auto"
                                      # = windowed signed one-hots when the
                                      # topology carries bend_windows)
    tet_backend: str = "gather"       # JACOBI tet-volume-sweep mechanics:
                                      # "gather" (tet_incidence walks; the
                                      # default) or
                                      # "windowed" (4-endpoint signed
                                      # one-hot matmul sweep; requires
                                      # topology tet_windows, fp-reordered
                                      # vs gather)
    # Chebyshev semi-iterative acceleration of the Jacobi iterations
    # (classic accelerated-PBD recurrence); rho = spectral-radius estimate,
    # 0 disables.  gamma under-relaxes the inner update for contact safety.
    jacobi_rho: float = 0.9
    jacobi_gamma: float = 1.0
    jacobi_cheby_delay: int = 2       # plain iterations before accelerating
    lambda_mode: LambdaMode = LambdaMode.RESET
    lambda_decay: float = 0.99        # SoftBodySettings.cs:20-21 (used when DECAY)
    max_dlambda: float = 0.0          # abs clamp on delta-lambda; 0 disables
                                      # (CPUDistanceConstraint.cs:98 uses 1e-3)
    max_dlambda_rel: float = 0.0      # clamp = rel * rest_length; 0 disables
                                      # (XPBDSoftBody.compute:153 uses 0.1)
    lambda_clamp: float = 0.0         # abs clamp on accumulated lambda; 0 disables
                                      # (XPBDSoftBody.compute:160 uses 100)
    # WARM_START safety: the carried impulse is clamped so its position
    # correction can never exceed this fraction of the edge rest length per
    # substep.  Without it, light particles (large inv_mass) amplify
    # transient lambda noise into positional explosions at contacts.
    warm_start_clamp: float = 0.5
    # SOR-style under-relaxation of the warm-start pre-application: the
    # carried multiplier is scaled by this fraction before being applied
    # (feedback-consistent — the carried lambda is scaled identically).
    # Full-strength pre-application (1.0) oscillates violently in the
    # near-rigid regime (alpha~ << sum w: measured maxvel 110 at rest for
    # mass=0.001); 0.5 is stable there and still halves the residual the
    # iterations must close.  Scanned empirically; see tests.
    warm_start_fraction: float = 0.5
    min_alpha_tilde: float = 0.0      # floor on alpha~; XPBDSoftBody.compute:139 uses 1e-10

    # --- bending (dihedral) ---
    enable_bending: bool = False
    bend_soften_sin_eps: float = 0.01   # CPUBendingConstraint.cs:92 stability band
    bend_skip_sin_eps: float = 1e-5     # CPUBendingConstraint.cs:93 hard skip
    bend_soften_factor: float = 100.0   # CPUBendingConstraint.cs:105

    # --- volume / pressure (BASELINE config 3; seeded by the unused
    #     CalculateVolume helper XPBDSimulatorCS.compute:220-223 and the
    #     commented AddVolumeConstraints SoftBodySimulator.cs:187-212) ---
    enable_volume: bool = False
    volume_compliance: float = 0.0
    pressure: float = 1.0             # target volume multiplier (>1 inflates)
    # Per-tetrahedron volume family (solid bodies; topology/tets.py +
    # ops/tet_volume.py — the wired-up version of the reference's
    # CalculateVolume tet helper, XPBDSimulatorCS.compute:220-223, and the
    # commented AddVolumeConstraints, SoftBodySimulator.cs:187-212).
    # Per-tet compliance lives on the Topology (like edge compliance).
    enable_tet_volume: bool = False
    tet_pressure: float = 1.0         # per-tet target volume multiplier
    # Per-tet compliance for the STENCIL lattice engine's per-cell tet
    # family (one scalar — the lattice's tets are congruent); the general
    # engine carries per-tet compliances on the Topology instead (the
    # builders' tet_compliance argument).  0 = incompressible.
    tet_compliance: float = 0.0

    # --- collisions ---
    floor_mode: FloorMode = FloorMode.XPBD_INEQUALITY
    ground_height: float = 0.0        # SoftBodyCPU.cs:31
    collision_compliance: float = 0.0 # SoftBodyCPU.cs:32
    friction: float = 0.1             # SoftBodyCPU.cs:33
    restitution: float = 0.1          # XPBDSoftBody.compute:294
    floor_offset: float = 0.0         # XPBDSoftBody.compute:288 uses 1e-3
    penetration_kick: float = 10.0    # XPBDSoftBody.compute:295
    normal_force_scale: float = 100.0 # XPBDSoftBody.compute:298
    floor_friction_coeff: float = 0.5 # XPBDSoftBody.compute:299

    # sphere SDF colliders: static scene spheres; count fixed at trace time.
    # Each entry: (cx, cy, cz, radius). Friction shared with `friction`.
    sphere_colliders: Tuple[Tuple[float, float, float, float], ...] = ()
    # axis-aligned box SDF colliders: (cx, cy, cz, hx, hy, hz) half-extents.
    # Particles are pushed out along the nearest face (inside) or clamped
    # surface normal (outside-overlap is impossible for points); friction as
    # above.  The rigid-world obstacles the reference delegated to PhysX.
    box_colliders: Tuple[Tuple[float, float, float, float, float, float],
                         ...] = ()

    # --- self-collision (BASELINE config 4; seed: SphereCollision helper
    #     XPBDSimulatorCS.compute:213-217) ---
    enable_self_collision: bool = False
    particle_radius: float = 0.05
    hash_grid_dim: int = 32           # cells per axis of the bounded hash grid
    hash_cell_capacity: int = 8       # max particles examined per cell
    self_collision_omega: float = 0.5
    # "hash": exact 27-cell spatial hash, re-searched every projection
    # (an (N,27,K) candidate gather per pass).
    # "sorted": Morton-order sliding window — particles sorted once per
    # substep along a Z-order curve, each checked against its 2*W sorted
    # neighbors with pure dense shifted ops (no gathers in the hot loop).
    # Approximate: pairs adjacent in space but split across a Morton
    # boundary beyond the window are missed for that substep (caught as
    # codes change); the scale path for big self-colliding scenes.
    # "dense": EXACT all-pairs contact as two matmuls per row block
    # (dist^2 Gram trick + correction-sum matmul) — zero gathers, zero
    # capacity caveats; O(N^2) dense flops, for small to mid-size N
    # (ops/spatial_hash.self_collision_project_dense).
    # "blocked": EXACT at scale — Morton-sort into fixed blocks, AABB
    # block-pair culling, top-M neighbor blocks per block, then the dense
    # matmul formulation per (block x M*block) candidate slab.  O(N*M*B)
    # flops; exact whenever <= block_neighbors blocks overlap any block's
    # reach (overflow is detectable via self_collision_blocked_overflow).
    self_collision_backend: str = "hash"
    # Contact cadence: run the self-collision detect+project pass only on
    # substeps whose index is a multiple of this (the classic PBD split —
    # collision handling once per frame, constraint iterations every
    # substep).  1 (default) = every substep, exact current semantics.
    # K>1 trades contact latency (penetration may persist for up to K-1
    # substeps before the next pass corrects it) for throughput: the
    # contact pass is the dominant cost of self-colliding scenes, so
    # K=substeps recovers most of the contact-free engine rate.  Floor and
    # SDF colliders are NOT affected (they are cheap and skipping them
    # tunnels).  Distance/bending/volume constraints run every substep.
    self_collision_every: int = 1
    sorted_window: int = 16           # one-sided neighbor window ("sorted")
    dense_row_block: int = 256        # rows per lax.scan block ("dense")
    collision_block_size: int = 256   # particles per Morton block ("blocked")
    block_neighbors: int = 8          # candidate blocks per block ("blocked")

    # --- numerical guards ---
    eps_length: float = 1e-5          # CPUDistanceConstraint.cs:64 degenerate length
    eps_denominator: float = 1e-5     # CPUDistanceConstraint.cs:94
    static_inv_mass_eps: float = 1e-5 # CPUDistanceConstraint.cs:48 'both static'
    # fast_math drops the per-edge degenerate-geometry guards (length /
    # denominator / both-static epsilon checks) in the LATTICE engines,
    # folding the static validity+parity masks into a single multiplier.
    # Safe when edges never collapse (healthy scenes — the sqrt floor still
    # prevents NaN); fewer elementwise ops per pass.  Guards always stay on
    # in the general engine and the oracle.
    fast_math: bool = False

    def replace(self, **kw) -> "SolverConfig":
        return dataclasses.replace(self, **kw)

    @property
    def gravity3(self):
        return self.gravity

    def __post_init__(self):
        if self.distance_backend not in ("auto", "gather", "windowed"):
            raise ValueError(
                "distance_backend must be auto|gather|windowed")
        if self.tet_backend not in ("gather", "windowed"):
            raise ValueError("tet_backend must be gather|windowed")
        if self.bending_backend not in ("auto", "gather", "windowed"):
            raise ValueError(
                "bending_backend must be auto|gather|windowed")
        if self.self_collision_backend not in ("hash", "sorted", "dense",
                                               "blocked"):
            raise ValueError(
                "self_collision_backend must be hash|sorted|dense|blocked")
        if self.sorted_window < 1:
            raise ValueError("sorted_window must be >= 1")
        if self.dense_row_block < 1:
            raise ValueError("dense_row_block must be >= 1")
        if self.collision_block_size < 8:
            raise ValueError("collision_block_size must be >= 8")
        if self.block_neighbors < 1:
            raise ValueError("block_neighbors must be >= 1")
        if self.self_collision_every < 1:
            raise ValueError("self_collision_every must be >= 1")
        if self.substeps < 1:
            raise ValueError("substeps must be >= 1")
        if self.iterations < 1:
            raise ValueError("iterations must be >= 1")
        if not (0.0 <= self.damping <= 1.0):
            raise ValueError("damping must be in [0, 1]")
