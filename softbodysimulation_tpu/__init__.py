"""softbodysimulation_tpu — XPBD soft-body simulation framework in JAX.

A ground-up JAX/XLA rebuild of the capabilities of
Alpaca-Hacker/SoftBodySimulation (Unity/C#/HLSL reference): XPBD particle
dynamics with distance / dihedral-bending / volume constraints, ground-plane
and SDF collision, self-collision, graph-colored Gauss-Seidel and batched
Jacobi solvers, procedural and mesh topologies, functional interaction APIs,
on-device diagnostics and render post-processing, vmap-batched ensembles and
shard_map multi-chip scaling.
"""

from .core.config import (
    DampingMode,
    FloorMode,
    LambdaMode,
    SolveMode,
    SolverConfig,
)
from .core.colliders import (
    ColliderSet,
    colliders_from_config,
    make_colliders,
)
from .core.state import (
    SimState,
    Topology,
    is_finite,
    make_state,
    restore,
    snapshot,
    state_from_topology,
)

__version__ = "0.1.0"

__all__ = [
    "SolverConfig",
    "SolveMode",
    "LambdaMode",
    "DampingMode",
    "FloorMode",
    "SimState",
    "Topology",
    "ColliderSet",
    "make_colliders",
    "colliders_from_config",
    "make_state",
    "state_from_topology",
    "is_finite",
    "snapshot",
    "restore",
]
