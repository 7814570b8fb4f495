"""Regression tests for the round-2 review findings:

1. the blocked self-collision backend's exactness precondition is surfaced
   through a production diagnostics entry point (``diag.diagnostics
   .blocked_overflow``) instead of living only as an un-invoked op helper.

(2: bench.py health gates are explicit raises — covered by
tests/test_bench_contract.py; 3: dense-backend boundary caveat is a
docstring note.)
"""

import numpy as np

from softbodysimulation_tpu import SolverConfig, state_from_topology
from softbodysimulation_tpu.diag.diagnostics import blocked_overflow
from softbodysimulation_tpu.topology import build, lattice


def _two_body_state(sep=0.9):
    pos_a = lattice.lattice_points(4, center=(0.0, 0.5, 0.0))
    pos_b = lattice.lattice_points(4, center=(sep, 0.5, 0.0))
    pos = np.vstack([pos_a, pos_b])
    edges, comp = lattice.lattice_edges(4)
    e2 = np.vstack([edges, edges + len(pos_a)])
    c2 = np.concatenate([comp, comp])
    topo = build.build_topology(pos, e2, c2)
    return topo, state_from_topology(topo, pos)


def test_blocked_overflow_zero_when_capacity_sufficient():
    topo, st = _two_body_state()
    cfg = SolverConfig(enable_self_collision=True,
                       self_collision_backend="blocked",
                       particle_radius=0.05,
                       collision_block_size=16,
                       block_neighbors=16)
    assert blocked_overflow(st, cfg) == 0


def test_blocked_overflow_detects_dropped_blocks():
    topo, st = _two_body_state(sep=0.2)   # heavily interpenetrating
    # a huge radius makes every block AABB-touch every other; with
    # block_neighbors=1 the top-M selection must drop blocks -> overflow > 0
    cfg = SolverConfig(enable_self_collision=True,
                       self_collision_backend="blocked",
                       particle_radius=1.0,
                       collision_block_size=16,
                       block_neighbors=1)
    assert blocked_overflow(st, cfg) > 0
