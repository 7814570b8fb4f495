#!/usr/bin/env python
"""Headline benchmark: particle-substeps/sec at 64k particles, one device.

Workload: braced res-40 lattice cube (40^3 = 64,000 particles, 13 offset
families ~ 790k distance constraints, particle mass 1 g so column loads are
physical) settling on a ground plane; RESET-mode XPBD, 1 iteration x 8
substeps per 1/60 s frame (the 'small steps' regime — light particles make
the constraints effectively rigid, so one pass/family converges).

Engine: the XLA stencil engine (``solvers/lattice.make_substep_runner``),
timed with ``jax.block_until_ready``.  The run needs a GPU; set
``BENCH_PLATFORM=cpu`` for the small smoke mode the tests use.

Prints exactly one JSON line:
  {"metric": ..., "value": ..., "unit": ..., "device": {...}}
with the device as JAX reports it (platform, device_kind, count).
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402

if os.environ.get("BENCH_PLATFORM") == "cpu":
    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from softbodysimulation_tpu import (  # noqa: E402
    LambdaMode,
    SolveMode,
    SolverConfig,
)
from softbodysimulation_tpu.solvers import lattice as lat_engine  # noqa: E402
from softbodysimulation_tpu.topology import lattice  # noqa: E402

RES = int(os.environ.get("BENCH_RES", "40"))
DT = 1.0 / 60.0
SUBSTEPS = int(os.environ.get("BENCH_SUBSTEPS", "8"))
SUBSTEPS_PER_CALL = int(os.environ.get("BENCH_SUBSTEPS_PER_CALL", "2000"))
TARGET_SECONDS = float(os.environ.get("BENCH_SECONDS", "5.0"))


def build(res=RES):
    spec = lattice.lattice_spec(res, braced=True)
    cfg = SolverConfig(
        substeps=SUBSTEPS,
        iterations=1,
        damping=0.02,
        solve_mode=SolveMode.JACOBI,
        # light particles make compliance negligible vs inverse masses, so a
        # single RESET Jacobi pass already closes ~50% of C per family —
        # warm-starting is unnecessary here (and dynamically unstable in the
        # near-rigid regime; see SolverConfig.warm_start_clamp)
        lambda_mode=LambdaMode.RESET,
        gravity_is_acceleration=True,
        fast_math=True,
        ground_height=0.0,
        friction=0.3,
    )
    state = lat_engine.make_lattice_state(spec, center=(0.0, 0.6, 0.0),
                                          mass=0.001)
    return spec, cfg, state


def check_health(p):
    """The simulation must have stayed healthy or the number is void.
    Explicit raises (not assert): the gates must survive python -O."""
    if not np.isfinite(p).all():
        raise RuntimeError("non-finite state after benchmark")
    if p[:, 1].min() <= -1e-2:
        raise RuntimeError("floor violated after benchmark")
    height = p[:, 1].max() - p[:, 1].min()
    if height <= 0.5:
        raise RuntimeError(f"cube degenerated during benchmark: {height}")


def measure(step, state, n):
    calls = 0
    t0 = time.perf_counter()
    while True:
        state = jax.block_until_ready(step(state))
        calls += 1
        if time.perf_counter() - t0 >= TARGET_SECONDS:
            break
    elapsed = time.perf_counter() - t0
    check_health(np.asarray(state.positions))
    return n * calls * SUBSTEPS_PER_CALL / elapsed


def main():
    dev = jax.devices()[0]
    if dev.platform != "gpu" and os.environ.get("BENCH_PLATFORM") != "cpu":
        print(f"bench.py needs a GPU; JAX found {dev.platform!r} "
              "(BENCH_PLATFORM=cpu runs the smoke mode)", file=sys.stderr)
        return 1
    spec, cfg, state = build()
    fn = lat_engine.make_substep_runner(spec, cfg, DT / SUBSTEPS,
                                        SUBSTEPS_PER_CALL)
    warm = jax.block_until_ready(fn(state))
    value = measure(fn, warm, spec.n_particles)
    print(json.dumps({
        "metric": f"particle_substeps_per_sec_{spec.n_particles}_xla",
        "value": float(f"{value:.4g}"),
        "unit": "particle-substeps/s",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
