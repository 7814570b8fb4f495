"""Scale multi-body contact: the ~20k-particle ``ball_on_cloth_xl`` scene
(exact ``blocked`` self-collision every 3rd substep) on the general engine.

Warms the scene into a contact-rich state, gates exactness there (the
pair-accurate ``blocked_dropped_pairs`` must read 0, i.e. coverage-
identical to the ``dense`` backend), then times ``FRAMES_PER_CALL``-frame
calls with ``jax.block_until_ready``.  Prints one JSON line per row, each
naming the device it ran on.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import numpy as np  # noqa: E402

from softbodysimulation_tpu.core.scenes import ball_on_cloth_xl  # noqa: E402
from softbodysimulation_tpu.diag.diagnostics import (  # noqa: E402
    blocked_dropped_pairs, blocked_overflow)
from softbodysimulation_tpu.solvers import general  # noqa: E402

FRAMES_PER_CALL = int(os.environ.get("BENCH_FRAMES_PER_CALL", "30"))


def emit(**kw):
    print(json.dumps(kw), flush=True)


def main():
    dev = jax.devices()[0]
    state, _, info = ball_on_cloth_xl()
    topo, cfg, dt = info["topology"], info["config"], info["dt"]
    n = topo.n_particles
    emit(row="env", platform=dev.platform, device_kind=dev.device_kind,
         n=n, e=topo.n_edges, tets=int(topo.n_tets),
         cadence=cfg.self_collision_every,
         contact_backend=cfg.self_collision_backend,
         frames_per_call=FRAMES_PER_CALL)

    # warm to a contact-rich state; gate exactness there.  The AABB
    # worst-touch bound is reported alongside: flat cloth sheets exceed it
    # vacuously (blocks touch in the thin axis with every pair beyond 2r).
    warm = general.make_step(topo, cfg, dt, n_steps=30)(state)
    dropped = blocked_dropped_pairs(warm, cfg)
    emit(row="warm", aabb_overflow_blocks=blocked_overflow(warm, cfg),
         dropped_pairs=dropped,
         finite=bool(np.isfinite(np.asarray(warm.positions)).all()))
    if dropped:
        raise RuntimeError("blocked backend dropped real pairs — raise "
                           "block_neighbors")

    fn = general.make_step(topo, cfg, dt, n_steps=FRAMES_PER_CALL)
    out = jax.block_until_ready(fn(warm))           # compile
    best = float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(out))
        best = min(best, time.perf_counter() - t0)
    p = np.asarray(out.positions)
    emit(row="general_blocked_cadence",
         particle_substeps_per_s=n * FRAMES_PER_CALL * cfg.substeps / best,
         finite=bool(np.isfinite(p).all()),
         dropped_pairs=blocked_dropped_pairs(out, cfg),
         ymin=float(p[:, 1].min()), ymax=float(p[:, 1].max()))


if __name__ == "__main__":
    main()
