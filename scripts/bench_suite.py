"""Extended benchmark suite (beyond the single-line bench.py).

Runs the workload families on the XLA engines and prints a table plus one
JSON list of rows, each naming the device.  Calls are synchronised with
``jax.block_until_ready``; each row is the best of ``repeats`` calls after
two compile/warm-up calls.  Rows sharing a ``pair`` are A/B'd in this
process on the same workload.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from softbodysimulation_tpu import (  # noqa: E402
    FloorMode,
    LambdaMode,
    SolveMode,
    SolverConfig,
    state_from_topology,
)
from softbodysimulation_tpu.parallel import batch as pbatch  # noqa: E402
from softbodysimulation_tpu.solvers import general, lattice as lat  # noqa: E402
from softbodysimulation_tpu.topology import build, lattice, mesh  # noqa: E402
from softbodysimulation_tpu.core.scenes import BUNNY_PATHS  # noqa: E402
from softbodysimulation_tpu.topology.objloader import load_obj  # noqa: E402

RESULTS = []


def measure(name, fn, state, particles, work_per_call, repeats=4,
            pair=None, note=None):
    """Best of ``repeats`` calls, each waited for on the device.

    ``pair`` groups A/B rows measured in this process on the same
    workload: each later row carries its speedup over the pair's first.
    ``note`` travels with the row as a methodology caveat."""
    out = jax.block_until_ready(fn(state))   # compile
    out = jax.block_until_ready(fn(out))     # out->in layout variant too
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(out))
        best = min(best, time.perf_counter() - t0)
    p = np.asarray(out.positions)  # health check only; not timed
    ps = particles * work_per_call / best
    finite = bool(np.isfinite(p).all())
    row = {"workload": name, "particle_substeps_per_sec": ps,
           "particles": particles, "finite": finite,
           "device": jax.devices()[0].device_kind}
    if note is not None:
        row["note"] = note
    if pair is not None:
        row["pair"] = pair
        prev = [r for r in RESULTS if r.get("pair") == pair]
        if prev:
            row["speedup_vs_first_in_pair"] = ps / prev[0][
                "particle_substeps_per_sec"]
    RESULTS.append(row)
    extra = (f"  [{pair} x{row.get('speedup_vs_first_in_pair', 1):.2f}]"
             if pair and "speedup_vs_first_in_pair" in row else "")
    print(f"{name:42s} {ps:.3e} ps/s  finite={finite}{extra}", flush=True)


def main():
    print(f"backend: {jax.default_backend()} {jax.devices()}", flush=True)

    # 1. 64k lattice
    spec = lattice.lattice_spec(40, braced=True)
    cfg = SolverConfig(substeps=8, iterations=1, damping=0.02,
                       solve_mode=SolveMode.JACOBI,
                       lambda_mode=LambdaMode.RESET,
                       gravity_is_acceleration=True, fast_math=True,
                       ground_height=0.0, friction=0.3)
    st = lat.make_lattice_state(spec, center=(0, 0.6, 0), mass=0.001)
    L = 2000
    fn = lat.make_substep_runner(spec, cfg, 1 / 480, L)
    measure("lattice 64k (xla stencil)", fn, st, spec.n_particles, L,
            pair="lattice64k")
    # 1b. faithful flagship mode at 64k: the reference scene's semantics
    # (COLORED family-parity GS, DECAY 0.99, VELOCITY_REFLECT floor,
    # 9 iterations, 7-family lattice, full epsilon guards) scaled to res 40
    # (Scenes/SoftBodySimulator.unity:1068-1078 x SoftBodySettings ranges)
    spec_f = lattice.lattice_spec(40, braced=False)
    cfg_f = SolverConfig(substeps=4, iterations=9, damping=0.01,
                         solve_mode=SolveMode.COLORED,
                         lambda_mode=LambdaMode.DECAY, lambda_decay=0.99,
                         floor_mode=FloorMode.VELOCITY_REFLECT,
                         gravity_is_acceleration=True,
                         ground_height=0.0, fast_math=False)
    st_f = lat.make_lattice_state(spec_f, center=(0, 0.6, 0), mass=0.001)
    Lf = 200
    fn_f = lat.make_substep_runner(spec_f, cfg_f, 1 / 240, Lf)
    measure("lattice 64k FAITHFUL flagship (colored+decay+reflect x9it)",
            fn_f, st_f, spec_f.n_particles, Lf, pair="faithful")
    # 1c. WARM_START high-throughput mode (stable in the near-rigid regime
    # via warm_start_fraction)
    cfg_w = SolverConfig(substeps=8, iterations=1, damping=0.02,
                         solve_mode=SolveMode.JACOBI,
                         lambda_mode=LambdaMode.WARM_START, lambda_decay=1.0,
                         gravity_is_acceleration=True, fast_math=True,
                         ground_height=0.0, friction=0.3)
    fn_w = lat.make_substep_runner(spec, cfg_w, 1 / 480, L)
    measure("lattice 64k (xla stencil, WARM_START)", fn_w, st,
            spec.n_particles, L)

    # 2. bunny mesh — general engine (gather/segment-sum), jacobi
    p = next((q for q in BUNNY_PATHS if os.path.exists(q)), None)
    m = load_obj(p) if p else mesh.icosphere(4, radius=0.5)
    pos, topo = build.topology_from_mesh(m, compliance=1e-6)
    pos = pos + np.array([0, 1.0, 0], np.float32)
    cfgm = SolverConfig(substeps=4, iterations=4, damping=0.02,
                        solve_mode=SolveMode.JACOBI,
                        gravity_is_acceleration=True,
                        ground_height=0.0, friction=0.3)
    stm = state_from_topology(topo, pos)
    steps = 50
    fnm = general.make_step(topo, cfgm, 1 / 60, n_steps=steps)
    measure(f"bunny mesh {topo.n_particles}p/{topo.n_edges}e (gather)",
            fnm, stm, topo.n_particles, steps * cfgm.substeps,
            pair="bunny")

    # 2b. bunny — windowed one-hot backend (RCM + block matmuls)
    pos_w, topo_w = build.topology_from_mesh(
        m, compliance=1e-6, windowed=True, block_edges=256, seg_align=32,
        window_dtype="bf16")
    stw = state_from_topology(
        topo_w, pos_w + np.array([0, 1.0, 0], np.float32))
    import dataclasses as _dc

    cfgw = _dc.replace(cfgm, distance_backend="windowed")
    fnw = general.make_step(topo_w, cfgw, 1 / 60, n_steps=steps)
    measure(f"bunny mesh {topo_w.n_particles}p (windowed one-hot)",
            fnw, stw, topo_w.n_particles, steps * cfgm.substeps,
            pair="bunny")

    # 2b''. FAITHFUL COLORED bunny (CpuMesh.unity knobs: 15 iterations,
    # compliance 1e-10, lambda clamp 1e-3): color-major exact parallel GS
    pos_c, topo_c = build.topology_from_mesh(
        m, compliance=1e-10, bending=False, windowed="colored")
    stc = state_from_topology(
        topo_c, pos_c + np.array([0, 1.0, 0], np.float32))
    cfgc = SolverConfig(substeps=1, iterations=15, damping=0.01,
                        gravity=(0.0, -1.0, 0.0),
                        solve_mode=SolveMode.COLORED, max_dlambda=1e-3,
                        ground_height=0.0, friction=0.1)
    steps_c = 50
    fnc = general.make_step(topo_c, cfgc, 0.02, n_steps=steps_c)
    measure(f"bunny FAITHFUL colored {topo_c.n_particles}p x15it",
            fnc, stc, topo_c.n_particles, steps_c, pair="bunny_colored")

    # 2b'''. COLORED bunny WITH bending (the full SoftBodyCPU.cs constraint
    # set under sequential-GS-equal semantics)
    pos_cb, topo_cb = build.topology_from_mesh(
        m, compliance=1e-10, bending=True, bend_compliance=1e-4,
        windowed="colored")
    stcb = state_from_topology(
        topo_cb, pos_cb + np.array([0, 1.0, 0], np.float32))
    cfgcb = SolverConfig(substeps=1, iterations=15, damping=0.01,
                         gravity=(0.0, -1.0, 0.0),
                         solve_mode=SolveMode.COLORED,
                         enable_bending=True, max_dlambda=1e-3,
                         ground_height=0.0, friction=0.1)
    steps_cb = 25
    fncb = general.make_step(topo_cb, cfgcb, 0.02, n_steps=steps_cb)
    measure("bunny colored+bending x15it", fncb, stcb, topo_cb.n_particles,
            steps_cb, pair="bunny_colored_bend")

    # 2c. bunny ensembles under vmap (the one-hot matrices are shared
    # across the batch)
    rngb = np.random.RandomState(1)
    offs_b = np.stack([rngb.uniform(-4, 4, 64), rngb.uniform(0, 2, 64),
                       rngb.uniform(-4, 4, 64)], 1).astype(np.float32)
    stepsb = 20
    for nb, cfg_e, pair in ((64, cfgm, None), (32, cfgw, "bunny_farm")):
        farm = jax.tree.map(lambda x: jnp.broadcast_to(x, (nb,) + x.shape),
                            stw)
        farm = farm.replace(positions=farm.positions + offs_b[:nb, None, :])
        fnwb = jax.jit(jax.vmap(
            lambda s, c=cfg_e: general.multi_step_fn(s, topo_w, c, 1 / 60,
                                                     stepsb)))
        measure(f"bunny farm x{nb} (windowed topology, vmap)", fnwb, farm,
                nb * topo_w.n_particles, stepsb * cfg_e.substeps, pair=pair)

    # 2d. per-tet volume family: solid jelly cube, general engine
    from softbodysimulation_tpu.topology import tets as _tets

    res_t = 12
    pos_t0 = lattice.lattice_points(res_t) + np.array([0, 1.0, 0])
    tt = _tets.fix_orientation(pos_t0, _tets.cube_lattice_tets(res_t))
    pos_t, topo_t = build.build_windowed_topology(
        pos_t0, _tets.tet_edges(tt), 1e-4, tets=tt, tet_compliance=0.0,
        triangles=_tets.boundary_faces(tt))
    cfg_t = SolverConfig(substeps=4, iterations=4, damping=0.02,
                         solve_mode=SolveMode.JACOBI,
                         enable_tet_volume=True,
                         distance_backend="windowed",
                         ground_height=0.0, friction=0.3)
    st_t = state_from_topology(topo_t, pos_t)
    steps_t = 50
    fn_t = general.make_step(topo_t, cfg_t, 1 / 60, n_steps=steps_t)
    measure(f"tet cube {topo_t.n_particles}p/{topo_t.n_tets}t", fn_t, st_t,
            topo_t.n_particles, steps_t * cfg_t.substeps, pair="tets")

    # COLORED twin: exact-GS tet sweeps
    pos_tc, topo_tc = build.build_windowed_topology(
        pos_t0, _tets.tet_edges(tt), 1e-4, tets=tt, tet_compliance=0.0,
        triangles=_tets.boundary_faces(tt), colored=True)
    cfg_tc = cfg_t.replace(solve_mode=SolveMode.COLORED,
                           distance_backend="auto")
    st_tc = state_from_topology(topo_tc, pos_tc)
    fn_tc = general.make_step(topo_tc, cfg_tc, 1 / 60, n_steps=steps_t)
    measure("tet cube COLORED (color-major GS)", fn_tc, st_tc,
            topo_tc.n_particles, steps_t * cfg_tc.substeps,
            pair="tets_colored")

    # 2e. solid 64k lattice: per-cell tet family on the stencil engine
    cfg_sl = cfg.replace(enable_tet_volume=True)
    st_sl = lat.make_lattice_state(spec, center=(0, 0.55, 0), mass=0.001,
                                   tet_volume=True)
    Lsl = 400
    fn_sl = lat.make_substep_runner(spec, cfg_sl, 1 / 480, Lsl)
    measure("solid 64k lattice, 356k tets (stencil)", fn_sl, st_sl,
            spec.n_particles, Lsl, pair="solid64k")

    # 3. 1024-body ensemble, res-4 braced lattices: vmap vs lane-folded
    spec4 = lattice.lattice_spec(4, braced=True)
    cfg4 = SolverConfig(substeps=4, iterations=1, damping=0.02,
                        solve_mode=SolveMode.JACOBI,
                        lambda_mode=LambdaMode.RESET,
                        gravity_is_acceleration=True,
                        ground_height=0.0, friction=0.3)
    base = lat.make_lattice_state(spec4, center=(0, 1.0, 0))
    batched = pbatch.replicate_state(base, 1024)
    rng = np.random.RandomState(0)
    offs = np.stack([rng.uniform(-8, 8, 1024), rng.uniform(0, 2, 1024),
                     rng.uniform(-8, 8, 1024)], 1).astype(np.float32)
    batched = batched.replace(positions=batched.positions + offs[:, None, :])
    steps = 500
    fnb = pbatch.make_batched_lattice_step(spec4, cfg4, 1 / 60,
                                           n_steps=steps)
    measure("ensemble 1024 x 64p (vmap)", fnb, batched,
            1024 * spec4.n_particles, steps * cfg4.substeps,
            pair="ensemble64p")
    fnw4 = lat.make_batched_step(spec4, cfg4, 1 / 60, 1024, n_steps=steps)
    measure("ensemble 1024 x 64p (lane-folded)", fnw4, batched,
            1024 * spec4.n_particles, steps * cfg4.substeps,
            pair="ensemble64p")

    # 4. self-collision spatial hash: two res-8 braced cubes interpenetrating
    res = 8
    n1 = res ** 3
    pa = lattice.lattice_points(res, center=(0, 0.8, 0))
    pb = lattice.lattice_points(res, center=(0.1, 2.0, 0.05))
    pos2 = np.concatenate([pa, pb])
    e, c = lattice.lattice_edges(res, braced=True)
    edges2 = np.concatenate([e, e + n1])
    comp2 = np.concatenate([c, c])
    topo2 = build.build_topology(pos2, edges2, comp2, color=False)
    spacing = 1.0 / (res - 1)
    cfg2 = SolverConfig(substeps=4, iterations=2, damping=0.03,
                        solve_mode=SolveMode.JACOBI,
                        gravity_is_acceleration=True,
                        enable_self_collision=True,
                        particle_radius=0.45 * spacing, hash_grid_dim=32,
                        ground_height=0.0, friction=0.3)
    st2 = state_from_topology(topo2, pos2)
    steps = 20
    fn2 = general.make_step(topo2, cfg2, 1 / 60, n_steps=steps)
    measure(f"self-collision 2x{n1}p (spatial hash)", fn2, st2,
            2 * n1, steps * cfg2.substeps)

    # 4b. sorted-window backend at 8k particles (the scale path)
    res_s = 16
    n_s = res_s ** 3
    pa_s = lattice.lattice_points(res_s, center=(0, 0.8, 0))
    pb_s = lattice.lattice_points(res_s, center=(0.1, 2.0, 0.05))
    pos_s = np.concatenate([pa_s, pb_s])
    e_s, c_s = lattice.lattice_edges(res_s, braced=True)
    edges_s = np.concatenate([e_s, e_s + n_s])
    comp_s = np.concatenate([c_s, c_s])
    topo_s = build.build_topology(pos_s, edges_s, comp_s, color=False)
    spacing_s = 1.0 / (res_s - 1)
    cfg_s = SolverConfig(substeps=4, iterations=2, damping=0.03,
                         solve_mode=SolveMode.JACOBI,
                         gravity_is_acceleration=True,
                         enable_self_collision=True,
                         self_collision_backend="sorted", sorted_window=16,
                         particle_radius=0.45 * spacing_s,
                         ground_height=0.0, friction=0.3)
    st_s = state_from_topology(topo_s, pos_s)
    steps_s = 40
    fn_s = general.make_step(topo_s, cfg_s, 1 / 60, n_steps=steps_s)
    measure(f"self-collision 2x{n_s}p (sorted window)", fn_s, st_s,
            2 * n_s, steps_s * cfg_s.substeps)

    # 4c. dense EXACT all-pairs backend at the same 8k-particle scene
    cfg_d = cfg_s.replace(self_collision_backend="dense",
                          dense_row_block=256)
    st_d = state_from_topology(topo_s, pos_s)
    fn_d = general.make_step(topo_s, cfg_d, 1 / 60, n_steps=steps_s)
    measure(f"self-collision 2x{n_s}p (dense, exact)", fn_d, st_d,
            2 * n_s, steps_s * cfg_d.substeps)

    # 4d. blocked EXACT backend at 64k particles (two res-32 bodies):
    # AABB-culled Morton blocks x dense slabs — the exact scale path
    res_b = 32
    n_b = res_b ** 3
    pa_b = lattice.lattice_points(res_b, center=(0, 0.8, 0))
    pb_b = lattice.lattice_points(res_b, center=(0.1, 2.0, 0.05))
    pos_b = np.concatenate([pa_b, pb_b])
    e_b, c_b = lattice.lattice_edges(res_b, braced=True)
    topo_b = build.build_topology(
        pos_b, np.concatenate([e_b, e_b + n_b]),
        np.concatenate([c_b, c_b]), color=False)
    spacing_b = 1.0 / (res_b - 1)
    cfg_b = SolverConfig(substeps=4, iterations=2, damping=0.03,
                         solve_mode=SolveMode.JACOBI,
                         gravity_is_acceleration=True,
                         enable_self_collision=True,
                         self_collision_backend="blocked",
                         collision_block_size=256, block_neighbors=12,
                         particle_radius=0.45 * spacing_b,
                         ground_height=0.0, friction=0.3)
    st_b = state_from_topology(topo_b, pos_b)
    steps_b = 20
    fn_b2 = general.make_step(topo_b, cfg_b, 1 / 60, n_steps=steps_b)
    measure(f"self-collision 2x{n_b}p (blocked, exact)", fn_b2, st_b,
            2 * n_b, steps_b * cfg_b.substeps, pair="contact64k")
    cfg_bs = cfg_b.replace(self_collision_backend="sorted", sorted_window=16)
    fn_bs = general.make_step(topo_b, cfg_bs, 1 / 60, n_steps=steps_b)
    measure(f"self-collision 2x{n_b}p (sorted window, approximate)", fn_bs,
            st_b, 2 * n_b, steps_b * cfg_bs.substeps, pair="contact64k")

    # 4f. contact cadence on the stencil engine: ONE 64k braced lattice
    # with exact blocked contact, every=1 vs every=8 (the classic
    # once-per-frame PBD split)
    res_l = 40
    spec_l = lattice.lattice_spec(res_l, braced=True)
    spacing_l = 1.0 / (res_l - 1)
    base_l = dict(substeps=8, iterations=1, damping=0.02,
                  solve_mode=SolveMode.JACOBI,
                  lambda_mode=LambdaMode.RESET,
                  gravity_is_acceleration=True, fast_math=True,
                  enable_self_collision=True,
                  particle_radius=0.55 * spacing_l,
                  self_collision_backend="blocked",
                  collision_block_size=256, block_neighbors=8,
                  ground_height=0.0, friction=0.3)
    st_l = lat.make_lattice_state(spec_l, center=(0.0, 0.55, 0.0),
                                  mass=0.001)
    sub_per_call = 400
    for every in (1, 8):
        cfg_l = SolverConfig(self_collision_every=every, **base_l)
        fn_l = lat.make_substep_runner(spec_l, cfg_l, 1 / 480.,
                                       sub_per_call)
        measure(f"contact 64k stencil blocked (cadence every={every})",
                fn_l, st_l, spec_l.n_particles, sub_per_call,
                pair="contact_cadence64k")

    print(json.dumps(RESULTS), flush=True)


if __name__ == "__main__":
    main()
