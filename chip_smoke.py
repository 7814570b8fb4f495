#!/usr/bin/env python
"""Main-path smoke run on the GPU: every engine path a user calls, at full
size, each checked against the repository's own reference.

    python chip_smoke.py              # one card: every phase below
    python chip_smoke.py --multichip  # four cards: the multi-device paths

Phases on one card:

  device      JAX must report a GPU; prints the card's name and power limit
  lattice64k  bench.py's workload (braced res-40 lattice, 64,000 particles,
              RESET x1, 8 substeps/frame) for 2000 substeps with bench's
              health gates, then ``lattice.make_step`` frames with a poke
  oracle      general and stencil engines vs the frozen CPU oracle, and the
              faithful COLORED+DECAY flagship config at 64k vs the general
              engine on the same constraint order
  mesh        ``stanford_bunny``: ``windowed`` vs ``gather`` over 240 frames
  solid       ``solid_lattice`` at res 40 (356k tets): volume ratio gate
  contact     64k lattice with ``blocked`` contact, the ~20k
              ``ball_on_cloth_xl`` scene, and ``dense`` vs ``blocked``
  grad        the config10 material fit and config6 launch optimisation,
              and a directional derivative against central differences
  cli         ``cli.main(["run", "flagship_perf", ...])`` in this process
  gpu-tests   ``pytest -m gpu`` in this process

Each phase prints its first-call time (compilation included), its steady
call time and its agreement numbers beside their bounds.  A failed check
raises, so any failure exits non-zero with no result line.  The last
stdout line is one JSON object:

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

With no GPU the script exits non-zero before any phase.  Compiled programs
persist in ``$JAX_COMPILATION_CACHE_DIR`` when it is set, else in
``<repo>/.jax_cache``.
"""

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

# bounds, each with its reason
ORACLE_SCENES = (("cube8", 150, 5e-5), ("lattice3", 300, 1e-3),
                 ("bending_plane", 150, 5e-5), ("clamped", 150, 5e-5))
FLAGSHIP_ORACLE_TOL = 1e-3   # the repo's headline drift budget
FAITHFUL_TOL = 1e-4          # same constraint order; f32 reassociation only
# windowed vs gather differ only by f32 reassociation: tight before the
# shell reaches the floor; once it crumples there the rounding grows
# chaotically, so after 240 frames the bound is on what stays put
MESH_EARLY_TOL = 1e-3        # max position drift after 60 frames
MESH_COM_TOL = 1e-2          # centre of mass after 240 frames
MESH_ERR_RTOL = 0.1          # mean constraint error after 240 frames
# the solid_lattice scene solves 1 Jacobi iteration per substep, which
# leaves its 40-layer column under-converged: settled, it holds 97.7% of
# its rest volume on every platform measured (tests/test_tets.py's 1% bound
# is for a res-5 body at 6 iterations)
VOLUME_TOL = 0.03
DENSE_BLOCKED_TOL = 5e-5     # Gram-trick boundary noise (test_collision)
FD_STEP, FD_TOL = 1e-3, 1e-2  # central difference in f32: O(h^2) truncation
#                               plus eps*|L|/h rounding, both << 1e-2


def compile_cache_dir(environ=os.environ) -> str:
    """The persistent compile cache: ``$JAX_COMPILATION_CACHE_DIR`` when it
    is set (JAX reads it itself), else a fixed directory in the checkout
    (the path is part of the cache key, so it must not move)."""
    return (environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(REPO, ".jax_cache"))


def log(msg: str):
    print(msg, flush=True)


def require(cond, msg: str):
    if not cond:
        raise RuntimeError(msg)


def require_gpu(jax, n: int = 1):
    """The device list, or SystemExit when JAX finds fewer than ``n``
    GPUs.  Never continues on another platform."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"chip_smoke.py needs a GPU; JAX found "
                         f"{devs[0].platform!r}")
    if len(devs) < n:
        raise SystemExit(f"chip_smoke.py needs {n} GPUs; JAX found "
                         f"{len(devs)}")
    return devs


class Phase:
    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        log(f"== {self.name}")
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            log(f"== {self.name}: ok "
                f"({time.perf_counter() - self.t0:.1f} s)")
        return False


def timed(fn, *args):
    """``(fn(*args), seconds)``, waiting for the device."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


def max_abs(a, b) -> float:
    import numpy as np

    return float(np.abs(np.asarray(a) - np.asarray(b)).max())


def _calls(name, first, steady, extra=""):
    log(f"  {name}: first call {first:.3f} s (compile included), "
        f"steady call {steady:.4f} s{extra}")


# ------------------------------------------------------------------ phases
def phase_lattice(res=40, substeps=2000, frames=4):
    import jax.numpy as jnp
    import numpy as np

    import bench
    from softbodysimulation_tpu.interact import forces
    from softbodysimulation_tpu.solvers import lattice as lat_engine

    spec, cfg, state = bench.build(res)
    n = spec.n_particles
    fn = lat_engine.make_substep_runner(spec, cfg, bench.DT / cfg.substeps,
                                        substeps)
    out, first = timed(fn, state)
    out, steady = timed(fn, out)
    p = np.asarray(out.positions)
    bench.check_health(p)
    _calls(f"substep runner, {n} particles x {substeps} substeps", first,
           steady, f" = {n * substeps / steady:.4e} particle-substeps/s; "
           f"height {p[:, 1].max() - p[:, 1].min():.4f}")

    step = lat_engine.make_step(spec, cfg, bench.DT, n_steps=frames)
    plain, first = timed(step, out)
    top = (0.0, float(p[:, 1].max()), 0.0)
    poked_in = forces.add_force(out, (0.05, 0.0, 0.0), top, 0.5)
    poked, steady = timed(step, poked_in)
    dcom = np.asarray(poked.positions.mean(0) - plain.positions.mean(0))
    ext = float(jnp.abs(poked.ext_force).max())
    _calls(f"make_step x{frames} frames", first, steady,
           f"; poke moves COM by {dcom[0]:.3e} in x; ext_force after "
           f"{ext}")
    require(dcom[0] > 1e-6, f"poke did not move the COM: {dcom}")
    require(ext == 0.0, f"ext_force not consumed: {ext}")


def phase_oracle(faithful_res=40, faithful_frames=2, flagship_frames=120,
                 oracle_scenes=ORACLE_SCENES):
    import numpy as np

    from softbodysimulation_tpu import state_from_topology
    from softbodysimulation_tpu.core import scenes
    from softbodysimulation_tpu.solvers import general, reference_cpu
    from softbodysimulation_tpu.solvers import lattice as lat_engine
    from softbodysimulation_tpu.topology import build, lattice

    sys.path.insert(0, os.path.join(REPO, "tests"))
    from test_oracle_drift import DT, make_oracle, make_scene

    for kind, steps, tol in oracle_scenes:
        pos, topo, cfg = make_scene(kind)
        state = state_from_topology(topo, pos)
        oracle = make_oracle(pos, topo, cfg, np.asarray(state.inv_mass))
        fn = general.make_step(topo, cfg, DT, n_steps=steps)
        out, first = timed(fn, state)
        for _ in range(steps):
            oracle.step(DT)
        drift = max_abs(out.positions, oracle.x)
        log(f"  general vs oracle {kind} ({steps} steps): drift "
            f"{drift:.3e} (bound {tol:g}); first call {first:.3f} s")
        require(drift < tol, f"{kind}: drift {drift} >= {tol}")

    # stencil engine vs oracle: the faithful flagship scene (res 4,
    # COLORED + DECAY, 9 iterations), poked, oracle in family-parity order
    state, _, info = scenes.flagship()
    spec, cfg, dt = info["spec"], info["config"], info["dt"]
    pos = np.asarray(state.positions)
    edges, comp = lattice.lattice_edges(spec.res)
    colors = lattice.lattice_family_colors(spec.res)
    topo = build.build_topology(pos, edges, comp, colors=colors)
    oracle = reference_cpu.ReferenceSolver(
        pos, np.asarray(topo.edges), np.asarray(topo.rest_lengths),
        np.asarray(topo.compliance), np.asarray(state.inv_mass), cfg,
        colors=np.asarray(topo.colors))
    f = np.zeros_like(pos)
    f[:8] = (20.0, 40.0, -10.0)
    state = state.replace(ext_force=state.ext_force + f)
    oracle.f += f
    fn = lat_engine.make_step(spec, cfg, dt, n_steps=flagship_frames)
    out, first = timed(fn, state)
    for _ in range(flagship_frames):
        oracle.step(dt)
    drift = max_abs(out.positions, oracle.x)
    moved = float(np.abs(oracle.x - pos).max())
    log(f"  stencil vs oracle, flagship ({flagship_frames} frames, body "
        f"moved {moved:.3f}): drift {drift:.3e} (bound "
        f"{FLAGSHIP_ORACLE_TOL:g}); first call {first:.3f} s")
    require(moved > 1e-2, "the poke did not move the flagship body")
    require(drift < FLAGSHIP_ORACLE_TOL, f"flagship drift {drift}")

    # the faithful flagship config at 64k (families x 2 parities x 9
    # iterations of dependent passes per substep on the stencil engine),
    # against the general COLORED engine on the same constraint order
    cfg_f = cfg.replace(gravity=(0.0, -9.81, 0.0),
                        gravity_is_acceleration=True, ground_height=0.0)
    spec_f = lattice.lattice_spec(faithful_res)
    st_f = lat_engine.make_lattice_state(spec_f, center=(0, 0.6, 0),
                                         mass=0.001)
    pos_f = np.asarray(st_f.positions)
    e_f, c_f = lattice.lattice_edges(faithful_res)
    topo_f = build.build_topology(
        pos_f, e_f, c_f, colors=lattice.lattice_family_colors(faithful_res))
    st_g = state_from_topology(topo_f, pos_f, mass=0.001)
    fn_s = lat_engine.make_step(spec_f, cfg_f, dt, n_steps=faithful_frames)
    fn_g = general.make_step(topo_f, cfg_f, dt, n_steps=faithful_frames)
    out_s, first_s = timed(fn_s, st_f)
    _, steady_s = timed(fn_s, st_f)
    out_g, first_g = timed(fn_g, st_g)
    _, steady_g = timed(fn_g, st_g)
    drift = max_abs(out_s.positions, out_g.positions)
    n = spec_f.n_particles
    _calls(f"faithful stencil, {n} particles, {spec_f.n_families} "
           f"families x 2 parities x {cfg_f.iterations} iterations, "
           f"{faithful_frames} frames",
           first_s, steady_s)
    _calls(f"faithful general, {topo_f.n_edges} edges", first_g, steady_g)
    log(f"  faithful stencil vs general: drift {drift:.3e} (bound "
        f"{FAITHFUL_TOL:g})")
    require(np.isfinite(np.asarray(out_s.positions)).all(),
            "faithful run not finite")
    require(drift < FAITHFUL_TOL, f"faithful drift {drift}")


def phase_mesh(frames=240, chunk=60, scene="stanford_bunny"):
    import numpy as np

    from softbodysimulation_tpu.core import scenes
    from softbodysimulation_tpu.ops.distance import constraint_error
    from softbodysimulation_tpu.solvers import general

    state, _, info = scenes.SCENES[scene]()
    topo, cfg, dt = info["topology"], info["config"], info["dt"]
    log(f"  {scene}: {topo.n_particles} particles, {topo.n_edges} edges")
    traj = {}
    for backend in ("windowed", "gather"):
        fn = general.make_step(topo, cfg.replace(distance_backend=backend),
                               dt, n_steps=chunk)
        st, first = timed(fn, state)
        traj[backend] = [st]
        steady = 0.0
        for _ in range(frames // chunk - 1):
            st, t = timed(fn, st)
            traj[backend].append(st)
            steady = t
        _calls(f"{backend} x{chunk} frames", first, steady)
        require(np.isfinite(np.asarray(st.positions)).all(),
                f"{backend} not finite")
    early = max_abs(traj["windowed"][0].positions,
                    traj["gather"][0].positions)
    w, g = traj["windowed"][-1], traj["gather"][-1]
    com = float(np.abs(np.asarray(w.positions.mean(0) - g.positions.mean(0))
                       ).max())
    err = [float(constraint_error(s.positions, topo.edges,
                                  topo.rest_lengths).mean()) for s in (w, g)]
    err_rel = abs(err[0] - err[1]) / max(err[1], 1e-12)
    log(f"  windowed vs gather: drift after {chunk} frames {early:.3e} "
        f"(bound {MESH_EARLY_TOL:g}); after {frames} frames COM "
        f"{com:.3e} (bound {MESH_COM_TOL:g}), mean constraint error "
        f"{err[0]:.4e} vs {err[1]:.4e} (rel {err_rel:.3f}, bound "
        f"{MESH_ERR_RTOL:g}), max position drift "
        f"{max_abs(w.positions, g.positions):.3e}")
    require(early < MESH_EARLY_TOL, f"windowed vs gather drift {early}")
    require(com < MESH_COM_TOL, f"windowed vs gather COM {com}")
    require(err_rel < MESH_ERR_RTOL, f"constraint error {err}")


def phase_solid(res=40, frames=120):
    import jax.numpy as jnp
    import numpy as np

    from softbodysimulation_tpu.core import scenes
    from softbodysimulation_tpu.ops.tet_volume import tet_volumes6
    from softbodysimulation_tpu.solvers import lattice as lat_engine
    from softbodysimulation_tpu.topology import tets

    state, _, info = scenes.solid_lattice(res=res)
    spec, cfg, dt = info["spec"], info["config"], info["dt"]
    fn = lat_engine.make_step(spec, cfg, dt, n_steps=frames // 2)
    out, first = timed(fn, state)
    out, steady = timed(fn, out)
    tt = jnp.asarray(tets.cube_lattice_tets(res))
    v0 = float(tet_volumes6(state.positions, tt).sum())
    v = float(tet_volumes6(out.positions, tt).sum())
    p = np.asarray(out.positions)
    _calls(f"solid lattice, {spec.n_particles} particles, {tt.shape[0]} "
           f"tets, {frames // 2} frames/call", first, steady,
           f"; volume ratio {v / v0:.5f} (bound 1 +- {VOLUME_TOL:g}); "
           f"ymin {p[:, 1].min():.4f}")
    require(np.isfinite(p).all(), "solid lattice not finite")
    require(abs(v / v0 - 1.0) < VOLUME_TOL, f"volume ratio {v / v0}")
    require(p[:, 1].min() > -1e-2, "solid lattice fell through the floor")


def phase_contact(res=40, substeps=100, scene=None, warm_frames=30):
    import jax
    import numpy as np

    from softbodysimulation_tpu import LambdaMode, SolveMode, SolverConfig
    from softbodysimulation_tpu.core import scenes
    from softbodysimulation_tpu.diag.diagnostics import (
        blocked_dropped_pairs, blocked_overflow)
    from softbodysimulation_tpu.ops import spatial_hash as sh
    from softbodysimulation_tpu.solvers import general
    from softbodysimulation_tpu.solvers import lattice as lat_engine
    from softbodysimulation_tpu.topology import lattice

    # one 64k lattice with exact blocked self-contact every substep.  At
    # r = 0.55 spacing every axis neighbour is in contact, so a block's
    # reach spans its whole Hilbert neighbourhood: 8 candidate blocks drop
    # ~2e4 real pairs, 32 still drop a few after 100 substeps (measured on
    # the CPU); 48 leaves margin
    spec = lattice.lattice_spec(res, braced=True)
    cfg = SolverConfig(substeps=8, iterations=1, damping=0.02,
                       solve_mode=SolveMode.JACOBI,
                       lambda_mode=LambdaMode.RESET,
                       gravity_is_acceleration=True, fast_math=True,
                       enable_self_collision=True,
                       particle_radius=0.55 / (res - 1),
                       self_collision_backend="blocked",
                       collision_block_size=256, block_neighbors=48,
                       ground_height=0.0, friction=0.3)
    st = lat_engine.make_lattice_state(spec, center=(0.0, 0.55, 0.0),
                                       mass=0.001)
    fn = lat_engine.make_substep_runner(spec, cfg, 1 / 480, substeps)
    out, first = timed(fn, st)
    out, steady = timed(fn, out)
    dropped = blocked_dropped_pairs(out, cfg)
    n = spec.n_particles
    _calls(f"lattice {n} blocked contact x{substeps} substeps", first,
           steady, f" = {n * substeps / steady:.4e} particle-substeps/s; "
           f"dropped pairs {dropped}, AABB overflow "
           f"{blocked_overflow(out, cfg)}")
    require(np.isfinite(np.asarray(out.positions)).all(),
            "contact lattice not finite")
    require(dropped == 0, f"blocked contact dropped {dropped} pairs")

    # multi-body contact at scale through the general engine
    state, _, info = (scene or scenes.ball_on_cloth_xl)()
    topo, cfg, dt = info["topology"], info["config"], info["dt"]
    fn = general.make_step(topo, cfg, dt, n_steps=warm_frames)
    warm, first = timed(fn, state)
    _, steady = timed(fn, state)
    dropped = blocked_dropped_pairs(warm, cfg)
    _calls(f"ball on cloth, {topo.n_particles} particles, "
           f"{cfg.self_collision_backend} every {cfg.self_collision_every} "
           f"x{warm_frames} frames", first, steady,
           f"; dropped pairs {dropped}")
    require(np.isfinite(np.asarray(warm.positions)).all(),
            "ball on cloth not finite")
    require(dropped == 0, f"ball on cloth dropped {dropped} pairs")

    # dense vs blocked: one projection of the warm state jittered by a
    # tenth of the contact radius (seeded), which brings thousands of
    # cloth neighbours inside the contact diameter (the warm state's own
    # contacts are already resolved)
    pred = warm.positions + 0.1 * cfg.particle_radius * jax.random.normal(
        jax.random.PRNGKey(0), warm.positions.shape)
    w = warm.inv_mass
    dense = jax.jit(lambda p, m: sh.self_collision_project_dense(p, m, cfg))
    blocked = jax.jit(lambda p, m: sh.self_collision_project_blocked(
        p, m, sh.morton_order(p, cfg), cfg))
    d_out, first_d = timed(dense, pred, w)
    b_out, first_b = timed(blocked, pred, w)
    diff = max_abs(d_out, b_out)
    moved = max_abs(d_out, pred)
    log(f"  dense vs blocked projection ({topo.n_particles} particles): "
        f"max diff {diff:.3e} (bound {DENSE_BLOCKED_TOL:g}), contact moves "
        f"{moved:.3e}; first calls {first_d:.3f} / {first_b:.3f} s")
    require(moved > 0.0, "no contact in the jittered state")
    require(diff < DENSE_BLOCKED_TOL, f"dense vs blocked {diff}")


def phase_grad(fit_iters=8, launch_iters=40, launch_frames=60):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from softbodysimulation_tpu.examples import config6_diffsim
    from softbodysimulation_tpu.examples import config10_material_fit as c10

    t0 = time.perf_counter()
    l0, l1, e0, e1 = c10.run(opt_iters=fit_iters, verbose=False)
    log(f"  config10 material fit: loss {l0:.4e} -> {l1:.4e}, rest-length "
        f"error {e0:.4f} -> {e1:.4f} ({time.perf_counter() - t0:.1f} s)")
    require(np.isfinite([l0, l1, e0, e1]).all(), "material fit not finite")
    require(l1 < l0 and e1 < e0, "material fit did not improve")

    t0 = time.perf_counter()
    v0, hist = config6_diffsim.run(steps=launch_frames,
                                   opt_iters=launch_iters, verbose=False)
    log(f"  config6 launch optimisation: loss {hist[0]:.4e} -> "
        f"{hist[-1]:.4e}, v0 {np.round(v0, 3)} "
        f"({time.perf_counter() - t0:.1f} s)")
    require(np.isfinite(hist).all() and np.isfinite(v0).all(),
            "launch optimisation not finite")
    require(hist[-1] < hist[0], "launch optimisation did not improve")

    # directional derivative along the gradient vs a central difference
    loss, rest0, _ = c10.material_problem()
    g = jax.grad(loss)(rest0)
    gn = float(jnp.linalg.norm(g))
    require(np.isfinite(np.asarray(g)).all() and gn > 0.0,
            f"material gradient not finite or zero: |g| = {gn}")
    d = g / gn
    fd = float(loss(rest0 + FD_STEP * d) - loss(rest0 - FD_STEP * d)) / (
        2 * FD_STEP)
    rel = abs(fd - gn) / gn
    log(f"  d loss / d rest along g: autodiff {gn:.6e}, central "
        f"difference {fd:.6e} (h {FD_STEP:g}): rel err {rel:.3e} "
        f"(bound {FD_TOL:g})")
    require(rel < FD_TOL, f"directional derivative off by {rel}")


def phase_cli(steps=120):
    from softbodysimulation_tpu import cli

    rc = cli.main(["run", "flagship_perf", "--steps", str(steps),
                   "--log-every", str(max(steps // 2, 1))])
    require(rc == 0, f"cli returned {rc}")


def phase_gpu_tests():
    import pytest

    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(REPO, "tests")])
    require(rc == 0, f"pytest -m gpu exited {rc}")


def phase_multichip(n=4, res=128, dp_res=40, bodies_per_device=2, steps=2):
    import __graft_entry__ as entry

    drifts = entry.multichip_legs(n, res=res, dp_res=dp_res,
                                  bodies_per_device=bodies_per_device,
                                  steps=steps, log=lambda m: log("  " + m))
    log("  drifts: " + json.dumps(drifts))


PHASES = (("lattice64k", phase_lattice), ("oracle", phase_oracle),
          ("mesh", phase_mesh), ("solid", phase_solid),
          ("contact", phase_contact), ("grad", phase_grad),
          ("cli", phase_cli), ("gpu-tests", phase_gpu_tests))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multichip", action="store_true",
                    help="four GPUs: run only the multi-device paths, each "
                         "against its one-card result")
    args = ap.parse_args(argv)

    import jax

    if "JAX_COMPILATION_CACHE_DIR" not in os.environ:
        jax.config.update("jax_compilation_cache_dir", compile_cache_dir())
    devs = require_gpu(jax, 4 if args.multichip else 1)
    with Phase("device"):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60)
        for line in smi.stdout.strip().splitlines():
            log(line)
        log(f"device_kind {devs[0].device_kind}, {len(devs)} device(s), "
            f"jax {jax.__version__}, compile cache {compile_cache_dir()}")
    if args.multichip:
        with Phase("multichip"):
            phase_multichip(len(devs))
    else:
        for name, fn in PHASES:
            with Phase(name):
                fn()
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
