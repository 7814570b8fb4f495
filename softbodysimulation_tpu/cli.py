"""Command-line runner — the headless analog of the reference's scene
selection + editor tooling (``SoftBodySetupWizard``, scene files as
workloads):

    python -m softbodysimulation_tpu list
    python -m softbodysimulation_tpu run flagship --steps 300
    python -m softbodysimulation_tpu run cpu_cube --steps 500 \
        --export /tmp/frame.obj --checkpoint /tmp/state.npz
    python -m softbodysimulation_tpu bench
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def main(argv=None):
    parser = argparse.ArgumentParser(prog="softbodysimulation_tpu")
    sub = parser.add_subparsers(dest="cmd", required=True)

    sub.add_parser("list", help="list available scenes")

    runp = sub.add_parser("run", help="run a scene headless")
    runp.add_argument("scene", help="scene name (see `list`)")
    runp.add_argument("--steps", type=int, default=300)
    runp.add_argument("--dt", type=float, default=None,
                      help="override scene dt")
    runp.add_argument("--export", default=None,
                      help="write final frame as OBJ (needs triangles)")
    runp.add_argument("--checkpoint", default=None,
                      help="write final SimState as npz")
    runp.add_argument("--svg", default=None,
                      help="write a wireframe debug snapshot (SVG)")
    runp.add_argument("--ppm", default=None,
                      help="write a shaded z-buffered snapshot (binary PPM)")
    runp.add_argument("--export-every", type=int, default=0, metavar="N",
                      help="export an OBJ frame every N steps to "
                           "<export>.NNNN.obj (requires --export)")
    runp.add_argument("--log-every", type=int, default=60)
    runp.add_argument("--watch", type=int, default=0, metavar="N",
                      help="live ANSI preview in the terminal every N steps "
                           "(needs a scene with triangles)")
    runp.add_argument("--watch-cols", type=int, default=72,
                      help="preview width in terminal columns")
    runp.add_argument("--watch-fps", type=float, default=0.0,
                      help="cap preview rate (sleeps between frames)")
    runp.add_argument("--poke", action="append", default=[],
                      metavar="STEP:FX,FY,FZ@PX,PY,PZ:R",
                      help="schedule an impulse at a step, e.g. "
                           "120:0,80,0@0,1,0:0.8 (repeatable; applied "
                           "through the interaction Session)")
    runp.add_argument("--platform", default=None,
                      help="force a jax platform (e.g. cpu)")
    runp.add_argument("--set", action="append", default=[],
                      metavar="KEY=VAL", dest="overrides",
                      help="override a SolverConfig field for this run "
                           "(repeatable), e.g. --set iterations=4 "
                           "--set self_collision_every=8 "
                           "--set solve_mode=JACOBI; values are coerced "
                           "from the field's current type (bool/int/"
                           "float/str/enum-by-name)")

    sub.add_parser("bench", help="run the headline benchmark")

    args = parser.parse_args(argv)

    if args.cmd == "list":
        from .core.scenes import SCENES

        for name, fn in SCENES.items():
            doc = (fn.__doc__ or "").strip().splitlines()[0]
            print(f"{name:15s} {doc}")
        return 0

    if args.cmd == "bench":
        import runpy

        bench_path = os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "bench.py")
        runpy.run_path(bench_path, run_name="__main__")
        return 0

    if args.platform:
        import jax

        jax.config.update("jax_platforms", args.platform)

    from .core.scenes import SCENES

    if args.scene not in SCENES:
        print(f"unknown scene {args.scene!r}; available: "
              f"{', '.join(SCENES)}", file=sys.stderr)
        return 2

    import numpy as np

    kw = {"dt": args.dt} if args.dt else {}
    state, step, info = SCENES[args.scene](**kw)
    if getattr(args, "overrides", None):
        # generic per-run SolverConfig tweaks (the reference's per-scene
        # SoftBodySettings editability: SoftBodySettings.cs).  The step is
        # rebuilt on the scene's own engine.
        import enum

        cfg = info["config"]
        updates = {}
        for kv in args.overrides:
            key, sep, val = kv.partition("=")
            if not sep or not hasattr(cfg, key):
                print(f"--set: unknown config field {key!r} (see "
                      f"core/config.SolverConfig)", file=sys.stderr)
                return 2
            cur = getattr(cfg, key)
            try:
                if isinstance(cur, bool):
                    updates[key] = val.lower() in ("1", "true", "yes", "on")
                elif isinstance(cur, enum.Enum):
                    updates[key] = type(cur)[val.upper()]
                elif isinstance(cur, int):
                    updates[key] = int(val)
                elif isinstance(cur, float):
                    updates[key] = float(val)
                elif isinstance(cur, str):
                    updates[key] = val
                else:
                    print(f"--set: field {key!r} has unsupported type "
                          f"{type(cur).__name__}", file=sys.stderr)
                    return 2
            except (KeyError, ValueError) as e:
                print(f"--set: bad value for {key!r}: {e}", file=sys.stderr)
                return 2
        try:
            cfg = cfg.replace(**updates)
        except ValueError as e:
            print(f"--set: invalid config: {e}", file=sys.stderr)
            return 2
        info["config"] = cfg
        if "spec" in info:
            from .solvers import lattice as _lat

            step = _lat.make_step(info["spec"], cfg, info["dt"])
        else:
            from .solvers import general as _gen

            step = _gen.make_step(info["topology"], cfg, info["dt"])
    from .diag.profiling import StepTimer

    seq_topo = info.get("topology")
    if args.export_every and (args.export is None or seq_topo is None
                              or seq_topo.triangles.shape[0] == 0):
        print("--export-every needs --export and a scene with triangles",
              file=sys.stderr)
        return 2

    pokes = {}
    for spec_str in args.poke:
        try:
            step_s, rest = spec_str.split(":", 1)
            force_s, tail = rest.split("@", 1)
            pos_s, rad_s = tail.rsplit(":", 1)
            pokes.setdefault(int(step_s), []).append(
                (tuple(float(x) for x in force_s.split(",")),
                 tuple(float(x) for x in pos_s.split(",")),
                 float(rad_s)))
        except ValueError:
            print(f"bad --poke spec {spec_str!r} (want "
                  "STEP:FX,FY,FZ@PX,PY,PZ:R)", file=sys.stderr)
            return 2

    watch_topo = info.get("topology")
    if args.watch and (watch_topo is None
                       or watch_topo.triangles.shape[0] == 0):
        print("--watch needs a scene with surface triangles",
              file=sys.stderr)
        return 2

    # interaction session: pokes (and any scripted interaction) go through
    # the same verbs the library exposes (interact/session.py)
    from .interact.session import Session

    def _rebuild(cfg, _info=info):
        # preset hot-swap (watch keys 1/2/3 -> Session.apply_preset):
        # rebuild the step on the scene's engine
        _dt = _info["dt"]
        if "spec" in _info:
            from .solvers import lattice as _lat

            return _lat.make_step(_info["spec"], cfg, _dt)
        from .solvers import general as _gen

        return _gen.make_step(_info["topology"], cfg, _dt)

    sess = Session(state, step, dt=info.get("dt", args.dt or 1 / 60),
                   rebuild=(_rebuild if "dt" in info else None),
                   config=info.get("config"))

    exporter = None
    if args.export_every:
        from .io.export import AsyncExporter

        # overlapped readback+write pipeline (AsyncGPUReadback analog):
        # frames are materialized and written off-thread while the device
        # keeps stepping
        exporter = AsyncExporter()

    # live keyboard interaction during --watch (SoftBodyInteractor.cs:37-67
    # hotkeys minus the mouse ray; no-op when stdin is not a TTY)
    from .interact import keyboard as _keyboard

    timer = StepTimer()
    t0 = time.perf_counter()
    first_frame = True
    last_action = ""
    # scene-scripted rigid-world animation (kinematic colliders): the scene
    # updates the traced collider poses per frame; the compiled step program
    # is reused for every pose (core/colliders.py)
    animate = info.get("animate")

    # movable 3D cursor: the aimed-interaction replacement for the mouse
    # ray (SoftBodyInteractor.cs:69-80) — hjkl/arrows steer it, every verb
    # lands at it, and the render shows it as a crosshair
    cursor = (_keyboard.Cursor(np.asarray(state.positions))
              if args.watch else None)

    with _keyboard.raw_stdin() as poll_keys:
        for i in range(args.steps):
            if animate is not None:
                sess.state = animate(i, sess.state)
            for force, pos_p, rad in pokes.get(i, ()):
                sess.poke(force, pos_p, rad)
            if args.watch:
                rep = _keyboard.apply_keys(sess, poll_keys(), cursor=cursor)
                if rep["acted"]:
                    last_action = "+".join(rep["acted"])
                if rep["quit"]:
                    state = sess.state
                    break
            state = sess.step(1)
            if args.watch and (i + 1) % args.watch == 0:
                from .io import terminal as _terminal

                cfgw = info.get("config")
                cx, cy, cz = cursor.tuple()
                status = (f"step {i + 1}/{args.steps}  scene={args.scene}  "
                          f"poked={sum(1 for s in pokes if s <= i)}  "
                          f"cursor=({cx:+.2f},{cy:+.2f},{cz:+.2f})"
                          + (f"  [{last_action}]" if last_action else "")
                          + "\n" + _keyboard.legend())
                _terminal.show(
                    _terminal.frame(
                        state, watch_topo, cols=args.watch_cols,
                        ground_height=getattr(cfgw, "ground_height", None),
                        status=status, markers=[cursor.tuple()]),
                    first=first_frame)
                first_frame = False
                if args.watch_fps > 0:
                    time.sleep(1.0 / args.watch_fps)
            if exporter is not None and (i + 1) % args.export_every == 0:
                base, ext = os.path.splitext(args.export)
                exporter.submit(f"{base}.{i + 1:04d}{ext or '.obj'}",
                                state, seq_topo)
            if args.log_every and (i + 1) % args.log_every == 0:
                p = np.asarray(state.positions)
                rate = timer.tick(args.log_every)
                extra = ""
                cfgl = info.get("config")
                if (cfgl is not None and cfgl.enable_self_collision
                        and cfgl.self_collision_backend == "blocked"):
                    # exactness sampling for the blocked contact backend:
                    # the AABB bound is conservative (flat sheets exceed it
                    # vacuously), so warn on the PAIR-ACCURATE check —
                    # dropped > 0 means real contact contributions were
                    # missed at this state; raise block_neighbors
                    from .diag.diagnostics import (blocked_dropped_pairs,
                                                   blocked_overflow)

                    ovf = blocked_overflow(state, cfgl)
                    dropped = blocked_dropped_pairs(state, cfgl)
                    extra = (f" contact_overflow={ovf}"
                             f" dropped_pairs={dropped}")
                    if dropped:
                        print("WARNING: blocked self-collision dropped "
                              f"{dropped} real pair contributions — raise "
                              "SolverConfig.block_neighbors", file=sys.stderr)
                print(f"step {i + 1:6d}  ymin={p[:, 1].min():+.4f} "
                      f"ymean={p[:, 1].mean():+.4f} "
                      f"finite={bool(np.isfinite(p).all())} "
                      f"steps/s={rate:.1f}{extra}")
    if exporter is not None:
        exporter.close()
    np.asarray(state.positions)
    elapsed = time.perf_counter() - t0
    n = state.positions.shape[0]
    print(f"done: {args.steps} steps x {n} particles in {elapsed:.2f}s "
          f"({args.steps * n / elapsed:.3e} particle-steps/s)")

    if args.checkpoint:
        from .io import checkpoint

        checkpoint.save(args.checkpoint, state,
                        metadata={"steps": args.steps})
        print(f"checkpoint -> {args.checkpoint}")
    if args.svg:
        from .io import wireframe

        cfg = info.get("config")
        wireframe.render_svg(
            args.svg, state, info.get("topology"),
            ground_height=getattr(cfg, "ground_height", None))
        print(f"svg -> {args.svg}")
    if args.ppm:
        topo = info.get("topology")
        if topo is None or topo.triangles.shape[0] == 0:
            print("scene has no surface triangles; ppm skipped",
                  file=sys.stderr)
        else:
            from .io import raster

            cfgv = info.get("config")
            raster.render_ppm(
                args.ppm, state, topo,
                ground_height=getattr(cfgv, "ground_height", None))
            print(f"ppm -> {args.ppm}")
    if args.export:
        topo = info.get("topology")
        if topo is None or topo.triangles.shape[0] == 0:
            print("scene has no surface triangles; export skipped",
                  file=sys.stderr)
        else:
            from .io import export

            export.export_obj(args.export, state, topo)
            print(f"export -> {args.export}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
