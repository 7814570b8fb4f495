"""Scene catalogue + CLI runner (the reference's scenes-as-workloads, L9)."""

import os
import subprocess
import sys

import numpy as np
import pytest

from softbodysimulation_tpu.core.scenes import SCENES

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name", ["cpu_cube", "gpu_substep", "flagship"])
def test_scene_runs_and_stays_finite(name):
    state, step, info = SCENES[name]()
    for _ in range(5):
        state = step(state)
    p = np.asarray(state.positions)
    assert np.isfinite(p).all()


def test_cpu_mesh_scene_builds():
    # uses the bunny OBJ when present, else icosphere fallback
    state, step, info = SCENES["cpu_mesh"](fallback_subdiv=1)
    state = step(state)
    assert np.isfinite(np.asarray(state.positions)).all()
    assert info["topology"].n_edges > 0


def test_flagship_scene_matches_reference_workload():
    state, step, info = SCENES["flagship"]()
    assert state.positions.shape == (64, 3)          # res=4 -> 64 particles
    # lambda field covers the 7 reference families
    assert info["config"].iterations == 9


def _run_cli(*args):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run(
        [sys.executable, "-m", "softbodysimulation_tpu", *args],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=300)


def test_cli_list():
    r = _run_cli("list")
    assert r.returncode == 0
    for name in SCENES:
        assert name in r.stdout


def test_cli_run_with_export_and_checkpoint(tmp_path):
    obj = os.path.join(tmp_path, "f.obj")
    ckpt = os.path.join(tmp_path, "s.npz")
    r = _run_cli("run", "cpu_cube", "--steps", "30", "--platform", "cpu",
                 "--log-every", "0", "--export", obj, "--checkpoint", ckpt)
    assert r.returncode == 0, r.stderr
    assert "done: 30 steps" in r.stdout
    assert os.path.exists(obj) and os.path.exists(ckpt)


def test_cli_unknown_scene_fails_cleanly():
    r = _run_cli("run", "nope", "--platform", "cpu")
    assert r.returncode == 2
    assert "unknown scene" in r.stderr


def test_cli_set_overrides_config():
    """--set rebuilds the step with the overridden SolverConfig (int,
    float, bool and enum-by-name coercion)."""
    r = _run_cli("run", "cpu_cube", "--steps", "10", "--platform", "cpu",
                 "--log-every", "0", "--set", "iterations=2",
                 "--set", "damping=0.1", "--set", "solve_mode=JACOBI")
    assert r.returncode == 0, r.stderr
    assert "done: 10 steps" in r.stdout


def test_cli_set_rejects_unknown_field_and_bad_value():
    r = _run_cli("run", "cpu_cube", "--steps", "1", "--platform", "cpu",
                 "--set", "not_a_field=1")
    assert r.returncode == 2
    assert "unknown config field" in r.stderr
    r = _run_cli("run", "cpu_cube", "--steps", "1", "--platform", "cpu",
                 "--set", "iterations=zero")
    assert r.returncode == 2
    assert "bad value" in r.stderr
    r = _run_cli("run", "cpu_cube", "--steps", "1", "--platform", "cpu",
                 "--set", "iterations=0")
    assert r.returncode == 2
    assert "invalid config" in r.stderr


def test_cli_log_every_samples_blocked_exactness():
    """--log-every on a blocked-backend scene prints BOTH contact
    diagnostics: the conservative AABB overflow and the round-5
    pair-accurate dropped_pairs count (the warning signal)."""
    r = _run_cli("run", "ball_on_cloth", "--steps", "2", "--platform",
                 "cpu", "--log-every", "2",
                 "--set", "self_collision_backend=blocked",
                 "--set", "block_neighbors=8")
    assert r.returncode == 0, r.stderr[-500:]
    assert "contact_overflow=" in r.stdout
    assert "dropped_pairs=" in r.stdout


def test_ball_on_cloth_rejects_a_tunnelling_contact_radius():
    # 140 nodes across the default 1.2-unit cloth: the derived contact
    # radius falls below the per-substep fall distance
    from softbodysimulation_tpu.core.scenes import ball_on_cloth

    with pytest.raises(ValueError, match="tunnel"):
        ball_on_cloth(cloth_res=140)


def test_ball_on_cloth_xl_is_exact_blocked_contact_at_cadence():
    from softbodysimulation_tpu.diag.diagnostics import blocked_dropped_pairs

    state, _, info = SCENES["ball_on_cloth_xl"]()
    cfg = info["config"]
    assert info["topology"].n_particles > 20_000
    assert (cfg.self_collision_backend, cfg.self_collision_every,
            cfg.block_neighbors) == ("blocked", 3, 18)
    assert 2 * cfg.particle_radius < 3.5 / 139
    assert blocked_dropped_pairs(state, cfg) == 0


def test_graft_entry_step_runs():
    import jax

    sys.path.insert(0, REPO)
    import __graft_entry__ as entry

    fn, args = entry.entry()
    out = jax.jit(fn)(*args)
    p = np.asarray(out.positions)
    assert p.shape == args[0].positions.shape and np.isfinite(p).all()
    assert p[:, 1].min() < float(np.asarray(args[0].positions)[:, 1].min())
