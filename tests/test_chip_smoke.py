"""chip_smoke.py on the CPU: its refusals, its compile-cache rule, and every
phase rehearsed at a small size (the script itself runs them at full size
on the card).
"""

import json
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def _run(script, cwd):
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _has_result(stdout):
    for line in stdout.splitlines():
        try:
            if json.loads(line).get("ok") is not None:
                return True
        except (ValueError, AttributeError):
            continue
    return False


def test_refuses_a_cpu_backend():
    out = _run(os.path.join(REPO, "chip_smoke.py"), REPO)
    assert out.returncode != 0
    assert not _has_result(out.stdout)
    assert "needs a GPU" in out.stderr


def test_refuses_outside_the_checkout(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _run(str(tmp_path / "chip_smoke.py"), str(tmp_path))
    assert out.returncode != 0
    assert not _has_result(out.stdout)


def test_require_gpu_raises_on_cpu():
    import jax

    with pytest.raises(SystemExit, match="needs a GPU"):
        chip_smoke.require_gpu(jax)


@pytest.mark.parametrize("env,want", [
    ({"JAX_COMPILATION_CACHE_DIR": "/elsewhere/cache"}, "/elsewhere/cache"),
    ({}, os.path.join(REPO, ".jax_cache")),
    ({"JAX_COMPILATION_CACHE_DIR": ""}, os.path.join(REPO, ".jax_cache")),
])
def test_compile_cache_dir(env, want):
    assert chip_smoke.compile_cache_dir(env) == want


def test_compile_cache_dir_is_ignored_by_git():
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def _small_contact_scene():
    from softbodysimulation_tpu.core import scenes

    return scenes.ball_on_cloth(contact_backend="blocked", contact_every=3)


SMALL = {
    "lattice": lambda: chip_smoke.phase_lattice(res=8, substeps=40,
                                                frames=2),
    "oracle": lambda: chip_smoke.phase_oracle(
        faithful_res=5, faithful_frames=2, flagship_frames=60,
        oracle_scenes=chip_smoke.ORACLE_SCENES[:1]),
    "mesh": lambda: chip_smoke.phase_mesh(frames=8, chunk=4,
                                          scene="cloth"),
    "solid": lambda: chip_smoke.phase_solid(res=6, frames=10),
    "contact": lambda: chip_smoke.phase_contact(
        res=6, substeps=16, scene=_small_contact_scene, warm_frames=40),
    "grad": lambda: chip_smoke.phase_grad(fit_iters=2, launch_iters=3,
                                          launch_frames=10),
    "cli": lambda: chip_smoke.phase_cli(steps=2),
}


@pytest.mark.parametrize("phase", list(SMALL))
def test_phase_runs_small(phase):
    SMALL[phase]()


@pytest.mark.parametrize("n", [2, 4])
def test_multichip_phase_on_virtual_devices(n, capsys):
    chip_smoke.phase_multichip(n, res=2 * n, dp_res=3, bodies_per_device=1,
                               steps=1)
    drifts = json.loads(capsys.readouterr().out.split("drifts: ")[-1])
    assert set(drifts) == {"dp_lattice_step", "dp_lattice_rollout",
                           "spatial_lattice", "spatial_moving_collider",
                           "spatial_moving_collider_com", "spatial_tets", "diff_farm_loss",
                           "diff_farm_grad"}
