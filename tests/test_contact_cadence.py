"""Contact cadence (``self_collision_every``): the classic PBD split of
collision handling onto a coarser cadence than the constraint iterations.

The engines compile the cadence as a static group structure (no runtime
branching); these tests replay the exact per-substep contact_on pattern
(i % every == 0) through the private ``_substep`` eagerly and require
agreement to fp-fusion noise (~2e-7 measured — jit-fused scan vs eager
op-by-op rounding), plus a discriminating check: the cadence trajectory
must differ from the every-substep trajectory by far more than that
tolerance, so a wrong contact pattern cannot hide inside it.  Physics
sanity: bodies still separate at cadence > 1.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from softbodysimulation_tpu import (
    SolveMode,
    SolverConfig,
    state_from_topology,
)
from softbodysimulation_tpu.solvers import general
from softbodysimulation_tpu.solvers import lattice as lat_engine
from softbodysimulation_tpu.topology import build, lattice, mesh

DT = 1 / 60


def _two_cube_topo():
    # already interpenetrating at t=0 so the contact pass fires from the
    # very first substep (the discriminator assertions depend on it)
    pos_a = mesh.cube_corners(0.5) + np.array([0, 1.0, 0], np.float32)
    pos_b = mesh.cube_corners(0.5) + np.array([0.05, 1.18, 0.02],
                                              np.float32)
    pos = np.concatenate([pos_a, pos_b])
    e = lattice.cube8_edges()
    edges = np.concatenate([e, e + 8])
    return build.build_topology(pos, edges, compliance=1e-4), pos


def _cfg(**kw):
    base = dict(substeps=6, iterations=4, solve_mode=SolveMode.JACOBI,
                enable_self_collision=True, particle_radius=0.12,
                ground_height=0.0, friction=0.3, damping=0.05)
    base.update(kw)
    return SolverConfig(**base)


@pytest.mark.parametrize("every", [2, 3, 4, 7])
def test_general_cadence_matches_manual_replay(every):
    """step_fn's static group structure == manual i % every == 0 replay."""
    topo, pos = _two_cube_topo()
    cfg = _cfg(self_collision_every=every)
    st = state_from_topology(topo, pos)

    out = general.make_step(topo, cfg, DT, n_steps=3)(st)

    man = st
    dt_sub = DT / cfg.substeps
    for _step in range(3):
        for i in range(cfg.substeps):
            man = general._substep(man, topo, cfg, dt_sub,
                                   apply_ext=(i == 0),
                                   contact_on=(i % every == 0))
        man = man.replace(ext_force=jnp.zeros_like(man.ext_force))

    d = np.abs(np.asarray(out.positions) - np.asarray(man.positions)).max()
    assert d < 2e-5, f"cadence group structure diverges from replay: {d}"

    # discriminator: the every=1 trajectory is far from the cadenced one,
    # so the tolerance above cannot mask a wrong contact pattern
    out1 = general.make_step(topo, cfg.replace(self_collision_every=1),
                             DT, n_steps=3)(st)
    d1 = np.abs(np.asarray(out.positions)
                - np.asarray(out1.positions)).max()
    assert d1 > 1e-3, f"cadence {every} indistinguishable from every=1: {d1}"


def test_general_cadence_one_is_identity_semantics():
    """every=1 must take the original (single-scan) path and match the
    per-substep contact-on replay bitwise."""
    topo, pos = _two_cube_topo()
    cfg = _cfg(self_collision_every=1)
    st = state_from_topology(topo, pos)
    out = general.make_step(topo, cfg, DT, n_steps=2)(st)
    man = st
    dt_sub = DT / cfg.substeps
    for _step in range(2):
        for i in range(cfg.substeps):
            man = general._substep(man, topo, cfg, dt_sub,
                                   apply_ext=(i == 0), contact_on=True)
        man = man.replace(ext_force=jnp.zeros_like(man.ext_force))
    d = np.abs(np.asarray(out.positions) - np.asarray(man.positions)).max()
    assert d < 2e-5


def test_cadence_still_separates_bodies():
    """Physics: at every=substeps (one contact pass per frame, the classic
    PBD arrangement) two dropped bodies still do not interpenetrate."""
    topo, pos = _two_cube_topo()
    cfg = _cfg(self_collision_every=6)
    st = state_from_topology(topo, pos)
    st = general.make_step(topo, cfg, DT, n_steps=200)(st)
    p = np.asarray(st.positions)
    assert np.isfinite(p).all()
    d = np.linalg.norm(p[:8, None, :] - p[None, 8:, :], axis=-1)
    assert d.min() > 0.10  # no deep interpenetration at cadence


@pytest.mark.parametrize("every", [2, 5])
def test_lattice_cadence_matches_manual_replay(every):
    spec = lattice.lattice_spec(4, braced=True)
    st = lat_engine.make_lattice_state(spec, center=(0.0, 0.6, 0.0))
    cfg = _cfg(substeps=5, iterations=2,
               particle_radius=0.55 / 3, collision_block_size=128,
               self_collision_backend="blocked", block_neighbors=2,
               self_collision_every=every)

    out = lat_engine.make_step(spec, cfg, DT, n_steps=2)(st)

    masks = lat_engine._masks_dev(spec)
    x, v, w, f, lam = lat_engine._to_grid(st, spec)
    dt_sub = DT / cfg.substeps
    for _step in range(2):
        for i in range(cfg.substeps):
            x, v, lam = lat_engine._substep(
                x, v, w, f if (i == 0 and _step == 0) else jnp.zeros_like(f),
                lam, spec, cfg, dt_sub, apply_ext=(i == 0),
                masks_dev=masks, contact_on=(i % every == 0))
    man = lat_engine._from_grid(st, x, v, lam)

    d = np.abs(np.asarray(out.positions) - np.asarray(man.positions)).max()
    assert d < 2e-5, f"lattice cadence diverges from replay: {d}"

    out1 = lat_engine.make_step(spec, cfg.replace(self_collision_every=1),
                                DT, n_steps=2)(st)
    d1 = np.abs(np.asarray(out.positions)
                - np.asarray(out1.positions)).max()
    assert d1 > 1e-4, f"cadence {every} indistinguishable from every=1: {d1}"


def test_lattice_substep_runner_cadence():
    """The flat bench runner applies contact at i % every == 0 too."""
    spec = lattice.lattice_spec(4, braced=True)
    st = lat_engine.make_lattice_state(spec, center=(0.0, 0.6, 0.0))
    cfg = _cfg(substeps=5, iterations=2, particle_radius=0.55 / 3,
               self_collision_every=3)
    n_sub = 7
    out = lat_engine.make_substep_runner(spec, cfg, DT / 5, n_sub)(st)

    masks = lat_engine._masks_dev(spec)
    x, v, w, f, lam = lat_engine._to_grid(st, spec)
    for i in range(n_sub):
        x, v, lam = lat_engine._substep(
            x, v, w, f, lam, spec, cfg, DT / 5, apply_ext=False,
            masks_dev=masks, contact_on=(i % 3 == 0))
    man = lat_engine._from_grid(st, x, v, lam)
    d = np.abs(np.asarray(out.positions) - np.asarray(man.positions)).max()
    assert d < 2e-5


def test_cadence_validation():
    with pytest.raises(ValueError):
        SolverConfig(self_collision_every=0)


