"""Multi-body contact: two soft bodies interacting through the
self-collision backends over a merged topology (core/scenes.ball_on_cloth).

Beyond the reference — each Unity ``SoftBodySimulator`` owns one mesh and
bodies never interact (``SoftBodySimulator.cs``; the unused
``SphereCollision`` helper ``XPBDSimulatorCS.compute:213-217`` is the
closest gesture).  The design claim under test: inter-body contact is a
COMPOSITION property of the contact backends (no body IDs, no pair
tables), so the ball must come to rest ON the cloth, and removing the
contact pass must let it fall straight through.
"""

import dataclasses

import jax
import numpy as np
import pytest

from softbodysimulation_tpu.core.scenes import SCENES
from softbodysimulation_tpu.solvers import general as G


@pytest.fixture(scope="module")
def scene():
    state, step, info = SCENES["ball_on_cloth"]()
    return state, step, info


def _run(state, step, n):
    jstep = jax.jit(step)
    for _ in range(n):
        state = jstep(state)
    return np.asarray(state.positions)


def test_ball_rests_on_cloth(scene):
    state, step, info = scene
    nc = info["n_cloth"]
    p = _run(state, step, 120)
    assert np.isfinite(p).all()
    ball_min = p[nc:, 1].min()
    # resting ON the sagging cloth: far above the floor (y=0) and no lower
    # than a plausible trampoline sag below the cloth's rest plane (y=1)
    assert ball_min > 0.55, ball_min
    # the cloth actually deflected under the ball (contact is two-sided)
    cloth_center = p[:nc, 1].min()
    assert cloth_center < 0.99, cloth_center
    # rim pins held
    rim_y = p[:nc, 1].max()
    assert abs(rim_y - 1.0) < 1e-4, rim_y


def test_without_contact_ball_falls_through(scene):
    state, _, info = scene
    nc = info["n_cloth"]
    cfg_off = dataclasses.replace(info["config"], enable_self_collision=False)
    step_off = G.make_step(info["topology"], cfg_off, info["dt"])
    p = _run(state, step_off, 120)
    assert np.isfinite(p).all()
    # no contact: the ball passes through the cloth and rests on the floor
    assert p[nc:, 1].min() < 0.25, p[nc:, 1].min()


@pytest.mark.slow
def test_backends_agree_on_inter_body_contact(scene):
    """The sorted/hash approximate backends must see the same inter-body
    contact the exact dense backend resolves.  The load-bearing assertion
    is qualitative (every backend keeps the ball ON the cloth); the
    positional agreement is deliberately loose — contact discovery order
    differs between backends and the dynamics are contact-rich, so
    trajectories diverge at fp-noise-amplified (dm) scale across
    platforms/JAX versions (ROADMAP.md "Chaos caveat")."""
    state, _, info = scene
    nc = info["n_cloth"]
    finals = {}
    for backend in ("dense", "sorted", "hash"):
        cfg = dataclasses.replace(info["config"],
                                  self_collision_backend=backend)
        step = G.make_step(info["topology"], cfg, info["dt"])
        finals[backend] = _run(state, step, 90)
    for backend in ("sorted", "hash"):
        a, b = finals["dense"], finals[backend]
        # all backends keep the ball on the cloth (the physics claim)
        assert b[nc:, 1].min() > 0.55, (backend, b[nc:, 1].min())
        # and land it in the same neighbourhood (documented-loose)
        da = np.abs(a[nc:].mean(0) - b[nc:].mean(0)).max()
        assert da < 0.15, (backend, da)


# ---- merge_topologies: the public multi-body construction -------------

from softbodysimulation_tpu.topology import build as B  # noqa: E402
from softbodysimulation_tpu.topology import edges as TE  # noqa: E402
from softbodysimulation_tpu.topology import mesh as TM  # noqa: E402


def test_merge_topologies_offsets_and_slices():
    m = TM.grid_plane(1.0, 4)
    ed = TE.unique_edges(m.triangles)
    hi = TE.hinges(m.triangles)
    b1 = B.BodySpec(m.vertices, ed, 1e-5, hinges=hi,
                    bend_compliance=1e-3, triangles=m.triangles)
    b2 = B.BodySpec(m.vertices + np.array([0, 1, 0]), ed, 1e-4,
                    triangles=m.triangles)
    pos, topo, sl = B.merge_topologies([b1, b2])
    n1 = m.vertices.shape[0]
    assert topo.n_particles == 2 * n1
    assert sl[0].particles == slice(0, n1)
    assert sl[1].particles == slice(n1, 2 * n1)
    # body-2 constraint rows are body-1's offset by n1
    e = np.asarray(topo.edges)
    assert (e[sl[1].edges] == e[sl[0].edges] + n1).all()
    # per-body compliances land on the right rows
    c = np.asarray(topo.compliance)
    assert np.allclose(c[sl[0].edges], 1e-5)
    assert np.allclose(c[sl[1].edges], 1e-4)
    # hinges: only body 1 has them
    assert sl[0].hinges == slice(0, hi.shape[0])
    assert sl[1].hinges == slice(hi.shape[0], hi.shape[0])
    # positions concatenate in order
    assert np.allclose(pos[sl[1].particles],
                       m.vertices + np.array([0, 1, 0]), atol=1e-6)
    # merged coloring is valid on the merged graph
    from softbodysimulation_tpu.topology import coloring as C
    assert C.validate_coloring(e, np.asarray(topo.colors))


def test_merge_rejects_out_of_range_indices():
    with pytest.raises(ValueError):
        B.BodySpec(np.zeros((3, 3)), edges=[[0, 5]])


def test_three_bodies_stack_and_interact():
    """Three bodies in ONE merged topology: two solid balls dropped onto a
    pinned cloth; the contact backends resolve ball-cloth AND ball-ball
    contact with no body IDs (3-body composition, verdict r3 item 9)."""
    from softbodysimulation_tpu import (SolveMode, SolverConfig,
                                        state_from_topology)
    from softbodysimulation_tpu.interact import forces as F
    from softbodysimulation_tpu.topology import tets as TT

    res = 12
    cm = TM.grid_plane(0.9, res)
    cverts = (cm.vertices + np.array([0, 1, 0])).astype(np.float32)
    bm = TM.icosphere(1, radius=0.12)
    tv, tt = TT.tets_from_surface_centroid(bm.vertices, bm.triangles)
    bodies = [B.BodySpec(cverts, TE.unique_edges(cm.triangles), 1e-5,
                         hinges=TE.hinges(cm.triangles),
                         bend_compliance=1e-3, triangles=cm.triangles)]
    # coaxial drop: an offset stack is genuinely unstable (the upper ball
    # rolls off the lower one and both roll off the cloth — measured)
    for dy in (1.3, 1.60):
        bodies.append(B.BodySpec(
            (tv + np.array([0.0, dy, 0.0])).astype(np.float32),
            TT.tet_edges(tt), 1e-4,
            triangles=TT.boundary_faces(tt), tets=tt, tet_compliance=0.0))
    pos, topo, sl = B.merge_topologies(bodies)
    spacing = 0.9 / (res - 1)
    cfg = SolverConfig(substeps=6, iterations=4, damping=0.02,
                       solve_mode=SolveMode.JACOBI,
                       enable_bending=True,
                       enable_tet_volume=True, tet_pressure=1.05,
                       enable_self_collision=True,
                       self_collision_backend="dense",
                       particle_radius=round(0.45 * spacing, 4),
                       ground_height=0.0, friction=0.3)
    state = state_from_topology(topo, pos)
    nc = cverts.shape[0]
    ii, jj = np.divmod(np.arange(nc), res)
    rim = np.flatnonzero((ii % (res - 1) == 0) | (jj % (res - 1) == 0))
    state = F.pin_indices(state, rim, pinned=True)
    step = G.make_step(topo, cfg, 1 / 60)
    p = _run(state, step, 110)
    assert np.isfinite(p).all()
    # both balls rest above the (sagging) cloth, neither fell to the floor
    for s in sl[1:]:
        assert p[s.particles, 1].min() > 0.45, p[s.particles, 1].min()
    # the upper ball stayed on top: it cannot pass through the lower one
    lo = p[sl[1].particles, 1].mean()
    hi = p[sl[2].particles, 1].mean()
    assert hi > lo + 0.1, (lo, hi)
    # cloth deflected under the stack
    assert p[sl[0].particles, 1].min() < 0.99


def test_merge_topologies_windowed_keeps_slices():
    """windowed=True routes the merge through build_windowed_topology with
    the IDENTITY particle order: every BodySlices range stays valid, the
    positions come back unpermuted, and the merged topology carries the
    one-hot window structure (the windowed engine backend)."""
    m = TM.grid_plane(1.0, 4)
    ed = TE.unique_edges(m.triangles)
    b1 = B.BodySpec(m.vertices, ed, 1e-5, triangles=m.triangles)
    b2 = B.BodySpec(m.vertices + np.array([0, 1, 0]), ed, 1e-4,
                    triangles=m.triangles)
    pos_p, topo_p, sl_p = B.merge_topologies([b1, b2])
    pos_w, topo_w, sl_w = B.merge_topologies([b1, b2], windowed=True)
    assert topo_w.windows is not None and topo_p.windows is None
    assert np.allclose(pos_w, pos_p, atol=0)          # identity order
    assert [s.particles for s in sl_w] == [s.particles for s in sl_p]
    # constraint ROWS may be window-sorted, but each body's edge slice
    # still contains exactly that body's edges
    n1 = m.vertices.shape[0]
    ew = np.asarray(topo_w.edges)
    assert (ew[sl_w[0].edges] < n1).all()
    assert (ew[sl_w[1].edges] >= n1).all()
    cw = np.asarray(topo_w.compliance)
    assert np.allclose(cw[sl_w[0].edges], 1e-5)
    assert np.allclose(cw[sl_w[1].edges], 1e-4)


def test_merge_topologies_windowed_rejects_colored():
    m = TM.grid_plane(1.0, 3)
    b = B.BodySpec(m.vertices, TE.unique_edges(m.triangles), 1e-5)
    with pytest.raises(NotImplementedError):
        B.merge_topologies([b, b], windowed=True, colored=True)


def test_merge_topologies_windowed_solver_agreement():
    """The windowed merged topology must solve to the same trajectory as
    the plain merge (same constraint set, different backend layout)."""
    import dataclasses as _dc

    from softbodysimulation_tpu import (SolveMode, SolverConfig,
                                        state_from_topology)

    m = TM.grid_plane(0.6, 5)
    ed = TE.unique_edges(m.triangles)
    b1 = B.BodySpec(m.vertices + np.array([0, 0.5, 0]), ed, 1e-5,
                    triangles=m.triangles)
    b2 = B.BodySpec(m.vertices + np.array([0, 0.62, 0]), ed, 1e-4,
                    triangles=m.triangles)
    pos_p, topo_p, _ = B.merge_topologies([b1, b2])
    pos_w, topo_w, _ = B.merge_topologies([b1, b2], windowed=True)
    cfg = SolverConfig(substeps=4, iterations=4, damping=0.02,
                       solve_mode=SolveMode.JACOBI,
                       enable_self_collision=True,
                       self_collision_backend="dense",
                       particle_radius=0.05,
                       ground_height=0.0, friction=0.3)
    sp = _run(state_from_topology(topo_p, pos_p),
              G.make_step(topo_p, cfg, 1 / 60), 8)
    sw = _run(state_from_topology(topo_w, pos_w),
              G.make_step(topo_w, dataclasses.replace(
                  cfg, distance_backend="windowed"), 1 / 60), 8)
    _ = _dc
    d = np.abs(sp - sw).max()
    assert np.isfinite(sw).all()
    assert d < 5e-5, f"windowed merge diverged from plain merge: {d}"
