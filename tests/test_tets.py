"""Per-tetrahedron volume constraints (topology/tets.py, ops/tet_volume.py,
general-engine integration).

The capability the reference seeded but never wired: ``CalculateVolume``
(``XPBDSimulatorCS.compute:220-223``) is a tet-volume helper and
``AddVolumeConstraints`` (``SoftBodySimulator.cs:187-212``) is commented out
of the call path.  Validation pyramid here:

* builder invariants (tet counts, fill, conforming boundary, edge sets)
* analytic-gradient check against jax.grad of the volume function
* COLORED engine sweep vs an independent sequential Gauss-Seidel loop
* physical invariants (volume conservation under drop/squash, stability)
* state plumbing (lambda_tet lifecycle, checkpoint, health scrub)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from softbodysimulation_tpu.core.config import (LambdaMode, SolveMode,
                                                SolverConfig)
from softbodysimulation_tpu.core.state import (is_finite,
                                               state_from_topology)
from softbodysimulation_tpu.ops import tet_volume as tv
from softbodysimulation_tpu.solvers import general
from softbodysimulation_tpu.topology import build as B
from softbodysimulation_tpu.topology import lattice as L
from softbodysimulation_tpu.topology import mesh as M
from softbodysimulation_tpu.topology import tets as T


# ------------------------------------------------------------- builders
def test_kuhn_subdivision_fills_cube():
    res = 4
    pos = L.lattice_points(res)
    tt = T.fix_orientation(pos, T.cube_lattice_tets(res))
    assert tt.shape == (6 * (res - 1) ** 3, 4)
    v6 = T.tet_volumes6(pos, tt)
    assert (v6 > 0).all()
    # the 6-tet path subdivision tiles each cell exactly: total volume = 1
    np.testing.assert_allclose(v6.sum() / 6.0, 1.0, rtol=1e-12)


def test_kuhn_tets_are_distinct_and_valid():
    tt = T.cube_lattice_tets(3)
    # four distinct vertices per tet
    assert all(len(set(row)) == 4 for row in tt.tolist())
    # no duplicated tets
    assert len(np.unique(np.sort(tt, axis=1), axis=0)) == len(tt)


def test_boundary_faces_count_and_orientation():
    res = 4
    pos = L.lattice_points(res)
    tt = T.fix_orientation(pos, T.cube_lattice_tets(res))
    faces = T.boundary_faces(tt)
    # each of the 6 cube faces: (res-1)^2 squares x 2 triangles
    assert faces.shape == (12 * (res - 1) ** 2, 3)
    # outward orientation => divergence-theorem volume matches the tet sum
    surf_v6 = 6.0 * M.signed_volume(pos, faces)
    np.testing.assert_allclose(surf_v6, T.tet_volumes6(pos, tt).sum(),
                               rtol=1e-9)


def test_fix_orientation_flips_negatives():
    pos = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], float)
    bad = np.array([[0, 1, 3, 2]], np.int32)      # negative orientation
    fixed = T.fix_orientation(pos, bad)
    assert (T.tet_volumes6(pos, fixed) > 0).all()
    good = np.array([[0, 1, 2, 3]], np.int32)
    np.testing.assert_array_equal(T.fix_orientation(pos, good), good)


def test_fix_orientation_rejects_degenerate():
    pos = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0]], float)
    with pytest.raises(ValueError):
        T.fix_orientation(pos, np.array([[0, 1, 2, 3]], np.int32))


def test_tet_edges_unique_sorted():
    tt = np.array([[0, 1, 2, 3], [1, 2, 3, 4]], np.int32)
    e = T.tet_edges(tt)
    assert e.shape == (9, 2)                      # 6 + 6 - 3 shared
    assert (e[:, 0] < e[:, 1]).all()
    assert len(np.unique(e, axis=0)) == len(e)


def test_centroid_fan_fills_closed_surface():
    m = M.icosphere(1, radius=0.5)
    verts, tt = T.tets_from_surface_centroid(m.vertices, m.triangles)
    assert len(verts) == len(m.vertices) + 1
    assert len(tt) == len(m.triangles)
    v6 = T.tet_volumes6(verts, tt)
    assert (v6 > 0).all()
    # fan volume equals the surface's signed volume
    np.testing.assert_allclose(
        v6.sum() / 6.0, M.signed_volume(m.vertices, m.triangles), rtol=1e-9)
    # boundary of the fan is the original surface (same sorted-face set)
    bf = np.sort(T.boundary_faces(tt), axis=1)
    ref = np.sort(np.asarray(m.triangles), axis=1)
    assert (np.unique(bf, axis=0) == np.unique(ref, axis=0)).all()


# ------------------------------------------------------------ constraint
def test_tet_gradients_match_autodiff():
    rng = np.random.default_rng(0)
    p = jnp.asarray(rng.normal(size=(4, 3)), jnp.float32)

    def vol6(pflat):
        q = pflat.reshape(4, 3)
        return tv.tet_volume6(q[0], q[1], q[2], q[3])

    auto = jax.grad(vol6)(p.reshape(-1)).reshape(4, 3)
    cfg = SolverConfig()
    _, g0, g1, g2, g3 = tv.tet_delta_lambda(
        p[0], p[1], p[2], p[3], 1.0, 1.0, 1.0, 1.0,
        jnp.float32(0.0), jnp.float32(0.0), jnp.float32(0.0), 1 / 60., cfg)
    analytic = jnp.stack([g0, g1, g2, g3])
    np.testing.assert_allclose(np.asarray(auto), np.asarray(analytic),
                               rtol=1e-4, atol=1e-5)


def test_single_tet_projection_restores_volume():
    # one rigid (compliance 0) tet squashed to half height: repeated
    # projection must converge back to the rest volume
    pos = jnp.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 0.5]],
                      jnp.float32)
    rest6 = jnp.float32(1.0)                      # unsquashed: 6V = 1
    cfg = SolverConfig()
    lam = jnp.float32(0.0)
    p = pos
    for _ in range(30):
        dl, g0, g1, g2, g3 = tv.tet_delta_lambda(
            p[0], p[1], p[2], p[3], 1.0, 1.0, 1.0, 1.0,
            rest6, jnp.float32(0.0), lam, 1 / 60., cfg)
        lam = lam + dl
        p = p.at[0].add(dl * g0).at[1].add(dl * g1) \
             .at[2].add(dl * g2).at[3].add(dl * g3)
    v6 = tv.tet_volume6(p[0], p[1], p[2], p[3])
    np.testing.assert_allclose(float(v6), 1.0, rtol=1e-5)


def test_pinned_tet_is_skipped():
    pos = jnp.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 0.5]],
                      jnp.float32)
    cfg = SolverConfig()
    dl, *_ = tv.tet_delta_lambda(
        pos[0], pos[1], pos[2], pos[3], 0.0, 0.0, 0.0, 0.0,
        jnp.float32(1.0), jnp.float32(0.0), jnp.float32(0.0), 1 / 60., cfg)
    assert float(dl) == 0.0


# ----------------------------------------------------- engine integration
def _tet_cube_setup(res=3, compliance=1e-6, **cfg_kw):
    pos = L.lattice_points(res) + np.array([0, 1.0, 0])
    tt = T.fix_orientation(pos, T.cube_lattice_tets(res))
    topo = B.build_topology(pos, T.tet_edges(tt), 1e-4, tets=tt,
                            tet_compliance=compliance,
                            triangles=T.boundary_faces(tt))
    cfg_kw.setdefault("substeps", 2)
    cfg_kw.setdefault("iterations", 4)
    cfg = SolverConfig(enable_tet_volume=True, **cfg_kw)
    state = state_from_topology(topo, pos)
    return state, topo, cfg


def _sequential_tet_sweep(pred, inv_mass, topo, lam, dt, cfg):
    """Independent scalar Gauss-Seidel sweep in color-major order (the
    ordering the engine's COLORED mode batches)."""
    pred = np.asarray(pred, np.float64).copy()
    inv_mass = np.asarray(inv_mass)
    tets = np.asarray(topo.tets)
    rest = np.asarray(topo.rest_tet_volumes)
    comp = np.asarray(topo.tet_compliance)
    lam = np.asarray(lam, np.float64).copy()
    ids_all = np.asarray(topo.tcol_tet_ids)
    val_all = np.asarray(topo.tcol_valid)
    for c in range(topo.num_tet_colors):
        for tid in ids_all[c][val_all[c] > 0]:
            i0, i1, i2, i3 = tets[tid]
            p0, p1, p2, p3 = pred[i0], pred[i1], pred[i2], pred[i3]
            e1, e2, e3 = p1 - p0, p2 - p0, p3 - p0
            g1 = np.cross(e2, e3)
            g2 = np.cross(e3, e1)
            g3 = np.cross(e1, e2)
            g0 = -(g1 + g2 + g3)
            c_val = e1 @ g1 - cfg.tet_pressure * rest[tid]
            alpha = comp[tid] / (dt * dt)
            denom = (inv_mass[i0] * (g0 @ g0) + inv_mass[i1] * (g1 @ g1)
                     + inv_mass[i2] * (g2 @ g2) + inv_mass[i3] * (g3 @ g3)
                     + alpha)
            if denom <= cfg.eps_denominator:
                continue
            dl = (-c_val - alpha * lam[tid]) / denom
            lam[tid] += dl
            pred[i0] += inv_mass[i0] * dl * g0
            pred[i1] += inv_mass[i1] * dl * g1
            pred[i2] += inv_mass[i2] * dl * g2
            pred[i3] += inv_mass[i3] * dl * g3
    return pred, lam


def test_colored_sweep_matches_sequential_gs():
    # squash the cube so every tet is violated, then compare ONE colored
    # sweep against the independent sequential color-major loop
    state, topo, cfg = _tet_cube_setup(res=3)
    rng = np.random.default_rng(1)
    pred = np.asarray(state.positions) * np.array([1.0, 0.7, 1.0]) \
        + 0.01 * rng.normal(size=state.positions.shape)
    pred = jnp.asarray(pred, jnp.float32)
    lam = jnp.zeros((topo.n_tets,), jnp.float32)
    dt = 1 / 120.
    got_pred, got_lam = general._solve_tets_colored(
        pred, lam, state.inv_mass, topo, cfg, dt)
    want_pred, want_lam = _sequential_tet_sweep(
        pred, state.inv_mass, topo, lam, dt, cfg)
    np.testing.assert_allclose(np.asarray(got_pred), want_pred,
                               rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(np.asarray(got_lam), want_lam,
                               rtol=2e-4, atol=1e-7)


@pytest.mark.parametrize("mode", [SolveMode.COLORED, SolveMode.JACOBI])
def test_tet_cube_drop_conserves_volume(mode):
    state, topo, cfg = _tet_cube_setup(res=4, solve_mode=mode,
                                       substeps=4, iterations=6)
    v0 = float(np.asarray(topo.rest_tet_volumes).sum())
    step = general.make_step(topo, cfg, 1 / 60., n_steps=60)
    out = step(state)
    assert bool(is_finite(out))
    from softbodysimulation_tpu.ops.tet_volume import tet_volumes6
    v = float(np.asarray(tet_volumes6(out.positions, topo.tets)).sum())
    # dropped + settled on the floor: total volume within 1%
    assert abs(v / v0 - 1.0) < 0.01
    # actually resting on the floor, not exploded
    ymin = float(np.asarray(out.positions)[:, 1].min())
    assert -0.01 < ymin < 0.2


def test_tet_volume_resists_squash_vs_disabled():
    # same squashed cube relaxed with and without the tet family: the tet
    # run must recover strictly more volume
    state, topo, cfg = _tet_cube_setup(res=3, substeps=1, iterations=10,
                                       gravity=(0.0, 0.0, 0.0))
    squashed = state.replace(
        positions=state.positions * jnp.asarray([1.0, 0.6, 1.0]))
    from softbodysimulation_tpu.ops.tet_volume import tet_volumes6
    v0 = float(np.asarray(topo.rest_tet_volumes).sum())
    out_on = general.make_step(topo, cfg, 1 / 60., n_steps=20)(squashed)
    cfg_off = cfg.replace(enable_tet_volume=False)
    out_off = general.make_step(topo, cfg_off, 1 / 60., n_steps=20)(squashed)
    v_on = float(np.asarray(tet_volumes6(out_on.positions, topo.tets)).sum())
    v_off = float(np.asarray(
        tet_volumes6(out_off.positions, topo.tets)).sum())
    assert abs(v_on / v0 - 1.0) < 0.02
    assert abs(v_on / v0 - 1.0) < abs(v_off / v0 - 1.0)


def test_tet_pressure_inflates():
    state, topo, cfg = _tet_cube_setup(res=3, substeps=2, iterations=8,
                                       gravity=(0.0, 0.0, 0.0),
                                       tet_pressure=1.2)
    # distance constraints soft so the inflation can actually win
    topo = topo.replace(compliance=topo.compliance * 0 + 1e-2)
    out = general.make_step(topo, cfg, 1 / 60., n_steps=40)(state)
    from softbodysimulation_tpu.ops.tet_volume import tet_volumes6
    v0 = float(np.asarray(topo.rest_tet_volumes).sum())
    v = float(np.asarray(tet_volumes6(out.positions, topo.tets)).sum())
    assert v / v0 > 1.1


@pytest.mark.parametrize("mode", [LambdaMode.RESET, LambdaMode.DECAY,
                                  LambdaMode.WARM_START])
def test_lambda_tet_lifecycle_runs(mode):
    state, topo, cfg = _tet_cube_setup(res=3, lambda_mode=mode)
    out = general.make_step(topo, cfg, 1 / 60., n_steps=5)(state)
    assert bool(is_finite(out))
    assert out.lambda_tet is not None
    assert out.lambda_tet.shape == (topo.n_tets,)


def test_tet_scene_builders():
    from softbodysimulation_tpu.core import scenes
    for name in ("tet_cube", "tet_ball"):
        state, step, info = scenes.SCENES[name]()
        out = step(state)
        assert bool(is_finite(out))
        assert info["topology"].n_tets > 0
    state, step, info = scenes.solid_lattice(res=5)
    out = step(state)
    assert bool(is_finite(out))
    assert out.lambda_tet.shape == (6 * 5 ** 3,)


def test_checkpoint_roundtrip_with_tets(tmp_path):
    from softbodysimulation_tpu.io import checkpoint as ckpt
    state, topo, cfg = _tet_cube_setup(res=3)
    out = general.make_step(topo, cfg, 1 / 60., n_steps=3)(state)
    path = str(tmp_path / "tet.npz")
    ckpt.save(path, out)
    loaded = ckpt.load(path)
    np.testing.assert_array_equal(np.asarray(loaded.lambda_tet),
                                  np.asarray(out.lambda_tet))
    # tet-free states still round-trip with lambda_tet absent -> None
    from softbodysimulation_tpu.core import scenes
    st2, _, _ = scenes.cpu_cube()
    path2 = str(tmp_path / "plain.npz")
    ckpt.save(path2, st2)
    assert ckpt.load(path2).lambda_tet is None


def test_health_scrub_covers_lambda_tet():
    from softbodysimulation_tpu.diag.health import scrub
    state, topo, cfg = _tet_cube_setup(res=3)
    bad = state.replace(
        lambda_tet=jnp.full((topo.n_tets,), jnp.nan, jnp.float32))
    fixed = scrub(bad)
    assert bool(jnp.isfinite(fixed.lambda_tet).all())


def test_tet_rollout_is_differentiable():
    """The tet family is plain jnp in the general engine, so whole-rollout
    autodiff works: the gradient of final height w.r.t. initial upward
    velocity must be positive and finite."""
    state, topo, cfg = _tet_cube_setup(res=3, gravity=(0.0, -9.81, 0.0),
                                       solve_mode=SolveMode.JACOBI)
    step = general.make_step(topo, cfg, 1 / 60., n_steps=10)

    def loss(v_up):
        st = state.replace(
            velocities=state.velocities + jnp.asarray([0.0, 1.0, 0.0])
            * v_up)
        out = step(st)
        return out.positions[:, 1].mean()

    g = jax.grad(loss)(jnp.float32(0.5))
    assert bool(jnp.isfinite(g))
    assert float(g) > 0.0


# ------------------------------------------------- stencil lattice engine
def test_kuhn_paths_positively_oriented_as_written():
    # the stencil engine consumes the path offsets directly (no
    # fix_orientation pass), so every path must be positive as written
    pos = L.lattice_points(3)
    v6 = T.tet_volumes6(pos, T.cube_lattice_tets(3))
    assert (v6 > 0).all()


def test_stencil_tet_sweep_matches_general():
    from softbodysimulation_tpu.solvers import lattice as lat

    res = 5
    spec = L.lattice_spec(res, braced=True)
    pos = L.lattice_points(res) + np.array([0, 1.0, 0])
    tt = T.cube_lattice_tets(res)
    cfg = SolverConfig(substeps=2, iterations=3,
                       solve_mode=SolveMode.JACOBI, enable_tet_volume=True,
                       tet_compliance=0.0, ground_height=0.0)
    rng = np.random.default_rng(0)
    pred = (pos * np.array([1.0, 0.8, 1.0])
            + 0.01 * rng.normal(size=pos.shape)).astype(np.float32)
    w = np.ones(len(pos), np.float32)
    topo = B.build_topology(pos, T.tet_edges(tt), 1e-4, tets=tt,
                            tet_compliance=0.0)
    gp, gl = general._solve_tets_jacobi(
        jnp.asarray(pred), jnp.zeros((topo.n_tets,), jnp.float32),
        jnp.asarray(w), topo, cfg, 1 / 120., jnp.float32(1.0))
    r2 = res * res
    paths, valid_np, tdeg_np, rest6 = lat._tet_fields(spec)
    tet_dev = (paths, jnp.asarray(valid_np), jnp.asarray(tdeg_np), rest6)
    sp, sl = lat._tet_sweep(
        jnp.asarray(pred.T.reshape(3, res, r2)),
        jnp.asarray(w.reshape(res, r2)),
        jnp.zeros((6, res, r2), jnp.float32), spec, cfg, 1 / 120., tet_dev,
        1.0)
    np.testing.assert_allclose(np.asarray(sp).reshape(3, -1).T,
                               np.asarray(gp), atol=5e-7)
    # stencil lambda fields map to the general per-tet order: path-major
    # over cells in meshgrid-ij order (cube_lattice_tets' construction)
    c = res - 1
    cells = np.arange(res ** 3).reshape(res, res, res)[
        :c, :c, :c].reshape(-1)
    sl_np = np.asarray(sl).reshape(6, -1)
    sl_per_tet = np.concatenate([sl_np[p][cells] for p in range(6)])
    np.testing.assert_allclose(sl_per_tet, np.asarray(gl), atol=1e-6)
    # per-particle tet degrees agree too
    np.testing.assert_array_equal(np.asarray(tdeg_np).reshape(-1),
                                  np.asarray(topo.tet_degree))


def test_stencil_solid_lattice_drop_conserves_volume():
    from softbodysimulation_tpu.solvers import lattice as lat

    res = 5
    spec = L.lattice_spec(res, braced=True)
    st = lat.make_lattice_state(spec, center=(0, 1.0, 0), tet_volume=True)
    cfg = SolverConfig(substeps=4, iterations=6, damping=0.02,
                       solve_mode=SolveMode.JACOBI, enable_tet_volume=True,
                       ground_height=0.0, friction=0.3)
    out = lat.make_step(spec, cfg, 1 / 60., n_steps=60)(st)
    assert bool(is_finite(out))
    assert out.lambda_tet.shape == (6 * res ** 3,)
    tt = T.cube_lattice_tets(res)
    p0 = L.lattice_points(res, center=(0, 1.0, 0))
    v0 = T.tet_volumes6(p0, tt).sum()
    v = float(np.asarray(tv.tet_volumes6(
        out.positions, jnp.asarray(tt))).sum())
    y = np.asarray(out.positions)[:, 1]
    assert abs(v / v0 - 1.0) < 0.01
    assert -0.01 < y.min() < 0.05
    assert y.max() - y.min() > 0.9        # resting, not pancaked


@pytest.mark.parametrize("mode", [LambdaMode.RESET, LambdaMode.DECAY,
                                  LambdaMode.WARM_START])
def test_stencil_tet_lifecycle_runs(mode):
    from softbodysimulation_tpu.solvers import lattice as lat

    spec = L.lattice_spec(4, braced=True)
    st = lat.make_lattice_state(spec, center=(0, 1.0, 0), tet_volume=True)
    cfg = SolverConfig(substeps=2, iterations=2, lambda_mode=mode,
                       lambda_decay=0.98, solve_mode=SolveMode.JACOBI,
                       enable_tet_volume=True, ground_height=0.0)
    out = lat.make_step(spec, cfg, 1 / 60., n_steps=5)(st)
    assert bool(is_finite(out))
    # a tet-free state through the same engine stays tet-free
    st_plain = lat.make_lattice_state(spec, center=(0, 1.0, 0))
    out_plain = lat.make_step(spec, cfg, 1 / 60., n_steps=2)(st_plain)
    assert out_plain.lambda_tet is None


def test_windowed_build_renumbers_tets():
    res = 3
    pos = L.lattice_points(res) + np.array([0, 1.0, 0])
    tt = T.fix_orientation(pos, T.cube_lattice_tets(res))
    pos2, topo = B.build_windowed_topology(
        pos, T.tet_edges(tt), 1e-4, tets=tt, tet_compliance=1e-6,
        triangles=T.boundary_faces(tt))
    assert topo.n_tets == len(tt)
    # renumbered tets measure the same rest volumes on the permuted
    # positions (orientation preserved by relabeling)
    v6 = T.tet_volumes6(pos2, np.asarray(topo.tets))
    np.testing.assert_allclose(np.sort(v6),
                               np.sort(T.tet_volumes6(pos, tt)), rtol=1e-5)
    B.validate_topology(topo)


# -------------------------------------------------- windowed tet backend
def _windowed_tet_backend_setup(res=5, **cfg_kw):
    pos0 = L.lattice_points(res) + np.array([0, 1.0, 0])
    tt = T.fix_orientation(pos0, T.cube_lattice_tets(res))
    pos, topo = B.build_windowed_topology(
        pos0, T.tet_edges(tt), 1e-4, tets=tt, tet_compliance=0.0,
        triangles=T.boundary_faces(tt))
    cfg_kw.setdefault("substeps", 4)
    cfg_kw.setdefault("iterations", 4)
    cfg_kw.setdefault("solve_mode", SolveMode.JACOBI)
    cfg_kw.setdefault("distance_backend", "windowed")
    cfg_kw.setdefault("ground_height", 0.0)
    # inflate: the tet family does real work from step one, so the
    # windowed-vs-gather comparison (and its tets-off discriminator)
    # exercise meaningful corrections
    cfg_kw.setdefault("tet_pressure", 1.3)
    cfg = SolverConfig(enable_tet_volume=True, **cfg_kw)
    return state_from_topology(topo, pos), topo, cfg


def test_windowed_tets_match_gather():
    """tet_backend='windowed' (4-endpoint signed one-hot sweeps over
    topo.tet_windows) == the gather sweep.  dot_oh's exact one-hot
    discipline makes the two paths agree to fp-reassociation noise
    (measured 6e-6 over 20 contact steps on CPU)."""
    state, topo, cfg = _windowed_tet_backend_setup()
    assert topo.tet_windows is not None and topo.tet_window_perm is not None
    out_g = general.make_step(topo, cfg, 1 / 60., n_steps=20)(state)
    out_w = general.make_step(topo, cfg.replace(tet_backend="windowed"),
                              1 / 60., n_steps=20)(state)
    d = np.abs(np.asarray(out_w.positions)
               - np.asarray(out_g.positions)).max()
    assert bool(is_finite(out_w))
    assert d < 1e-4, f"windowed tet sweep diverges from gather: {d}"
    dl = np.abs(np.asarray(out_w.lambda_tet)
                - np.asarray(out_g.lambda_tet)).max()
    assert dl < 1e-3, f"windowed tet multipliers diverge: {dl}"
    # discriminator: tets-off differs clearly, so the tolerance cannot
    # mask a silently-skipped family
    out_off = general.make_step(
        topo, cfg.replace(enable_tet_volume=False), 1 / 60., n_steps=20)(
            state.replace(lambda_tet=state.lambda_tet))
    d_off = np.abs(np.asarray(out_w.positions)
                   - np.asarray(out_off.positions)).max()
    assert d_off > 1e-3


def test_windowed_tets_centroid_fan_matches():
    """Small centroid fans fit the window bound (the hub span is the whole
    mesh, but the mesh is small) and must match the gather sweep's
    mass-splitting hub behavior."""
    verts, tt = T.tets_from_surface_centroid(M.icosphere(1).vertices,
                                             M.icosphere(1).triangles)
    pos, topo = B.build_windowed_topology(
        verts.astype(np.float32), T.tet_edges(tt), 1e-4, tets=tt,
        tet_compliance=0.0)
    assert topo.tet_windows is not None
    state = state_from_topology(topo, pos)
    cfg = SolverConfig(enable_tet_volume=True, substeps=2, iterations=4,
                       solve_mode=SolveMode.JACOBI,
                       distance_backend="windowed", tet_pressure=1.5)
    out_g = general.make_step(topo, cfg, 1 / 60., n_steps=10)(state)
    out_w = general.make_step(topo, cfg.replace(tet_backend="windowed"),
                              1 / 60., n_steps=10)(state)
    d = np.abs(np.asarray(out_w.positions)
               - np.asarray(out_g.positions)).max()
    assert bool(is_finite(out_w))
    assert d < 1e-4, f"fan windowed diverges from gather: {d}"


def test_windowed_tets_guard_without_windows():
    state, topo, cfg = _tet_cube_setup(res=3)   # plain build: no windows
    with pytest.raises(ValueError, match="tet windows"):
        general.make_step(topo, cfg.replace(tet_backend="windowed",
                                            solve_mode=SolveMode.JACOBI),
                          1 / 60.)(state)
