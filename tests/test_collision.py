"""Collision subsystems: floor semantics, sphere SDF, self-collision."""

import numpy as np
import pytest

from softbodysimulation_tpu import (
    FloorMode,
    SolveMode,
    SolverConfig,
    state_from_topology,
)
from softbodysimulation_tpu.ops import collision as col_ops
from softbodysimulation_tpu.ops import spatial_hash
from softbodysimulation_tpu.solvers import general
from softbodysimulation_tpu.topology import build, lattice, mesh

DT = 0.02


def test_floor_xpbd_projection_unit():
    import jax.numpy as jnp

    cfg = SolverConfig(friction=0.0)
    pred = jnp.array([[0.0, -0.3, 0.0], [0.0, 0.5, 0.0]])
    prev = jnp.array([[0.0, 0.1, 0.0], [0.0, 0.6, 0.0]])
    w = jnp.array([1.0, 1.0])
    out = col_ops.floor_project_xpbd(pred, prev, w, DT, cfg)
    out = np.asarray(out)
    assert np.isclose(out[0, 1], 0.0, atol=1e-6)   # projected to ground
    assert np.isclose(out[1, 1], 0.5)              # untouched above ground


def test_floor_friction_damps_tangential():
    import jax.numpy as jnp

    cfg = SolverConfig(friction=1.0)
    pred = jnp.array([[0.5, -0.1, 0.0]])
    prev = jnp.array([[0.0, 0.0, 0.0]])
    w = jnp.array([1.0])
    out = np.asarray(col_ops.floor_project_xpbd(pred, prev, w, DT, cfg))
    # with full friction the tangential displacement is removed entirely
    assert abs(out[0, 0]) < 0.5


def test_sphere_sdf_pushes_out():
    import jax.numpy as jnp

    cfg = SolverConfig(
        friction=0.0, sphere_colliders=((0.0, 0.0, 0.0, 1.0),))
    pred = jnp.array([[0.5, 0.0, 0.0], [2.0, 0.0, 0.0]])
    prev = pred
    w = jnp.array([1.0, 1.0])
    out = np.asarray(col_ops.sphere_sdf_project(pred, prev, w, DT, cfg))
    assert np.isclose(np.linalg.norm(out[0]), 1.0, atol=1e-5)
    assert np.allclose(out[1], [2.0, 0.0, 0.0])


def test_drop_on_sphere_collider():
    pos = lattice.lattice_points(3, size=(0.5, 0.5, 0.5), center=(0, 2.0, 0))
    edges, comp = lattice.lattice_edges(3)
    topo = build.build_topology(pos, edges, comp)
    cfg = SolverConfig(
        substeps=2, iterations=8, damping=0.02, solve_mode=SolveMode.JACOBI,
        ground_height=-5.0, sphere_colliders=((0.0, 0.0, 0.0, 1.0),),
        friction=0.5)
    state = state_from_topology(topo, pos)
    step = general.make_step(topo, cfg, DT, n_steps=150)
    state = step(state)
    p = np.asarray(state.positions)
    assert np.isfinite(p).all()
    r = np.linalg.norm(p, axis=1)
    assert r.min() > 0.97  # nothing inside the sphere


def _project(backend, pred, w, cfg):
    if backend == "sorted":
        order = spatial_hash.morton_order(pred, cfg)
        return np.asarray(spatial_hash.self_collision_project_sorted(
            pred, w, order, cfg))
    if backend == "blocked":
        order = spatial_hash.morton_order(pred, cfg)
        return np.asarray(spatial_hash.self_collision_project_blocked(
            pred, w, order, cfg))
    if backend == "dense":
        return np.asarray(spatial_hash.self_collision_project_dense(
            pred, w, cfg))
    return np.asarray(spatial_hash.self_collision_project(pred, w, cfg))


@pytest.mark.parametrize("backend", ["hash", "sorted", "dense", "blocked"])
def test_self_collision_separates_overlap(backend):
    import jax.numpy as jnp

    cfg = SolverConfig(particle_radius=0.1, self_collision_omega=1.0)
    pred = jnp.array([[0.0, 0.0, 0.0], [0.05, 0.0, 0.0], [3.0, 0.0, 0.0]])
    w = jnp.array([1.0, 1.0, 1.0])
    out = _project(backend, pred, w, cfg)
    d01 = np.linalg.norm(out[1] - out[0])
    assert d01 > 0.05 + 1e-4          # pushed apart
    assert np.allclose(out[2], [3.0, 0.0, 0.0], atol=1e-6)  # far particle untouched


@pytest.mark.parametrize("backend", ["hash", "sorted", "dense", "blocked"])
def test_self_collision_respects_pinning(backend):
    import jax.numpy as jnp

    cfg = SolverConfig(particle_radius=0.1, self_collision_omega=1.0)
    pred = jnp.array([[0.0, 0.0, 0.0], [0.05, 0.0, 0.0]])
    w = jnp.array([0.0, 1.0])  # first pinned
    out = _project(backend, pred, w, cfg)
    assert np.allclose(out[0], 0.0, atol=1e-7)
    assert out[1, 0] > 0.05


def test_sorted_matches_hash_on_random_cloud():
    """With a window wide enough to cover every real pair, the sorted pass
    must produce the same correction as the exact hash pass."""
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    pred = jnp.asarray(rng.uniform(0, 0.6, (128, 3)), jnp.float32)
    w = jnp.ones(128)
    cfg = SolverConfig(particle_radius=0.05, self_collision_omega=1.0,
                       sorted_window=127, hash_cell_capacity=64)
    a = _project("hash", pred, w, cfg)
    b = _project("sorted", pred, w, cfg)
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_dense_matches_hash_on_random_cloud():
    """The two exact backends (27-cell hash gather vs all-pairs matmul)
    must agree on a dense random cloud, including with pinned particles and
    a block size that forces row padding."""
    import jax.numpy as jnp

    rng = np.random.default_rng(7)
    n = 203  # deliberately not a multiple of dense_row_block
    pred = jnp.asarray(rng.uniform(0, 0.7, (n, 3)), jnp.float32)
    w = jnp.asarray((rng.uniform(size=n) > 0.1).astype(np.float32))
    cfg = SolverConfig(particle_radius=0.05, self_collision_omega=1.0,
                       hash_cell_capacity=64, dense_row_block=64)
    a = _project("hash", pred, w, cfg)
    b = _project("dense", pred, w, cfg)
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


def test_blocked_matches_dense_on_random_cloud():
    """The blocked backend restricts the dense math to AABB-proximate
    Morton blocks; with zero candidate overflow it must be EXACT — same
    nonzero pair terms as the all-pairs dense pass (the skipped far pairs
    contribute exact 0.0), including pinned particles and a cloud size
    that forces block padding."""
    import jax.numpy as jnp

    rng = np.random.default_rng(11)
    n = 517  # not a multiple of collision_block_size
    pred = jnp.asarray(rng.uniform(0, 1.0, (n, 3)), jnp.float32)
    w = jnp.asarray((rng.uniform(size=n) > 0.1).astype(np.float32))
    cfg = SolverConfig(particle_radius=0.05, self_collision_omega=1.0,
                       collision_block_size=64, block_neighbors=16,
                       dense_row_block=64)
    order = spatial_hash.morton_order(pred, cfg)
    over = int(spatial_hash.self_collision_blocked_overflow(
        pred, w, order, cfg))
    assert over == 0, f"test cloud overflows candidate budget by {over}"
    a = _project("dense", pred, w, cfg)
    b = _project("blocked", pred, w, cfg)
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_blocked_overflow_diagnostic():
    """A too-small block_neighbors budget must be detectable (the pass is
    then approximate); a generous budget reports zero."""
    import jax.numpy as jnp

    rng = np.random.default_rng(5)
    # one dense clump: every block's AABB touches every other block's
    pred = jnp.asarray(rng.uniform(0, 0.08, (256, 3)), jnp.float32)
    w = jnp.ones(256)
    cfg_small = SolverConfig(particle_radius=0.05, collision_block_size=16,
                             block_neighbors=2)
    order = spatial_hash.morton_order(pred, cfg_small)
    over = int(spatial_hash.self_collision_blocked_overflow(
        pred, w, order, cfg_small))
    assert over > 0
    cfg_big = cfg_small.replace(block_neighbors=16)
    assert int(spatial_hash.self_collision_blocked_overflow(
        pred, w, order, cfg_big)) == 0


@pytest.mark.parametrize("backend", ["hash", "sorted", "dense", "blocked"])
def test_two_bodies_dont_interpenetrate(backend):
    """Two cube8 bodies dropped into each other with self-collision on."""
    pos_a = mesh.cube_corners(0.5) + np.array([0, 1.0, 0], np.float32)
    pos_b = mesh.cube_corners(0.5) + np.array([0.1, 1.8, 0.05], np.float32)
    pos = np.concatenate([pos_a, pos_b])
    e = lattice.cube8_edges()
    edges = np.concatenate([e, e + 8])
    topo = build.build_topology(pos, edges, compliance=1e-4)
    cfg = SolverConfig(
        substeps=2, iterations=10, damping=0.05, solve_mode=SolveMode.JACOBI,
        ground_height=0.0, enable_self_collision=True, particle_radius=0.12,
        self_collision_backend=backend,
        friction=0.3)
    state = state_from_topology(topo, pos)
    step = general.make_step(topo, cfg, DT, n_steps=200)
    state = step(state)
    p = np.asarray(state.positions)
    assert np.isfinite(p).all()
    # min cross-body particle distance stays near 2*radius
    d = np.linalg.norm(p[:8, None, :] - p[None, 8:, :], axis=-1)
    assert d.min() > 0.12  # no deep interpenetration


@pytest.mark.parametrize("mode",
                         [FloorMode.XPBD_INEQUALITY,
                          FloorMode.VELOCITY_REFLECT])
def test_floor_modes_both_rest_on_ground(mode):
    pos = mesh.cube_corners(1.0) + np.array([0, 1.5, 0], np.float32)
    topo = build.build_topology(pos, lattice.cube8_edges(), compliance=1e-4)
    cfg = SolverConfig(substeps=2, iterations=10, damping=0.05,
                       solve_mode=SolveMode.JACOBI, floor_mode=mode,
                       ground_height=0.0, friction=0.4)
    state = state_from_topology(topo, pos)
    step = general.make_step(topo, cfg, DT, n_steps=400)
    state = step(state)
    y = np.asarray(state.positions)[:, 1]
    assert y.min() > -5e-3
    assert y.min() < 0.05  # actually resting on the floor


def test_box_sdf_pushes_out_nearest_face():
    import jax.numpy as jnp

    cfg = SolverConfig(friction=0.0,
                       box_colliders=((0.0, 0.0, 0.0, 1.0, 0.5, 1.0),))
    pred = jnp.array([
        [0.2, 0.4, 0.0],    # inside, nearest face = +y
        [-0.9, 0.0, 0.0],   # inside, nearest face = -x
        [2.0, 0.0, 0.0],    # outside, untouched
    ])
    w = jnp.array([1.0, 1.0, 1.0])
    out = np.asarray(col_ops.box_sdf_project(pred, pred, w, DT, cfg))
    assert np.isclose(out[0, 1], 0.5, atol=1e-6)      # pushed to top face
    assert np.isclose(out[0, 0], 0.2)                  # other axes intact
    assert np.isclose(out[1, 0], -1.0, atol=1e-6)      # pushed to -x face
    assert np.allclose(out[2], [2.0, 0.0, 0.0])


def test_drop_on_box_collider():
    pos = mesh.cube_corners(0.6) + np.array([0, 2.0, 0], np.float32)
    topo = build.build_topology(pos, lattice.cube8_edges(), compliance=1e-4)
    cfg = SolverConfig(substeps=2, iterations=8, damping=0.05,
                       solve_mode=SolveMode.JACOBI,
                       gravity_is_acceleration=True,
                       ground_height=-5.0, friction=0.4,
                       box_colliders=((0.0, 0.0, 0.0, 1.0, 0.5, 1.0),))
    from softbodysimulation_tpu import state_from_topology
    state = state_from_topology(topo, pos)
    from softbodysimulation_tpu.solvers import general as gen
    step = gen.make_step(topo, cfg, DT, n_steps=300)
    state = step(state)
    p = np.asarray(state.positions)
    assert np.isfinite(p).all()
    # rests on the box top (y=0.5), not fallen to the low ground
    assert p[:, 1].min() > 0.45


def test_box_collider_engines_agree():
    """CLAUDE.md invariant: engines agree on config semantics — the box
    collider must act identically in the general and lattice engines."""
    from softbodysimulation_tpu.solvers import lattice as lat_engine
    from softbodysimulation_tpu.topology import lattice as lattice_mod

    res = 4
    spec = lattice_mod.lattice_spec(res, braced=True)
    # COLORED: the exactness mode (the engines' JACOBI schemes differ by
    # design — per-edge degree scaling + Chebyshev vs per-family relax)
    cfg = SolverConfig(substeps=2, iterations=4, damping=0.05,
                       solve_mode=SolveMode.COLORED,
                       gravity_is_acceleration=True,
                       ground_height=-5.0, friction=0.4,
                       box_colliders=((0.0, 0.0, 0.0, 1.5, 0.5, 1.5),))
    state_l = lat_engine.make_lattice_state(spec, center=(0, 1.8, 0))
    out_l = lat_engine.make_step(spec, cfg, DT, n_steps=200)(state_l)
    pl = np.asarray(out_l.positions)
    assert np.isfinite(pl).all()
    assert pl[:, 1].min() > 0.45  # rests on the box top

    pos = lattice_mod.lattice_points(res, center=(0, 1.8, 0))
    e, c = lattice_mod.lattice_edges(res, braced=True)
    colors = lattice_mod.lattice_family_colors(res, braced=True)
    topo = build.build_topology(pos, e, c, colors=colors)
    state_g = state_from_topology(topo, pos)
    out_g = general.make_step(topo, cfg, DT, n_steps=200)(state_g)
    d = np.abs(pl - np.asarray(out_g.positions)).max()
    assert d < 1e-3, f"box-collider engine divergence {d}"


def test_hilbert_code_bijective_and_continuous():
    """The round-5 space-filling curve upgrade: Skilling-transform Hilbert
    codes must be a bijection on the cell cube and step between
    face-adjacent cells (the locality property the blocked backend's
    worst-touch bound rides on; Morton's quadrant seams broke it)."""
    import itertools

    import jax.numpy as jnp

    b = 3
    g = 1 << b
    coords = np.array(list(itertools.product(range(g), repeat=3)),
                      dtype=np.int32)
    code = np.asarray(spatial_hash._hilbert_code(
        jnp.asarray(coords), b=b))
    assert len(np.unique(code)) == g ** 3
    walk = coords[np.argsort(code)]
    steps = np.abs(np.diff(walk.astype(int), axis=0)).sum(axis=1)
    assert (steps == 1).all()


def test_blocked_dropped_pairs_pair_accurate_gate():
    """The pair-accurate exactness check: on a scene where the
    conservative AABB worst-touch bound overflows but no real pair is
    missed, dropped_pairs must read 0 and the blocked projection must
    match dense to boundary noise; shrinking M until real pairs drop
    must flip both."""
    import jax.numpy as jnp

    rng = np.random.default_rng(1)
    clump = rng.normal(0, 0.02, (600, 3)).astype(np.float32)
    clump2 = clump + np.array([0.03, 0, 0], np.float32)
    gx, gz = np.meshgrid(np.arange(40), np.arange(40), indexing="ij")
    sheet = np.stack([gx.ravel() * 0.05 + 1.0, np.zeros(1600),
                      gz.ravel() * 0.05], 1).astype(np.float32)
    pos = np.concatenate([clump, clump2, sheet]).astype(np.float32)
    n = pos.shape[0]
    cfg = SolverConfig(substeps=1, iterations=1,
                       solve_mode=SolveMode.JACOBI,
                       enable_self_collision=True,
                       self_collision_backend="blocked",
                       collision_block_size=128, block_neighbors=12,
                       particle_radius=0.01, ground_height=0.0)
    p = jnp.asarray(pos)
    w = jnp.asarray(np.ones(n, np.float32))
    order = spatial_hash.morton_order(p, cfg)
    dense = np.asarray(spatial_hash.self_collision_project_dense(p, w, cfg))

    # M=12: AABB bound overflows (flat sheet blocks all touch in the thin
    # axis) yet no real pair is dropped -> coverage-identical to dense
    ovf = int(spatial_hash.self_collision_blocked_overflow(p, w, order, cfg))
    dropped = int(spatial_hash.self_collision_blocked_dropped_pairs(
        p, w, order, cfg))
    assert ovf > 0, "scene should exceed the conservative bound"
    assert dropped == 0
    out = np.asarray(spatial_hash.self_collision_project_blocked(
        p, w, order, cfg))
    assert np.abs(out - dense).max() < 5e-5  # Gram-boundary noise only

    # M=3: really drops contact pairs -> diagnostic fires and the
    # projection visibly diverges from dense
    cfg3 = cfg.replace(block_neighbors=3)
    dropped3 = int(spatial_hash.self_collision_blocked_dropped_pairs(
        p, w, order, cfg3))
    assert dropped3 > 0
    out3 = np.asarray(spatial_hash.self_collision_project_blocked(
        p, w, order, cfg3))
    assert np.abs(out3 - dense).max() > 1e-3


@pytest.mark.parametrize("pinned", [False, True], ids=["free", "pinned"])
@pytest.mark.parametrize("seed", [21, 22, 23])
def test_blocked_matches_dense_with_padding(seed, pinned):
    """The all-pairs dense and the Morton-blocked backend with no dropped
    pair give one projection on a cloud whose size pads both the dense row
    blocks and the Morton blocks (hash vs dense:
    test_dense_matches_hash_on_random_cloud)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    n = 777
    pred = jnp.asarray(rng.uniform(0, 0.8, (n, 3)), jnp.float32)
    w = np.ones(n, np.float32)
    if pinned:
        w[rng.uniform(size=n) < 0.15] = 0.0
    w = jnp.asarray(w)
    cfg = SolverConfig(particle_radius=0.04, self_collision_omega=1.0,
                       dense_row_block=128,
                       collision_block_size=64, block_neighbors=16)
    order = spatial_hash.morton_order(pred, cfg)
    assert int(spatial_hash.self_collision_blocked_dropped_pairs(
        pred, w, order, cfg)) == 0
    dense = _project("dense", pred, w, cfg)
    assert np.abs(dense - np.asarray(pred)).max() > 1e-3   # real contact
    # boundary noise only, as in test_blocked_dropped_pairs_pair_accurate_gate
    np.testing.assert_allclose(_project("blocked", pred, w, cfg), dense,
                               rtol=0, atol=5e-5)
    if pinned:
        fixed = np.asarray(w) == 0
        np.testing.assert_array_equal(dense[fixed], np.asarray(pred)[fixed])
