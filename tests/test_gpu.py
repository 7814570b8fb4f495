"""Checks that only mean something on the card (``-m gpu``).

A float32 dot at default precision may run in TF32 on an NVIDIA GPU
(about three decimal digits).  These tests pin, on the card:

* the length-3 contraction sites (tet volumes, enclosed volume, wind) ask
  for HIGHEST precision; their optimised HLO calls no GEMM library, and
  their values are full f32;
* the bf16-split one-hot contraction (``ops/mxu_exact.dot_oh``) stays
  exact;
* the blocked contact backend, whose Gram dots ask for HIGHEST
  precision, matches the dense one;
* the stencil engine matches the general engine on the same order.

Each takes the ``gpu`` fixture (tests/conftest.py), which skips it on any
other platform.  ``python chip_smoke.py`` runs them on the card.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from softbodysimulation_tpu import SolveMode, SolverConfig
from softbodysimulation_tpu import state_from_topology
from softbodysimulation_tpu.interact import forces
from softbodysimulation_tpu.ops import mxu_exact, spatial_hash, tet_volume
from softbodysimulation_tpu.ops import volume
from softbodysimulation_tpu.solvers import general
from softbodysimulation_tpu.solvers import lattice as lat_engine
from softbodysimulation_tpu.topology import build, lattice, mesh

pytestmark = pytest.mark.gpu


def _cloth():
    m = mesh.grid_plane(1.0, 12)
    pos, topo = build.topology_from_mesh(m, compliance=1e-4)
    return state_from_topology(topo, pos), topo


def _precision_sites():
    rng = np.random.default_rng(0)
    p = jnp.asarray(rng.normal(size=(4096, 3)), jnp.float32)
    tt = jnp.asarray(rng.integers(0, 4096, (8192, 4)), jnp.int32)
    tris = jnp.asarray(rng.integers(0, 4096, (8192, 3)), jnp.int32)
    st, topo = _cloth()
    return {
        "tet_volumes6": (lambda x: tet_volume.tet_volumes6(x, tt), p),
        "enclosed_volume": (lambda x: volume.enclosed_volume(x, tris), p),
        "add_wind": (lambda s: forces.add_wind(s, topo, (1.0, 0.0, 0.5))
                     .ext_force, st),
    }


@pytest.mark.parametrize("site", ["tet_volumes6", "enclosed_volume",
                                  "add_wind"])
def test_length3_contractions_call_no_gemm(gpu, site):
    fn, arg = _precision_sites()[site]
    hlo = jax.jit(fn).lower(arg).compile().as_text()
    assert "cublas" not in hlo and "triton_gemm" not in hlo, site


def test_tet_volumes_are_full_f32(gpu):
    rng = np.random.default_rng(1)
    pos = rng.normal(size=(4096, 3)).astype(np.float32)
    tt = rng.integers(0, 4096, (8192, 4)).astype(np.int32)
    got = np.asarray(tet_volume.tet_volumes6(jnp.asarray(pos),
                                             jnp.asarray(tt)))
    p = pos.astype(np.float64)[tt]
    want = np.einsum("ti,ti->t", p[:, 1] - p[:, 0],
                     np.cross(p[:, 2] - p[:, 0], p[:, 3] - p[:, 0]))
    # f32 rounding of O(1) terms: ~1e-6; TF32 would leave ~1e-3
    assert np.abs(got - want).max() < 2e-5


def test_enclosed_volume_is_full_f32(gpu):
    rng = np.random.default_rng(3)
    pos = rng.normal(size=(4096, 3)).astype(np.float32)
    tris = rng.integers(0, 4096, (8192, 3)).astype(np.int32)
    got = float(volume.enclosed_volume(jnp.asarray(pos), jnp.asarray(tris)))
    p = pos.astype(np.float64)[tris]
    want = np.einsum("ti,ti->t", p[:, 0],
                     np.cross(p[:, 1], p[:, 2])).sum() / 6.0
    # f32 sum of 8192 O(1) terms: ~1e-4 absolute; TF32 would leave ~1e-2
    assert abs(got - want) < 2e-3


def test_dot_oh_is_exact_on_card(gpu):
    rng = np.random.default_rng(2)
    w, s = 256, 384
    win = rng.uniform(-2.0, 2.0, (3, w)).astype(np.float32)
    ia, ib = rng.integers(0, w, s), rng.integers(0, w, s)
    g = np.zeros((w, s), np.float32)
    g[ib, np.arange(s)] += 1.0
    g[ia, np.arange(s)] -= 1.0
    got = mxu_exact.dot_oh(jnp.asarray(win), jnp.asarray(g, jnp.bfloat16),
                           (((1,), (0,)), ((), ())))
    want = win[:, ib] - win[:, ia]
    np.testing.assert_allclose(np.asarray(got), want, atol=5e-6)


def test_blocked_matches_dense_on_card(gpu):
    # a jittered grid at 0.07 spacing (contact diameter 0.08): every
    # neighbour overlaps, none is near-coincident.  (A uniform random
    # cloud has near-coincident pairs whose Gram-trick distance cancels
    # to noise, and the card's GEMM kernels for the dense and the blocked
    # shapes round that noise differently.)  Three far particles pad
    # both backends' blocks.
    rng = np.random.default_rng(11)
    g = np.stack(np.meshgrid(*[np.arange(16)] * 3, indexing="ij"),
                 -1).reshape(-1, 3) * 0.07
    g = g + rng.uniform(-0.005, 0.005, g.shape)
    far = 5.0 + np.arange(9).reshape(3, 3)
    pred = jnp.asarray(np.concatenate([g, far]), jnp.float32)
    n = pred.shape[0]
    w = jnp.asarray((rng.uniform(size=n) > 0.1).astype(np.float32))
    cfg = SolverConfig(particle_radius=0.04, self_collision_omega=1.0,
                       collision_block_size=128, block_neighbors=32,
                       dense_row_block=256)
    order = spatial_hash.morton_order(pred, cfg)
    assert int(spatial_hash.self_collision_blocked_dropped_pairs(
        pred, w, order, cfg)) == 0
    a = spatial_hash.self_collision_project_dense(pred, w, cfg)
    b = spatial_hash.self_collision_project_blocked(pred, w, order, cfg)
    assert float(jnp.abs(a - pred).max()) > 0.0
    # boundary noise only (tests/test_collision.py's bound)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                               atol=5e-5)


def test_stencil_matches_general_on_card(gpu):
    res = 12
    cfg = SolverConfig(substeps=2, iterations=3, damping=0.02,
                       solve_mode=SolveMode.COLORED, ground_height=0.0,
                       friction=0.3)
    spec = lattice.lattice_spec(res, braced=True)
    st_s = lat_engine.make_lattice_state(spec, center=(0, 0.7, 0))
    pos = np.asarray(st_s.positions)
    edges, comp = lattice.lattice_edges(res, braced=True)
    topo = build.build_topology(
        pos, edges, comp,
        colors=lattice.lattice_family_colors(res, braced=True))
    out_s = lat_engine.make_step(spec, cfg, 1 / 60, n_steps=10)(st_s)
    out_g = general.make_step(topo, cfg, 1 / 60, n_steps=10)(
        state_from_topology(topo, pos))
    d = float(jnp.abs(out_s.positions - out_g.positions).max())
    assert np.isfinite(np.asarray(out_s.positions)).all()
    assert d < 1e-4, d   # same constraint order: f32 reassociation only
