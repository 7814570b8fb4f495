"""The five BASELINE example configs run end-to-end (scaled down)."""

import numpy as np

from softbodysimulation_tpu.examples import (
    config1_cube_drop,
    config2_icosphere_pinned,
    config3_inflated_ball,
    config4_interactive_poke,
    config5_batch_1024,
    config7_mesh_farm,
    config9_tet_solid,
    config10_material_fit,
)


def test_config1_cube_drop():
    state = config1_cube_drop.run(res=4, steps=150, verbose=False)
    p = np.asarray(state.positions)
    assert np.isfinite(p).all()
    assert p[:, 1].min() > -5e-3
    assert p[:, 1].max() - p[:, 1].min() > 0.9


def test_config2_icosphere_pinned():
    state, topo = config2_icosphere_pinned.run(
        subdivisions=1, steps=150, verbose=False)
    p = np.asarray(state.positions)
    assert np.isfinite(p).all()
    # hangs from pinned cap: top stays at ~2.0, nothing below ground
    assert p[:, 1].max() > 1.8
    assert p[:, 1].min() > -1e-3


def test_config3_inflated_ball():
    from softbodysimulation_tpu.ops.volume import enclosed_volume

    state, topo = config3_inflated_ball.run(
        subdivisions=1, steps=200, pressure=1.15, verbose=False)
    p = np.asarray(state.positions)
    assert np.isfinite(p).all()
    v0 = float(np.asarray(topo.rest_volume))
    v = float(enclosed_volume(state.positions, topo.triangles))
    assert v > 1.05 * v0              # actually inflated
    r = np.linalg.norm(p, axis=1)
    assert r.min() > 0.75             # resting on the sphere collider


def test_config4_interactive_poke():
    state, topo = config4_interactive_poke.run(
        res=3, steps=150, verbose=False)
    p = np.asarray(state.positions)
    assert np.isfinite(p).all()
    assert p[:, 1].min() > -5e-3


def test_config5_batch():
    batched, normals = config5_batch_1024.run(
        n_bodies=16, res=3, steps=60, verbose=False)
    p = np.asarray(batched.positions)
    assert p.shape[0] == 16
    assert np.isfinite(p).all()
    n = np.asarray(normals)
    assert np.allclose(np.linalg.norm(n, axis=-1), 1.0, atol=1e-3)


def test_config6_diffsim_optimizes():
    from softbodysimulation_tpu.examples import config6_diffsim

    v0, history = config6_diffsim.run(res=3, steps=40, opt_iters=25,
                                      verbose=False)
    assert np.isfinite(v0).all()
    assert history[-1] < 0.1 * history[0]  # loss actually optimised
    assert v0[0] > 0.1  # learned to launch toward +x


def test_config7_mesh_farm():
    out, out2 = config7_mesh_farm.run(n_bodies=4, steps=60, verbose=False)
    p = np.asarray(out.positions)
    assert np.isfinite(p).all()
    assert p[..., 1].min() > -5e-3
    p2 = np.asarray(out2.positions)
    assert np.isfinite(p2).all()


def test_config9_tet_solid():
    from softbodysimulation_tpu.ops.tet_volume import tet_volumes6

    state, topo = config9_tet_solid.run(res=4, steps=120, verbose=False)
    p = np.asarray(state.positions)
    assert np.isfinite(p).all()
    assert p[:, 1].min() > -5e-3          # resting on the floor
    v0 = float(np.asarray(topo.rest_tet_volumes).sum())
    v = float(np.asarray(tet_volumes6(state.positions, topo.tets)).sum())
    assert abs(v / v0 - 1.0) < 0.02       # solid volume preserved


def test_config10_material_fit():
    l0, l1, err0, err1 = config10_material_fit.run(
        subdiv=1, n_substeps=4, opt_iters=4, verbose=False)
    assert np.isfinite(l1)
    assert l1 < 0.5 * l0          # trajectory loss shrinks
    assert err1 < err0            # materials move toward truth


def test_config11_collider_control():
    """Contact-rich control: gradient descent on a kinematic sphere's
    sweep parameters shoves the soft cube's COM toward the target."""
    from softbodysimulation_tpu.examples import config11_collider_control

    params, hist = config11_collider_control.run(
        res=4, steps=40, opt_iters=6, verbose=False)
    assert np.isfinite(params).all()
    assert np.isfinite(hist).all()
    assert hist[-1] < 0.6 * hist[0]   # loss shrinks through contact
