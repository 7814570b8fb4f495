"""Differentiable rollout factories (kernels/diff.py): each forward is the
XLA engine it wraps, and ``jax.grad`` through it agrees with a central
finite difference of the same loss — over pins, warm-start lambda chains,
tets, bending, volume, static and kinematic colliders, self-contact,
per-body masses and materials — and ``remat_chunk`` reproduces the flat
scan's gradients."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree

from softbodysimulation_tpu import (LambdaMode, SolveMode, SolverConfig,
                                    make_colliders, state_from_topology)
from softbodysimulation_tpu.kernels import diff as kdiff
from softbodysimulation_tpu.parallel import batch as pbatch
from softbodysimulation_tpu.solvers import general
from softbodysimulation_tpu.solvers import lattice as lat_engine
from softbodysimulation_tpu.topology import build, lattice, mesh
from softbodysimulation_tpu.topology.edges import unique_edges

DT_SUB = 1.0 / 240.0


def fd_check(loss, x0, h, rtol):
    """jax.grad of ``loss`` along its own direction vs the central finite
    difference with step ``h`` (float32 throughout)."""
    flat0, unravel = ravel_pytree(x0)

    def f(v):
        return loss(unravel(v))

    g = np.asarray(jax.grad(f)(flat0))
    assert np.isfinite(g).all()
    assert np.abs(g).max() > 0, "gradient is all zero"
    d = g / np.linalg.norm(g)
    dd = float(np.linalg.norm(g))
    fd = (float(f(flat0 + h * d)) - float(f(flat0 - h * d))) / (2 * h)
    assert abs(fd - dd) <= rtol * abs(dd), (dd, fd)
    return dd, fd


# --------------------------------------------------------------- scenes
def _lat_cfg(**kw):
    base = dict(substeps=2, iterations=2, damping=0.01,
                solve_mode=SolveMode.JACOBI, lambda_mode=LambdaMode.RESET,
                gravity_is_acceleration=True, ground_height=-5.0)
    base.update(kw)
    return SolverConfig(**base)


def _sphere(**kw):
    m = mesh.icosphere(1)
    pos, topo = build.build_windowed_topology(
        m.vertices, unique_edges(m.triangles), 1e-4, triangles=m.triangles,
        **kw)
    return pos + np.array([0, 0.5, 0], np.float32), topo


def _mesh_cfg(**kw):
    base = dict(substeps=2, iterations=2, damping=0.01,
                solve_mode=SolveMode.JACOBI, jacobi_rho=0.0,
                distance_backend="windowed", ground_height=-2.0)
    base.update(kw)
    return SolverConfig(**base)


def _with_v0(st, v0):
    return st.replace(velocities=jnp.broadcast_to(v0, st.velocities.shape))


V0 = np.asarray([0.3, 0.1, -0.2], np.float32)


# ------------------------------------------------ lattice factories
LATTICE_RUNNER_CASES = {
    "plain": ({}, {}),
    "tets": (dict(enable_tet_volume=True), {"tets": True}),
    "pins": ({}, {"pins": True}),
    "warm_start": (dict(lambda_mode=LambdaMode.WARM_START, lambda_decay=1.0),
                   {}),
    "decay_colored": (dict(solve_mode=SolveMode.COLORED,
                           lambda_mode=LambdaMode.DECAY), {}),
}


@pytest.mark.parametrize("case", list(LATTICE_RUNNER_CASES))
def test_lattice_diff_runner_grads_match_fd(case):
    kw, opt = LATTICE_RUNNER_CASES[case]
    spec = lattice.lattice_spec(3, braced=True)
    cfg = _lat_cfg(**kw)
    st = lat_engine.make_lattice_state(spec, center=(0, 0.7, 0),
                                       tet_volume=opt.get("tets", False))
    if opt.get("pins"):
        st = st.replace(inv_mass=st.inv_mass.at[:3].set(0.0))
    run = kdiff.make_differentiable_lattice_runner(spec, cfg, DT_SUB, 6)
    # the forward IS the stencil engine's raw-substep rollout
    ref = lat_engine.make_substep_runner(spec, cfg, DT_SUB, 6)
    np.testing.assert_array_equal(np.asarray(run(st).positions),
                                  np.asarray(ref(st).positions))

    def loss(v0):
        return jnp.sum(run(_with_v0(st, v0)).positions[:, 0] ** 2)

    fd_check(loss, V0, h=1e-2, rtol=2e-2)


def test_static_and_kinematic_collider_grads_agree():
    """A static config sphere and the same sphere as a traced ColliderSet
    are one projection: their gradients through contact are identical."""
    spec = lattice.lattice_spec(3, braced=True)
    sphere = (0.0, 0.2, 0.0, 0.3)
    cfg_static = _lat_cfg(sphere_colliders=(sphere,))
    st = lat_engine.make_lattice_state(spec, center=(0, 0.7, 0))
    kin = st.replace(colliders=make_colliders(spheres=[sphere],
                                              ground_height=-5.0))
    run_s = kdiff.make_differentiable_lattice_runner(spec, cfg_static,
                                                     DT_SUB, 6)
    run_k = kdiff.make_differentiable_lattice_runner(spec, _lat_cfg(),
                                                     DT_SUB, 6)
    g_s = jax.grad(lambda v: jnp.sum(
        run_s(_with_v0(st, v)).positions[:, 0] ** 2))(jnp.asarray(V0))
    g_k = jax.grad(lambda v: jnp.sum(
        run_k(_with_v0(kin, v)).positions[:, 0] ** 2))(jnp.asarray(V0))
    assert np.isfinite(np.asarray(g_s)).all()
    np.testing.assert_allclose(np.asarray(g_s), np.asarray(g_k),
                               rtol=1e-5, atol=1e-7)


def test_lattice_step_ext_force_grads_match_fd():
    """Control workload: gradients w.r.t. ext_force through the full-step
    rollout (force consumed on the first substep of each frame)."""
    spec = lattice.lattice_spec(3, braced=True)
    cfg = _lat_cfg()
    st = lat_engine.make_lattice_state(spec, center=(0, 0.7, 0))
    run = kdiff.make_differentiable_lattice_step(spec, cfg, 1 / 60, 3)

    def loss(f):
        s = st.replace(ext_force=jnp.broadcast_to(f, st.ext_force.shape))
        return jnp.sum(run(s).positions[:, 1])

    fd_check(loss, np.asarray([0.0, 2e-1, 0.1], np.float32), h=1e-1,
             rtol=2e-2)


def test_lattice_step_kinematic_pose_grads_match_fd():
    """Gradient w.r.t. a kinematic sphere's traced pose through contact."""
    spec = lattice.lattice_spec(3, braced=True)
    cfg = _lat_cfg(ground_height=0.0, friction=0.3)
    st = lat_engine.make_lattice_state(spec, center=(0, 0.55, 0))
    coll = make_colliders(spheres=[(-0.6, 0.5, 0.0, 0.3)], ground_height=0.0)
    run = kdiff.make_differentiable_lattice_step(spec, cfg, 1 / 60, 3)

    def loss(c):
        s = st.replace(colliders=coll.with_sphere(0, center=c,
                                                  velocity=(1.0, 0.0, 0.0)))
        return jnp.sum(run(s).positions[:, 0])

    fd_check(loss, np.asarray([-0.62, 0.5, 0.03], np.float32), h=2e-3,
             rtol=5e-2)


# --------------------------------------------------- mesh factories
MESH_RUNNER_CASES = {
    "plain": ({}, {}, {}),
    "pins": ({}, {}, {"pins": True}),
    "warm_start": (dict(lambda_mode=LambdaMode.WARM_START), {}, {}),
    "cheby_decay": (dict(jacobi_rho=0.9, lambda_mode=LambdaMode.DECAY),
                    {}, {}),
    "gather": (dict(distance_backend="gather"), {}, {}),
    "volume": (dict(enable_volume=True, pressure=1.1), {}, {}),
}


@pytest.mark.parametrize("case", list(MESH_RUNNER_CASES))
def test_mesh_diff_runner_grads_match_fd(case):
    kw, topo_kw, opt = MESH_RUNNER_CASES[case]
    pos, topo = _sphere(**topo_kw)
    cfg = _mesh_cfg(**kw)
    st = state_from_topology(topo, pos)
    if opt.get("pins"):
        st = st.replace(inv_mass=st.inv_mass.at[np.array([0, 5])].set(0.0))
    run = kdiff.make_differentiable_mesh_runner(topo, cfg, DT_SUB, 4)

    def hand(state):
        for _ in range(4):
            state = general._substep(state, topo, cfg, DT_SUB,
                                     apply_ext=False)
        return state

    np.testing.assert_allclose(np.asarray(run(st).positions),
                               np.asarray(jax.jit(hand)(st).positions),
                               atol=1e-6)

    def loss(v0):
        return jnp.sum(run(_with_v0(st, v0)).positions ** 2)

    fd_check(loss, V0, h=1e-2, rtol=2e-2)


def test_mesh_diff_runner_colored_bending_grads():
    """COLORED exact-GS mode with bending stays differentiable."""
    m = mesh.icosphere(1)
    pos, topo = build.topology_from_mesh(
        m, compliance=1e-4, bending=True, bend_compliance=1e-3,
        windowed="colored")
    cfg = _mesh_cfg(solve_mode=SolveMode.COLORED, enable_bending=True)
    st = state_from_topology(topo, pos + np.array([0, 0.5, 0], np.float32))
    run = kdiff.make_differentiable_mesh_runner(topo, cfg, DT_SUB, 4)

    def loss(scale):
        return jnp.sum(run(st.replace(
            positions=st.positions * scale)).positions ** 2)

    fd_check(loss, np.float32(1.02), h=1e-3, rtol=2e-2)


def test_mesh_diff_runner_kinematic_pose_grads():
    """Collider-pose cotangents: a kinematic sphere pushing into the body,
    gradient w.r.t. its traced centre."""
    pos, topo = _sphere()
    cfg = _mesh_cfg(friction=0.3)
    coll = make_colliders(spheres=[(0.0, -0.2, 0.0, 0.4)], ground_height=-2.0)
    st = state_from_topology(topo, pos)
    run = kdiff.make_differentiable_mesh_runner(topo, cfg, DT_SUB, 4)

    def loss(c):
        s = st.replace(colliders=coll.with_sphere(0, center=c))
        return jnp.sum(run(s).positions[:, 1])

    fd_check(loss, np.asarray([0.02, -0.2, 0.01], np.float32), h=2e-3,
             rtol=5e-2)


def test_mesh_step_grads_match_fd():
    """Full-step mesh rollout (ext-force lifecycle)."""
    pos, topo = _sphere()
    cfg = _mesh_cfg()
    st = state_from_topology(topo, pos)
    run = kdiff.make_differentiable_mesh_step(topo, cfg, 1 / 120, 2)
    np.testing.assert_array_equal(
        np.asarray(run(st).positions),
        np.asarray(general.make_step(topo, cfg, 1 / 120, 2)(st).positions))

    def loss(f):
        s = st.replace(ext_force=jnp.broadcast_to(f, st.ext_force.shape))
        return jnp.sum(run(s).positions[:, 1])

    fd_check(loss, np.asarray([0.0, 0.5, 0.2], np.float32), h=1e-1,
             rtol=2e-2)


def test_mesh_step_self_collision_cadence_grads():
    """Self-colliding scenes stay differentiable: dense contact with a
    contact cadence inside the full-step rollout."""
    pos, topo = _sphere()
    cfg = _mesh_cfg(substeps=4, enable_self_collision=True,
                    self_collision_backend="dense", self_collision_every=2,
                    particle_radius=0.08)
    st = state_from_topology(topo, pos)
    run = kdiff.make_differentiable_mesh_step(topo, cfg, 1 / 120, 2)

    def loss(scale):
        return jnp.sum(run(st.replace(
            positions=st.positions * scale)).positions ** 2)

    fd_check(loss, np.float32(0.9), h=1e-3, rtol=2e-2)


def _mat_setup():
    pos, topo = _sphere()
    return topo, _mesh_cfg(), state_from_topology(topo, pos)


@pytest.mark.parametrize("key,h", [("rest_lengths", 1e-2),
                                   ("compliance", 3e-5)])
def test_material_grads_match_fd(key, h):
    """System identification over MATERIALS: rest lengths and compliance
    are traced inputs of the rollout."""
    topo, cfg, st = _mat_setup()
    run = kdiff.make_differentiable_material_runner(topo, cfg, DT_SUB, 4)
    # the topology's own materials reproduce the plain runner
    np.testing.assert_array_equal(
        np.asarray(run(st, {"rest_lengths": topo.rest_lengths,
                            "compliance": topo.compliance}).positions),
        np.asarray(kdiff.make_differentiable_mesh_runner(
            topo, cfg, DT_SUB, 4)(st).positions))

    mats = {"rest_lengths": topo.rest_lengths * 1.05,
            "compliance": topo.compliance * 2.0}

    def loss(x):
        return jnp.sum(run(st, {**mats, key: x}).positions ** 2)

    fd_check(loss, mats[key], h=h, rtol=1e-2)


def test_material_fit_descends():
    """Three gradient steps on perturbed rest lengths move the loss down —
    the material-fitting loop runs end-to-end."""
    topo, cfg, st = _mat_setup()
    run = kdiff.make_differentiable_material_runner(topo, cfg, DT_SUB, 4)

    def rollout_pos(rest):
        return run(st, {"rest_lengths": rest,
                        "compliance": topo.compliance}).positions

    target = rollout_pos(topo.rest_lengths)

    def loss(rest):
        return jnp.sum((rollout_pos(rest) - target) ** 2)

    rest = topo.rest_lengths * 1.1
    l0 = cur = float(loss(rest))
    vg = jax.value_and_grad(loss)
    for _ in range(3):
        lv, g = vg(rest)
        lr = 0.25 * lv / float(jnp.sum(g * g))
        for _ in range(8):
            trial = rest - lr * g
            lt = float(loss(trial))
            if lt < lv:
                rest, cur = trial, lt
                break
            lr *= 0.25
    assert cur < l0 * 0.9, (l0, cur)


def _batch_shared_mass(st, nb):
    """Batched SimState with the shared (n,) inv_mass leaf."""
    def z(x):
        return jnp.broadcast_to(x[None], (nb,) + x.shape)

    return st.replace(positions=z(st.positions), velocities=z(st.velocities),
                      ext_force=z(st.ext_force),
                      lambda_dist=z(st.lambda_dist),
                      lambda_bend=z(st.lambda_bend))


def test_material_ensemble_grads_match_vmapped_engine():
    """Heterogeneous-material farm: per-body gradients equal the single-
    body material runner's, and bodies with different stiffness get
    different gradients."""
    topo, cfg, st = _mat_setup()
    nb = 2
    batched = _batch_shared_mass(st, nb)
    mats = {"rest_lengths": jnp.stack([topo.rest_lengths * s
                                       for s in (1.0, 1.08)]),
            "compliance": jnp.stack([topo.compliance * s
                                     for s in (1.0, 4.0)])}
    farm = kdiff.make_differentiable_material_ensemble_runner(
        topo, cfg, DT_SUB, 4)
    one = kdiff.make_differentiable_material_runner(topo, cfg, DT_SUB, 4)
    g = jax.grad(lambda m: jnp.sum(farm(batched, m).positions ** 2))(mats)
    for b in range(nb):
        mb = {k: v[b] for k, v in mats.items()}
        gb = jax.grad(lambda m: jnp.sum(one(st, m).positions ** 2))(mb)
        for k in mb:
            np.testing.assert_allclose(np.asarray(g[k][b]),
                                       np.asarray(gb[k]), rtol=1e-4,
                                       atol=1e-7, err_msg=k)
    gr = np.asarray(g["rest_lengths"])
    assert np.abs(gr[0] - gr[1]).max() > 1e-6


@pytest.mark.parametrize("shared_mass", [False, True])
def test_mesh_ensemble_diff_runner_mass_grads(shared_mass):
    """Gradients w.r.t. per-body (B, n) masses — or the shared (n,) leaf,
    whose cotangent sums over bodies — match central differences."""
    pos, topo = _sphere()
    cfg = _mesh_cfg()
    st = state_from_topology(topo, pos)
    nb = 2
    batched = _batch_shared_mass(st, nb).replace(
        positions=_batch_shared_mass(st, nb).positions
        + jnp.asarray([[[0.0, 0.0, 0.0]], [[0.3, 0.1, 0.0]]]))
    run = kdiff.make_differentiable_mesh_ensemble_runner(topo, cfg, DT_SUB, 4)
    im0 = (st.inv_mass if shared_mass
           else jnp.stack([st.inv_mass * s for s in (1.0, 1.5)]))

    def loss(im):
        return jnp.sum(run(batched.replace(inv_mass=im)).positions ** 2)

    fd_check(loss, im0, h=0.3, rtol=2e-2)


def test_volume_ensemble_matches_single_bodies():
    """Volume-enabled ensembles carry a (B,) lambda_volume; each row
    matches its single-body rollout."""
    pos, topo = _sphere()
    cfg = _mesh_cfg(enable_volume=True, pressure=1.1)
    st = state_from_topology(topo, pos)
    nb = 2
    batched = pbatch.stack_states([
        st, st.replace(positions=st.positions * 1.05)])
    out = kdiff.make_differentiable_mesh_ensemble_runner(
        topo, cfg, DT_SUB, 4)(batched)
    one = kdiff.make_differentiable_mesh_runner(topo, cfg, DT_SUB, 4)
    assert out.lambda_volume.shape == (nb,)
    for b in range(nb):
        want = one(pbatch.body_slice(batched, b))
        np.testing.assert_allclose(np.asarray(out.positions[b]),
                                   np.asarray(want.positions), atol=1e-6)


# ------------------------------------------------------- remat_chunk
def _remat_cases():
    spec = lattice.lattice_spec(3, braced=True)
    lcfg = _lat_cfg()
    lst = lat_engine.make_lattice_state(spec, center=(0, 0.7, 0))
    pos, topo = _sphere()
    mcfg = _mesh_cfg()
    mst = state_from_topology(topo, pos)
    mats = {"rest_lengths": topo.rest_lengths * 1.03,
            "compliance": topo.compliance}
    two = pbatch.stack_states([mst, mst.replace(
        positions=mst.positions + 0.1)])
    return {
        "lattice_runner": (
            lambda k: kdiff.make_differentiable_lattice_runner(
                spec, lcfg, DT_SUB, 8, remat_chunk=k),
            lambda run, v: run(_with_v0(lst, v)).positions[:, 0]),
        "lattice_step": (
            lambda k: kdiff.make_differentiable_lattice_step(
                spec, lcfg, 1 / 60, 4, remat_chunk=k),
            lambda run, v: run(_with_v0(lst, v)).positions[:, 1]),
        "mesh_runner": (
            lambda k: kdiff.make_differentiable_mesh_runner(
                topo, mcfg, DT_SUB, 8, remat_chunk=k),
            lambda run, v: run(_with_v0(mst, v)).positions ** 2),
        "mesh_step": (
            lambda k: kdiff.make_differentiable_mesh_step(
                topo, mcfg, 1 / 120, 4, remat_chunk=k),
            lambda run, v: run(_with_v0(mst, v)).positions ** 2),
        "material_runner": (
            lambda k: kdiff.make_differentiable_material_runner(
                topo, mcfg, DT_SUB, 8, remat_chunk=k),
            lambda run, v: run(_with_v0(mst, v), mats).positions ** 2),
        "mesh_ensemble": (
            lambda k: kdiff.make_differentiable_mesh_ensemble_runner(
                topo, mcfg, DT_SUB, 8, remat_chunk=k),
            lambda run, v: run(two.replace(velocities=jnp.broadcast_to(
                v, two.velocities.shape))).positions ** 2),
    }


@pytest.mark.parametrize("name", ["lattice_runner", "lattice_step",
                                  "mesh_runner", "mesh_step",
                                  "material_runner", "mesh_ensemble"])
def test_remat_chunk_grads_match_flat(name):
    """Chunked-checkpoint reverse mode replays identical arithmetic, so
    gradients match the flat scan to fp precision while bounding memory to
    O(N/K + K) carries; a chunk that does not divide the horizon is
    refused."""
    make, out = _remat_cases()[name]
    grads = {}
    for k in (0, 2):
        run = make(k)
        grads[k] = np.asarray(jax.grad(
            lambda v: jnp.sum(out(run, v)))(jnp.asarray(V0)))
    np.testing.assert_allclose(grads[0], grads[2], rtol=1e-6,
                               atol=1e-6 * np.abs(grads[0]).max())
    assert np.abs(grads[0]).max() > 1e-4
    with pytest.raises(ValueError, match="divide"):
        make(3)
