"""Batching (vmap) and multi-chip sharding (shard_map over the 8-device CPU
mesh) — the capability axis the reference lacks entirely (SURVEY §2.4)."""

import numpy as np
import pytest

import jax

from softbodysimulation_tpu import LambdaMode, SolveMode, SolverConfig
from softbodysimulation_tpu.parallel import batch as pbatch
from softbodysimulation_tpu.solvers import lattice as lat_engine
from softbodysimulation_tpu.topology import lattice

DT = 0.02


def cfg_default(**kw):
    base = dict(substeps=2, iterations=2, damping=0.02,
                solve_mode=SolveMode.JACOBI, ground_height=0.0, friction=0.3,
                lambda_mode=LambdaMode.WARM_START, lambda_decay=1.0)
    base.update(kw)
    return SolverConfig(**base)


def make_ensemble(n_bodies, res=3, braced=True):
    spec = lattice.lattice_spec(res, braced=braced)
    states = []
    rng = np.random.RandomState(0)
    for i in range(n_bodies):
        center = (rng.uniform(-1, 1), 1.0 + 0.5 * i, rng.uniform(-1, 1))
        states.append(lat_engine.make_lattice_state(spec, center=center))
    return spec, pbatch.stack_states(states)


def test_vmap_matches_loop():
    spec, batched = make_ensemble(4)
    cfg = cfg_default()
    step1 = lat_engine.make_step(spec, cfg, DT, n_steps=20)
    stepB = pbatch.make_batched_lattice_step(spec, cfg, DT, n_steps=20)
    out_b = stepB(batched)
    for i in range(4):
        single = step1(pbatch.body_slice(batched, i))
        got = np.asarray(pbatch.body_slice(out_b, i).positions)
        want = np.asarray(single.positions)
        assert np.allclose(got, want, atol=1e-5), f"body {i}"


def test_replicate_state():
    spec, _ = make_ensemble(1)
    s = lat_engine.make_lattice_state(spec, center=(0, 1, 0))
    b = pbatch.replicate_state(s, 5)
    assert b.positions.shape == (5,) + s.positions.shape


@pytest.mark.skipif(jax.device_count() < 8, reason="needs 8 devices")
class TestSharded:
    def test_sharded_matches_single_device(self):
        spec, batched = make_ensemble(16)
        cfg = cfg_default()
        mesh = pbatch.make_mesh(8)
        sharded = pbatch.shard_batched_state(batched, mesh)
        step_sharded = pbatch.make_sharded_lattice_step(
            spec, cfg, DT, mesh, n_steps=10)
        step_local = pbatch.make_batched_lattice_step(spec, cfg, DT,
                                                      n_steps=10)
        out_s = step_sharded(sharded)
        out_l = step_local(batched)
        assert np.allclose(np.asarray(out_s.positions),
                           np.asarray(out_l.positions), atol=1e-5)


    def test_sharded_ensemble_diagnostics(self):
        spec, batched = make_ensemble(16)
        mesh = pbatch.make_mesh(8)
        sharded = pbatch.shard_batched_state(batched, mesh)
        diag = pbatch.make_sharded_ensemble_diagnostics(mesh)
        vmax, bad, height, ground = diag(sharded)
        assert float(vmax) == 0.0       # initial ensemble at rest
        assert int(bad) == 0
        assert np.isfinite(float(height))

    def test_sharded_detects_nan_on_any_chip(self):
        spec, batched = make_ensemble(16)
        mesh = pbatch.make_mesh(8)
        # poison one body that lives on the last chip
        batched = batched.replace(
            positions=batched.positions.at[15, 0, 0].set(np.nan))
        sharded = pbatch.shard_batched_state(batched, mesh)
        diag = pbatch.make_sharded_ensemble_diagnostics(mesh)
        _, bad, _, _ = diag(sharded)
        assert int(bad) == 1


def test_batched_general_engine_matches_loop():
    """vmap over the general (mesh) engine: an icosphere ensemble."""
    from softbodysimulation_tpu import state_from_topology
    from softbodysimulation_tpu.topology import build, mesh

    m = mesh.icosphere(1, radius=0.4)
    pos, topo = build.topology_from_mesh(m, compliance=1e-4, bending=True,
                                         bend_compliance=1e-2)
    cfg = cfg_default(substeps=2, iterations=3, enable_bending=True)
    states = []
    for i in range(3):
        p = pos + np.array([0.3 * i, 1.0 + 0.4 * i, 0.0], np.float32)
        states.append(state_from_topology(topo, p))
    batched = pbatch.stack_states(states)
    stepB = pbatch.make_batched_general_step(topo, cfg, DT, n_steps=15)
    out_b = stepB(batched)
    from softbodysimulation_tpu.solvers import general
    step1 = general.make_step(topo, cfg, DT, n_steps=15)
    for i in range(3):
        want = np.asarray(step1(states[i]).positions)
        got = np.asarray(pbatch.body_slice(out_b, i).positions)
        assert np.allclose(got, want, atol=1e-5), f"body {i}"


def test_batched_volume_constraint():
    """vmap with the global volume constraint (per-body lambda_volume)."""
    from softbodysimulation_tpu import SolverConfig, state_from_topology
    from softbodysimulation_tpu.ops.volume import enclosed_volume
    from softbodysimulation_tpu.topology import build, mesh

    m = mesh.icosphere(1, radius=0.4)
    pos, topo = build.topology_from_mesh(m, compliance=5e-4)
    cfg = SolverConfig(substeps=2, iterations=4, damping=0.05,
                       enable_volume=True, pressure=1.2,
                       ground_height=-10.0)
    states = [state_from_topology(topo, pos + np.array([0, 2 + i, 0],
                                                       np.float32))
              for i in range(2)]
    batched = pbatch.stack_states(states)
    stepB = pbatch.make_batched_general_step(topo, cfg, DT, n_steps=100)
    out = stepB(batched)
    v0 = float(np.asarray(topo.rest_volume))
    import jax
    vols = jax.vmap(lambda p: enclosed_volume(p, topo.triangles))(
        out.positions)
    for v in np.asarray(vols):
        assert v > 1.1 * v0  # both bodies inflated


def test_lane_batched_lattice_matches_vmap():
    """The lane-folded ensemble stepper must match the vmapped engine."""
    from softbodysimulation_tpu.interact import forces
    from softbodysimulation_tpu.solvers import lattice as lat_engine

    spec, batched = make_ensemble(5, res=4)
    # give one body a pending external force to exercise the ext path
    import jax
    batched = batched.replace(
        ext_force=batched.ext_force.at[2, :, 1].set(30.0))
    cfg = cfg_default(substeps=3, iterations=2)
    wide = lat_engine.make_batched_step(spec, cfg, DT, n_bodies=5,
                                        n_steps=25)
    ref = pbatch.make_batched_lattice_step(spec, cfg, DT, n_steps=25)
    out_w = wide(batched)
    out_r = ref(batched)
    d = np.abs(np.asarray(out_w.positions) - np.asarray(out_r.positions)).max()
    assert d < 1e-5, f"lane-batched vs vmap drift {d}"
    dl = np.abs(np.asarray(out_w.lambda_dist)
                - np.asarray(out_r.lambda_dist)).max()
    assert dl < 1e-4


def test_sharded_general_mesh_ensemble_matches_vmap():
    """DP over mesh bodies across chips (windowed one-hot backend replicated
    per chip, body axis split over the 8-device virtual mesh)."""
    import jax.numpy as jnp

    from softbodysimulation_tpu import state_from_topology
    from softbodysimulation_tpu.solvers import general
    from softbodysimulation_tpu.topology import build, mesh

    m = mesh.icosphere(2)
    pos, topo = build.topology_from_mesh(m, compliance=1e-5, windowed=True)
    cfg = SolverConfig(substeps=2, iterations=3, damping=0.02,
                       solve_mode=SolveMode.JACOBI, ground_height=0.0,
                       friction=0.3)
    states = [state_from_topology(
        topo, pos + np.array([0, 1.0 + 0.1 * i, 0], np.float32))
        for i in range(16)]
    batched = pbatch.stack_states(states)

    mesh_dp = pbatch.make_mesh(8)
    sharded = pbatch.shard_batched_state(batched, mesh_dp)
    fn_sh = pbatch.make_sharded_general_step(topo, cfg, 1 / 60, mesh_dp,
                                             n_steps=4)
    out_sh = fn_sh(sharded)

    fn_v = pbatch.make_batched_general_step(topo, cfg, 1 / 60, n_steps=4)
    out_v = fn_v(batched)
    d = np.abs(np.asarray(out_sh.positions)
               - np.asarray(out_v.positions)).max()
    assert d < 1e-6, f"sharded mesh ensemble drifted from vmap: {d}"
    assert np.isfinite(np.asarray(out_sh.positions)).all()


@pytest.mark.parametrize("kin", [False, True], ids=["plain", "kinematic"])
@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_sharded_lattice_rollout_matches_vmap(n_dev, kin):
    """The DP raw-substep rollout (one slab of bodies per device, zero
    hot-loop collectives) equals the vmapped substep runner on one
    device, with and without a shared kinematic collider."""
    from softbodysimulation_tpu import make_colliders

    spec, batched = make_ensemble(n_dev, res=3)
    cfg = cfg_default(substeps=2, iterations=2)
    mesh = pbatch.make_mesh(n_dev)
    runner = lat_engine.make_substep_runner(spec, cfg, DT / 2, 12)
    sharded = pbatch.shard_batched_state(batched, mesh)
    if kin:
        coll = make_colliders(spheres=[(0.0, 1.0, 0.0, 0.6)],
                              ground_height=0.0)
        roll = pbatch.make_sharded_lattice_rollout(
            spec, cfg, DT / 2, 12, mesh, n_dev, kin_colliders=(1, 0))
        out = roll(sharded, coll)
        ref = jax.vmap(lambda s: runner(s.replace(colliders=coll)))(batched)
    else:
        roll = pbatch.make_sharded_lattice_rollout(spec, cfg, DT / 2, 12,
                                                   mesh, n_dev)
        out = roll(sharded)
        ref = jax.vmap(runner)(batched)
    d = np.abs(np.asarray(out.positions) - np.asarray(ref.positions)).max()
    assert d < 1e-6, d
    assert out.colliders is None


def test_sharded_lattice_rollout_rejects_uneven_split():
    spec, _ = make_ensemble(1)
    with pytest.raises(ValueError, match="must divide"):
        pbatch.make_sharded_lattice_rollout(spec, cfg_default(), DT, 4,
                                            pbatch.make_mesh(4), 6)


@pytest.mark.parametrize("per_body_mass,remat", [(False, 0), (True, 0),
                                                 (False, 2), (True, 2)])
def test_differentiable_sharded_mesh_rollout_matches_vmap(per_body_mass,
                                                          remat):
    """The distributed differentiable farm: forward and inv_mass
    gradients equal the vmapped general engine on one device (ext force
    consumed on the first substep, zero after; remat chunks the tail)."""
    import jax.numpy as jnp

    from softbodysimulation_tpu import state_from_topology
    from softbodysimulation_tpu.solvers import general
    from softbodysimulation_tpu.topology import build, mesh

    pos, topo = build.topology_from_mesh(mesh.icosphere(1, radius=0.4),
                                         compliance=1e-4)
    cfg = SolverConfig(substeps=5, iterations=2, damping=0.02,
                       solve_mode=SolveMode.JACOBI, ground_height=0.0,
                       friction=0.3)
    nb, n = 4, pos.shape[0]
    st = state_from_topology(topo, pos + np.array([0, 0.6, 0], np.float32))
    rng = np.random.default_rng(0)
    offs = rng.uniform(-0.2, 0.2, (nb, 1, 3)).astype(np.float32)
    ext = np.zeros((nb, n, 3), np.float32)
    ext[:, :4] = (0.0, 30.0, 0.0)
    w = np.asarray(st.inv_mass)
    w_b = np.stack([w * (1.0 + 0.2 * b) for b in range(nb)])
    batched = st.replace(
        positions=jnp.asarray(np.asarray(st.positions)[None] + offs),
        velocities=jnp.zeros((nb, n, 3)), ext_force=jnp.asarray(ext),
        lambda_dist=jnp.zeros((nb, topo.n_edges)),
        lambda_bend=jnp.zeros((nb, topo.n_hinges)),
        inv_mass=jnp.asarray(w_b if per_body_mass else w))
    mesh_dp = pbatch.make_mesh(4)
    farm = pbatch.make_differentiable_sharded_mesh_rollout(
        topo, cfg, DT / cfg.substeps, cfg.substeps, mesh_dp, nb,
        per_body_mass=per_body_mass, remat_chunk=remat)
    one = general.make_step(topo, cfg, DT)

    def ref_run(b):
        im = b.inv_mass if per_body_mass else jnp.broadcast_to(
            b.inv_mass, (nb, n))
        return jax.vmap(one)(b.replace(
            inv_mass=im, lambda_volume=jnp.zeros((nb,), jnp.float32)))

    def loss(run, im):
        return jnp.sum(run(batched.replace(inv_mass=im)).positions[..., 1])

    out, ref = farm(batched), ref_run(batched)
    assert np.abs(np.asarray(out.positions)
                  - np.asarray(ref.positions)).max() < 1e-5
    assert np.abs(np.asarray(out.ext_force)).max() == 0.0
    g = np.asarray(jax.grad(lambda im: loss(farm, im))(batched.inv_mass))
    g1 = np.asarray(jax.grad(lambda im: loss(ref_run, im))(
        batched.inv_mass))
    assert g.shape == g1.shape and np.abs(g1).max() > 0
    np.testing.assert_allclose(g, g1, rtol=1e-4, atol=1e-6)
