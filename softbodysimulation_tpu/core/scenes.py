"""Scene catalogue — the reference's five .unity scenes as build functions.

Scene = workload selection (SURVEY L9).  Each builder returns
``(state, stepper, info)`` ready to run, with the same physical setup as the
corresponding reference scene (constraint counts, iterations, compliances
from the serialized scene values, SURVEY §4.4):

  cpu_cube            <- Scenes/CpuCube.unity      (8 particles, 28
                         constraints, 30 iters, compliance 0.01)
  cpu_mesh            <- Scenes/CpuMesh.unity      (LowResBunny ~2.5k verts,
                         15 iters, compliance 1e-10, bending off, gravity -1)
  basic_micro         <- Scenes/Basic.unity        (micro InitializationMode
                         fixtures; see tests/test_micro_fixtures.py)
  gpu_substep         <- Scenes/GPUTest.unity      (welded mesh, 15 substeps
                         x 15 iterations, separate lambda buffer semantics)
  flagship            <- Scenes/SoftBodySimulator.unity (res-4 lattice, 9
                         iters, gravity 0, lambda decay 0.99, compliance
                         1e-4/1e-3/1e-2)
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Tuple

import numpy as np

from ..solvers import general as _general
from ..solvers import lattice as _lat_engine
from ..topology import build as _build
from ..topology import lattice as _lattice
from ..topology import mesh as _mesh
from ..topology.objloader import load_obj
from .config import DampingMode, FloorMode, LambdaMode, SolveMode, SolverConfig
from .state import state_from_topology

# OBJ assets are data, not code; the reference's bunny is used when present.
BUNNY_PATHS = (
    os.path.join(os.path.dirname(__file__), "..", "..", "assets",
                 "LowResBunny.obj"),
    "/root/reference/Assets/_Project/Art/Models/LowResBunny.obj",
)
SPOT_PATHS = (
    os.path.join(os.path.dirname(__file__), "..", "..", "assets",
                 "spot.obj"),
    "/root/reference/Assets/_Project/Art/Models/spot.obj",
)
FBX_BUNNY_PATHS = (
    os.path.join(os.path.dirname(__file__), "..", "..", "assets",
                 "stanford-bunny.fbx"),
    "/root/reference/Assets/_Project/Art/Models/stanford-bunny.fbx",
)


def cpu_cube(dt: float = 0.02):
    """8-corner cube with 28 hand-built constraints (SoftBodyCubeCPU +
    Scenes/CpuCube.unity: 30 iterations, compliance 0.01)."""
    pos = _mesh.cube_corners(1.0) + np.array([0, 2.0, 0], np.float32)
    topo = _build.build_topology(pos, _lattice.cube8_edges(), compliance=0.01,
                                 triangles=_lattice.cube8_triangles())
    cfg = SolverConfig(substeps=1, iterations=30, damping=0.01,
                       solve_mode=SolveMode.COLORED, ground_height=0.0,
                       friction=0.1)
    state = state_from_topology(topo, pos)
    step = _general.make_step(topo, cfg, dt)
    return state, step, {"topology": topo, "config": cfg, "dt": dt}


def cpu_mesh(dt: float = 0.02, fallback_subdiv: int = 3):
    """Bunny-mesh scene (Scenes/CpuMesh.unity: 15 iterations, compliance
    1e-10, gravity (0,-1,0), bending off, lambda clamp 1e-3).  Falls back to
    a dense icosphere when the bunny OBJ asset is absent.  Built with the
    color-major windowed ordering (the general engine's color-major
    semantics are unchanged — oracle-parity tested in
    tests/test_engine_parity.py)."""
    m = None
    for p in BUNNY_PATHS:
        if os.path.exists(p):
            m = load_obj(p)
            break
    if m is None:
        m = _mesh.icosphere(fallback_subdiv, radius=0.5)
    pos, topo = _build.topology_from_mesh(m, compliance=1e-10, bending=False,
                                          windowed="colored")
    pos = pos + np.array([0, 1.0, 0], np.float32)
    cfg = SolverConfig(substeps=1, iterations=15, damping=0.01,
                       gravity=(0.0, -1.0, 0.0),
                       solve_mode=SolveMode.COLORED, max_dlambda=1e-3,
                       ground_height=0.0, friction=0.1)
    state = state_from_topology(topo, pos)
    step = _general.make_step(topo, cfg, dt)
    return state, step, {"topology": topo, "config": cfg, "dt": dt,
                         "mesh": m}


def spot(dt: float = 0.02, fallback_subdiv: int = 3):
    """Spot-the-cow mesh scene (the reference's second OBJ workload,
    Assets/_Project/Art/Models/spot.obj: 2930 v / 5856 tri).  Same solver
    shape as cpu_mesh, run on the windowed one-hot distance backend.  Falls
    back to an icosphere when the asset is absent."""
    m = None
    for p in SPOT_PATHS:
        if os.path.exists(p):
            m = load_obj(p)
            break
    if m is None:
        m = _mesh.icosphere(fallback_subdiv, radius=0.5)
    pos, topo = _build.topology_from_mesh(m, compliance=1e-8, bending=False,
                                          windowed=True)
    pos = pos - np.array([0, float(pos[:, 1].min()) - 0.4, 0], np.float32)
    cfg = SolverConfig(substeps=2, iterations=6, damping=0.02,
                       gravity=(0.0, -1.0, 0.0),
                       solve_mode=SolveMode.JACOBI, max_dlambda=1e-3,
                       ground_height=0.0, friction=0.2)
    state = state_from_topology(topo, pos)
    step = _general.make_step(topo, cfg, dt)
    return state, step, {"topology": topo, "config": cfg, "dt": dt,
                         "mesh": m}


def stanford_bunny(dt: float = 1 / 60, fallback_subdiv: int = 4):
    """High-res Stanford bunny from the reference's FBX asset
    (Assets/_Project/Art/Models/stanford-bunny.fbx: 15,258 control points /
    30,338 triangles -> 45,598 edge constraints), loaded by our binary-FBX
    importer (topology/fbxloader.py) at Unity's serialized import scale
    (globalScale 0.005 + useFileScale, stanford-bunny.fbx.meta).  This is
    the large single-mesh workload.  Falls back to an icosphere when the
    asset is absent."""
    from ..topology.fbxloader import load_fbx

    m = None
    for p in FBX_BUNNY_PATHS:
        if os.path.exists(p):
            m = load_fbx(p, global_scale=0.005)
            break
    if m is None:
        m = _mesh.icosphere(fallback_subdiv, radius=1.2)
    pos, topo = _build.topology_from_mesh(m, compliance=1e-7, bending=False,
                                          windowed=True)
    pos = pos - np.array([0, float(pos[:, 1].min()) - 0.3, 0], np.float32)
    cfg = SolverConfig(substeps=2, iterations=4, damping=0.02,
                       gravity=(0.0, -1.0, 0.0),
                       solve_mode=SolveMode.JACOBI, max_dlambda=1e-3,
                       ground_height=0.0, friction=0.2)
    state = state_from_topology(topo, pos)
    step = _general.make_step(topo, cfg, dt)
    return state, step, {"topology": topo, "config": cfg, "dt": dt,
                         "mesh": m}


def gpu_substep(dt: float = 0.02, primitive: str = "cube"):
    """Welded-primitive substep scene (SoftBodyGPU + Scenes/GPUTest.unity:
    15 substeps x 15 iterations, per-substep lambda reset, edge + opposite
    -vertex bending distance constraints, SoftBodyGPU.cs:334-356)."""
    from ..topology import edges as _edges

    m = _mesh.cube(1.0) if primitive == "cube" else _mesh.plane(1.0)
    verts, tris, _ = _edges.weld(m.vertices, m.triangles)
    e = _edges.unique_edges(tris)
    opp = _edges.opposite_vertex_pairs(tris)
    all_edges = np.concatenate([e, opp]) if len(opp) else e
    comp = np.concatenate([
        np.zeros(len(e), np.float32),          # distanceCompliance = 0
        np.full(len(opp), 0.05, np.float32),   # bendingCompliance = 0.05
    ]) if len(opp) else np.zeros(len(e), np.float32)
    pos = verts + np.array([0, 1.5, 0], np.float32)
    topo = _build.build_topology(pos, all_edges, comp, triangles=tris)
    cfg = SolverConfig(substeps=15, iterations=15, damping=0.05,
                       solve_mode=SolveMode.COLORED,
                       lambda_mode=LambdaMode.RESET,
                       ground_height=0.0, friction=0.2)
    state = state_from_topology(topo, pos)
    step = _general.make_step(topo, cfg, dt)
    return state, step, {"topology": topo, "config": cfg, "dt": dt}


def flagship(dt: float = 1 / 60, res: int = 4, gravity_on: bool = False):
    """Flagship lattice scene (Scenes/SoftBodySimulator.unity: res 4, 9
    iterations, lambda decay 0.99, structural/shear/bend compliance
    1e-4/1e-3/1e-2; the scene serializes gravity 0)."""
    spec = _lattice.lattice_spec(res)
    cfg = SolverConfig(
        substeps=4, iterations=9, damping=0.01,
        damping_mode=DampingMode.PER_DT,
        gravity=(0.0, -9.81, 0.0) if gravity_on else (0.0, 0.0, 0.0),
        solve_mode=SolveMode.COLORED,
        lambda_mode=LambdaMode.DECAY, lambda_decay=0.99,
        max_dlambda_rel=0.1, lambda_clamp=100.0, min_alpha_tilde=1e-10,
        floor_mode=FloorMode.VELOCITY_REFLECT, ground_height=-5.0)
    state = _lat_engine.make_lattice_state(spec, center=(0.0, 0.0, 0.0))
    step = _lat_engine.make_step(spec, cfg, dt)
    return state, step, {"spec": spec, "config": cfg, "dt": dt}


def flagship_perf(dt: float = 1 / 60, res: int = 40):
    """The performance workload (bench.py): braced res-40 lattice, warm-
    started small-steps solve."""
    spec = _lattice.lattice_spec(res, braced=True)
    cfg = SolverConfig(
        substeps=8, iterations=1, damping=0.02,
        solve_mode=SolveMode.JACOBI,
        lambda_mode=LambdaMode.RESET,
        gravity_is_acceleration=True,
        fast_math=True,
        ground_height=0.0, friction=0.3)
    # particle mass 1 g: a 40-high stack of unit masses would exceed 100%
    # strain at structural compliance 1e-4 (it would pancake — physically)
    state = _lat_engine.make_lattice_state(spec, center=(0.0, 0.6, 0.0),
                                           mass=0.001)
    step = _lat_engine.make_step(spec, cfg, dt)
    return state, step, {"spec": spec, "config": cfg, "dt": dt}


def solid_lattice(dt: float = 1 / 60, res: int = 40):
    """Solid (volumetric) flagship-scale body on the STENCIL engine: the
    res-40 braced lattice with per-cell tet volume constraints — 6 Kuhn
    tets per cell as gather-free offset families
    (``solvers/lattice._tet_sweep``).  The at-scale spelling of the
    reference's commented per-cell ``AddVolumeConstraints`` intent."""
    spec = _lattice.lattice_spec(res, braced=True)
    cfg = SolverConfig(
        substeps=8, iterations=1, damping=0.02,
        solve_mode=SolveMode.JACOBI,
        lambda_mode=LambdaMode.RESET,
        gravity_is_acceleration=True,
        fast_math=True,
        enable_tet_volume=True,
        ground_height=0.0, friction=0.3)
    state = _lat_engine.make_lattice_state(spec, center=(0.0, 0.6, 0.0),
                                           mass=0.001, tet_volume=True)
    step = _lat_engine.make_step(spec, cfg, dt)
    return state, step, {"spec": spec, "config": cfg, "dt": dt}


def sphere_sweep(dt: float = 1 / 60, res: int = 8, speed: float = 2.0):
    """Kinematic rigid-collider demo: a scripted rigid sphere sweeps
    horizontally through a soft lattice slab resting on the floor — the
    capability the reference inherits from PhysX's moving colliders
    (``SoftBodyController.cs:110-118``) and its per-substep floor raycast
    (``SoftBodySimulator.cs:777-788``).  The collider pose is a traced
    ``SimState`` leaf (``core/colliders.py``): ``info["animate"]`` updates
    it per frame and the SAME compiled step program serves every pose."""
    from .colliders import make_colliders

    spec = _lattice.lattice_spec(res, braced=True)
    cfg = SolverConfig(substeps=4, iterations=2, damping=0.02,
                       solve_mode=SolveMode.JACOBI,
                       lambda_mode=LambdaMode.RESET,
                       gravity_is_acceleration=True,
                       ground_height=0.0, friction=0.3)
    state = _lat_engine.make_lattice_state(spec, center=(0.0, 0.55, 0.0),
                                           mass=0.001)
    radius, sy, x0 = 0.35, 0.5, -1.6
    state = state.replace(colliders=make_colliders(
        spheres=[(x0, sy, 0.0, radius)], ground_height=0.0))

    def animate(i, st):
        """Per-frame collider schedule (host side; the on-device spelling
        is ``interact.animator.kinematic_rollout``)."""
        x = x0 + speed * i * dt
        return st.replace(colliders=st.colliders.with_sphere(
            0, center=(x, sy, 0.0), velocity=(speed, 0.0, 0.0)))

    step = _lat_engine.make_step(spec, cfg, dt)
    return state, step, {"spec": spec, "config": cfg, "dt": dt,
                         "animate": animate}


def basic_micro(dt: float = 0.02, mode: str = "butterfly"):
    """Micro test-scenario scene (Scenes/Basic.unity: SoftBodyCPU driven by
    an InitializationMode).  ``mode`` picks one of core/fixtures.FIXTURES."""
    from .fixtures import FIXTURES

    builder = FIXTURES[mode]
    if mode == "butterfly":
        pos, topo, cfg = builder(folded=True)
    else:
        pos, topo, cfg = builder()
    state = state_from_topology(topo, pos)
    step = _general.make_step(topo, cfg, dt)
    return state, step, {"topology": topo, "config": cfg, "dt": dt}


def cloth(dt: float = 1 / 60, res: int = 16):
    """Hanging cloth: grid plane with edge + dihedral bending constraints,
    top row pinned (the canonical mesh-driven workload of the
    InitializeSoftBodyFromMesh path, exercised as cloth).  Built windowed
    (RCM-renumbered); the gather and windowed backends run it identically
    (tests/test_windowed.py)."""
    from ..interact import forces as _forces

    m = _mesh.grid_plane(1.0, res)
    # stand the plane up vertically (x stays, y <- z)
    verts = m.vertices[:, [0, 2, 1]].copy()
    verts[:, 2] *= 0.0
    mm = _mesh.TriMesh(verts, m.triangles)
    pos, topo = _build.topology_from_mesh(
        mm, compliance=1e-5, bending=True, bend_compliance=1e-3,
        windowed=True)
    pos = pos + np.array([0.0, 1.2, 0.0], np.float32)
    cfg = SolverConfig(substeps=4, iterations=2, damping=0.03,
                       solve_mode=SolveMode.JACOBI,
                       lambda_mode=LambdaMode.WARM_START, lambda_decay=1.0,
                       enable_bending=True,
                       ground_height=0.0, friction=0.4)
    state = state_from_topology(topo, pos)
    top = np.flatnonzero(pos[:, 1] > pos[:, 1].max() - 1e-4)
    state = _forces.pin_indices(state, top, pinned=True)
    step = _general.make_step(topo, cfg, dt)
    return state, step, {"topology": topo, "config": cfg, "dt": dt}


def cloth_xl(dt: float = 1 / 60, res: int = 129):
    """Large hanging cloth (default 129x129 = 16.6k particles, ~49k edge
    constraints) — the large-mesh scale the reference's CPU path cannot
    reach (SoftBodyCPU.cs is single-threaded per constraint)."""
    return cloth(dt=dt, res=res)


def tet_cube(dt: float = 1 / 60, res: int = 6):
    """Solid (tetrahedral) jelly cube dropped on the floor: every lattice
    cell carries 6 Kuhn tets with per-tet XPBD volume constraints plus edge
    distance constraints — the wired-up version of the reference's
    commented-out per-cell volume intent (``AddVolumeConstraints``,
    ``SoftBodySimulator.cs:187-212``; tet-volume helper
    ``XPBDSimulatorCS.compute:220-223``)."""
    from ..topology import tets as _tets

    pos = _lattice.lattice_points(res) + np.array([0, 1.0, 0], np.float32)
    tt = _tets.fix_orientation(pos, _tets.cube_lattice_tets(res))
    topo = _build.build_topology(
        pos, _tets.tet_edges(tt), compliance=1e-4,
        tets=tt, tet_compliance=1e-6,
        triangles=_tets.boundary_faces(tt))
    cfg = SolverConfig(substeps=4, iterations=6, damping=0.01,
                       solve_mode=SolveMode.COLORED,
                       enable_tet_volume=True,
                       ground_height=0.0, friction=0.2)
    state = state_from_topology(topo, pos)
    step = _general.make_step(topo, cfg, dt)
    return state, step, {"topology": topo, "config": cfg, "dt": dt}


def tet_ball(dt: float = 1 / 60, subdiv: int = 2):
    """Soft solid ball: icosphere surface filled with a centroid tet fan
    (``topology/tets.py:tets_from_surface_centroid``), slightly pressurized
    (tet_pressure 1.05) so it plumps against the floor — the volumetric
    sibling of the surface-pressure scene (examples/config3)."""
    from ..topology import tets as _tets

    m = _mesh.icosphere(subdiv, radius=0.5)
    verts, tt = _tets.tets_from_surface_centroid(m.vertices, m.triangles)
    # tet_compliance 0 = incompressible target: fan tets are tiny, so any
    # soft compliance's alpha~ dwarfs their gradient norms and the
    # pressurization never wins.
    pos2, topo = _build.build_windowed_topology(
        verts, _tets.tet_edges(tt), 1e-4,
        tets=tt, tet_compliance=0.0,
        triangles=_tets.boundary_faces(tt))
    pos = pos2 + np.array([0, 1.0, 0], np.float32)
    cfg = SolverConfig(substeps=4, iterations=8, damping=0.02,
                       solve_mode=SolveMode.JACOBI,
                       enable_tet_volume=True, tet_pressure=1.05,
                       ground_height=0.0, friction=0.3)
    state = state_from_topology(topo, pos)
    step = _general.make_step(topo, cfg, dt)
    return state, step, {"topology": topo, "config": cfg, "dt": dt}


def ball_on_cloth(dt: float = 1 / 60, cloth_res: int = 24,
                  ball_subdiv: int = 1, cloth_size: float = 1.2,
                  ball_radius: float = 0.18, contact_backend: str = "dense",
                  contact_every: int = 1, block_neighbors: int = 8):
    """Two soft bodies in contact: a pressurized solid ball dropped onto a
    horizontal cloth pinned around its rim.  Multi-body interaction is a
    COMPOSITION property here, not a feature: both bodies are merged into
    one topology (disjoint constraint ranges, per-edge compliances), and the
    existing self-collision backends resolve the INTER-body contact exactly
    as they resolve intra-body contact — no body IDs, no pair tables.

    Beyond the reference: each Unity ``SoftBodySimulator`` instance owns a
    single mesh and bodies never interact (``SoftBodySimulator.cs`` has no
    inter-object contact path; only the unused ``SphereCollision`` helper,
    ``XPBDSimulatorCS.compute:213-217``, gestured at particle contact)."""
    from ..interact import forces as _forces
    from ..topology import edges as _tedges
    from ..topology import tets as _tets

    # cloth: XZ grid at y = 1, every rim vertex pinned (a trampoline)
    cm = _mesh.grid_plane(cloth_size, cloth_res)
    cverts = cm.vertices + np.array([0.0, 1.0, 0.0], np.float32)
    cedges = _tedges.unique_edges(cm.triangles)
    chinges = _tedges.hinges(cm.triangles)

    # ball: centroid-fan solid (the tet_ball construction), centered above
    bm = _mesh.icosphere(ball_subdiv, radius=ball_radius)
    bverts, btets = _tets.tets_from_surface_centroid(bm.vertices,
                                                     bm.triangles)
    bverts = (bverts + np.array([0.0, 1.45, 0.0])).astype(np.float32)
    bedges = _tets.tet_edges(btets)
    bfaces = _tets.boundary_faces(btets)

    nc = cverts.shape[0]
    # windowed merge: bodies keep their particle index ranges (identity
    # order) while the merged topology carries the one-hot window
    # structure for the general engine's windowed backend
    pos, topo, _slices = _build.merge_topologies([
        _build.BodySpec(cverts, cedges, 1e-5,                # stiff cloth
                        hinges=chinges, bend_compliance=1e-3,
                        triangles=cm.triangles),
        _build.BodySpec(bverts, bedges, 1e-4,     # 10x softer ball shell
                        triangles=bfaces, tets=btets, tet_compliance=0.0),
    ], windowed=True)
    # particle_radius: 2r must stay under the cloth grid spacing so bonded
    # neighbours never register contact (derived, so any cloth_res keeps
    # the invariant), while r stays above the per-substep fall distance
    # (~0.007) so the ball cannot tunnel between cloth nodes.
    spacing = cloth_size / (cloth_res - 1)
    particle_radius = round(0.45 * spacing, 4)
    assert 2.0 * particle_radius < spacing
    if particle_radius <= 0.008:
        raise ValueError(
            f"cloth_res={cloth_res}, cloth_size={cloth_size}: grid spacing "
            f"{spacing:.4f} gives a contact radius below the per-substep "
            "fall distance — the ball would tunnel; grow cloth_size")
    cfg = SolverConfig(substeps=6, iterations=4, damping=0.02,
                       solve_mode=SolveMode.JACOBI,
                       enable_bending=True,
                       enable_tet_volume=True, tet_pressure=1.05,
                       enable_self_collision=True,
                       self_collision_backend=contact_backend,
                       self_collision_every=contact_every,
                       block_neighbors=block_neighbors,
                       particle_radius=particle_radius,
                       ground_height=0.0, friction=0.3)
    state = state_from_topology(topo, pos)
    ii, jj = np.divmod(np.arange(nc), cloth_res)
    rim = np.flatnonzero((ii % (cloth_res - 1) == 0)
                         | (jj % (cloth_res - 1) == 0))
    state = _forces.pin_indices(state, rim, pinned=True)
    step = _general.make_step(topo, cfg, dt)
    return state, step, {"topology": topo, "config": cfg, "dt": dt,
                         "n_cloth": nc}


def ball_on_cloth_xl(dt: float = 1 / 60):
    """ball_on_cloth at ~20k particles (140x140 cloth, subdiv-3 ball): the
    cloth grows in SIZE with its resolution so the derived contact radius
    stays above the tunneling floor, and contact runs the exact Morton-
    ``blocked`` backend every 3rd substep — the scale multi-body contact
    workload.  Sample ``diag.diagnostics.blocked_dropped_pairs`` (0 =>
    coverage-identical to ``dense``)."""
    return ball_on_cloth(dt=dt, cloth_res=140, ball_subdiv=3,
                         cloth_size=3.5, ball_radius=0.3,
                         contact_backend="blocked", contact_every=3,
                         block_neighbors=18)


SCENES: Dict[str, Callable] = {
    "cpu_cube": cpu_cube,
    "cpu_mesh": cpu_mesh,
    "spot": spot,
    "stanford_bunny": stanford_bunny,
    "gpu_substep": gpu_substep,
    "basic_micro": basic_micro,
    "flagship": flagship,
    "flagship_perf": flagship_perf,
    "cloth": cloth,
    "cloth_xl": cloth_xl,
    "tet_cube": tet_cube,
    "tet_ball": tet_ball,
    "solid_lattice": solid_lattice,
    "ball_on_cloth": ball_on_cloth,
    "ball_on_cloth_xl": ball_on_cloth_xl,
    "sphere_sweep": sphere_sweep,
}
