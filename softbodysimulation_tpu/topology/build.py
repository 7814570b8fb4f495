"""Assemble a device-resident ``Topology`` from host-side mesh/lattice data.

This is the boundary between the host preprocessing layer (NumPy, runs once —
the analog of the reference's Start()/GenerateMesh() path,
``SoftBodySimulator.cs:51-153``) and the compiled device program.
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp
import numpy as np

from ..core.state import Topology
from . import coloring as _coloring
from . import edges as _edges
from . import mesh as _mesh


def build_topology(
    positions: np.ndarray,
    edges: np.ndarray,
    compliance,
    hinges: Optional[np.ndarray] = None,
    bend_compliance=0.1,
    triangles: Optional[np.ndarray] = None,
    color: bool = True,
    color_strategy: str = "greedy",
    colors: Optional[np.ndarray] = None,
    rest_lengths: Optional[np.ndarray] = None,
    rest_angles: Optional[np.ndarray] = None,
    tets: Optional[np.ndarray] = None,
    tet_compliance=0.0,
    rest_tet_volumes: Optional[np.ndarray] = None,
) -> Topology:
    """Build the static constraint topology.

    positions  — (N,3) rest positions (rest lengths/angles measured here,
                 as in ``SoftBodyCPU.cs:182`` / ``:256``).
    edges      — (E,2) int distance constraints.
    compliance — scalar or (E,) XPBD compliance per edge.
    hinges     — (H,4) dihedral bending constraints or None.
    triangles  — (T,3) surface triangles (normals/volume/export) or None.
    tets       — (T,4) tetrahedra for the per-tet volume family
                 (``topology/tets.py``) or None; ``rest_tet_volumes`` are
                 6x signed volumes, measured here when not given.
    """
    positions = np.asarray(positions, dtype=np.float64)
    n = positions.shape[0]
    edges = np.asarray(edges, dtype=np.int32).reshape(-1, 2)
    e = edges.shape[0]
    comp = np.broadcast_to(np.asarray(compliance, np.float32), (e,)).copy()
    if rest_lengths is None:
        rest_lengths = _edges.edge_rest_lengths(positions, edges)
    else:
        rest_lengths = np.asarray(rest_lengths, np.float32)

    if hinges is None:
        hinges = np.zeros((0, 4), np.int32)
    hinges = np.asarray(hinges, dtype=np.int32).reshape(-1, 4)
    h = hinges.shape[0]
    bcomp = np.broadcast_to(np.asarray(bend_compliance, np.float32), (h,)).copy()
    if rest_angles is None:
        rest_angles = _edges.hinge_rest_angles(positions, hinges)
    else:
        rest_angles = np.asarray(rest_angles, np.float32)

    if triangles is None:
        triangles = np.zeros((0, 3), np.int32)
    triangles = np.asarray(triangles, dtype=np.int32).reshape(-1, 3)
    rest_volume = (
        _mesh.signed_volume(positions, triangles) if triangles.shape[0] else 0.0
    )

    from . import native as _native

    def _greedy(cons, n_particles):
        # native C++ colorer when available (identical deterministic
        # algorithm, tested bit-equal); NumPy/Python fallback otherwise
        return _native.greedy_color(cons, n_particles)

    color_fn = {
        "greedy": _greedy,
        "cluster": _coloring.cluster_color,
    }[color_strategy]
    if colors is not None:
        colors = np.asarray(colors, np.int32)
        if not _coloring.validate_coloring(edges, colors):
            raise ValueError("provided edge coloring has conflicts")
    elif color and e:
        colors = color_fn(edges, n)
    else:
        colors = np.zeros((e,), np.int32)
    col_ids, col_valid, num_colors = _coloring.color_buckets(colors)

    if color and h:
        bcolors = color_fn(hinges, n)
    else:
        bcolors = np.zeros((h,), np.int32)
    bcol_ids, bcol_valid, num_bcolors = _coloring.color_buckets(bcolors)

    tet_fields = {}
    if tets is not None and len(tets):
        from . import tets as _tets

        tets = np.asarray(tets, np.int32).reshape(-1, 4)
        t = tets.shape[0]
        tcomp = np.broadcast_to(
            np.asarray(tet_compliance, np.float32), (t,)).copy()
        if rest_tet_volumes is None:
            rest_tv = _tets.tet_rest_volumes6(positions, tets)
            if (rest_tv <= 0).any():
                raise ValueError(
                    "non-positive rest tet volume — run tets.fix_orientation")
        else:
            rest_tv = np.asarray(rest_tet_volumes, np.float64)
        if color:
            tcolors = color_fn(tets, n)
        else:
            tcolors = np.zeros((t,), np.int32)
        tcol_ids, tcol_valid, num_tcolors = _coloring.color_buckets(tcolors)
        tdeg = np.bincount(tets.reshape(-1), minlength=n).astype(np.float32)
        tet_fields = dict(
            tets=jnp.asarray(tets),
            rest_tet_volumes=jnp.asarray(rest_tv, dtype=jnp.float32),
            tet_compliance=jnp.asarray(tcomp),
            tcol_tet_ids=jnp.asarray(tcol_ids),
            tcol_valid=jnp.asarray(tcol_valid),
            tet_degree=jnp.asarray(tdeg),
            tet_incidence=jnp.asarray(_build_incidence(tets, n)),
            num_tet_colors=num_tcolors,
        )

    deg = np.bincount(edges.reshape(-1), minlength=n).astype(np.float32)
    bdeg = np.bincount(hinges.reshape(-1), minlength=n).astype(np.float32)

    # Incidence lists: for each particle, the indices of its contributions
    # in the stacked per-constraint correction arrays.  Turns the Jacobi
    # accumulation from a scatter-add into a padded gather + row-sum (fully
    # vectorized, no atomics).  Pad entry = one-past-the-end, pointing
    # at an appended zero row.
    incid = _build_incidence(edges, n)
    bincid = _build_incidence(hinges, n)

    return Topology(
        edges=jnp.asarray(edges),
        rest_lengths=jnp.asarray(rest_lengths),
        compliance=jnp.asarray(comp),
        colors=jnp.asarray(colors),
        col_edge_ids=jnp.asarray(col_ids),
        col_valid=jnp.asarray(col_valid),
        hinges=jnp.asarray(hinges),
        rest_angles=jnp.asarray(rest_angles),
        bend_compliance=jnp.asarray(bcomp),
        bend_colors=jnp.asarray(bcolors),
        bcol_hinge_ids=jnp.asarray(bcol_ids),
        bcol_valid=jnp.asarray(bcol_valid),
        triangles=jnp.asarray(triangles),
        rest_volume=jnp.asarray(rest_volume, dtype=jnp.float32),
        degree=jnp.asarray(deg),
        bend_degree=jnp.asarray(bdeg),
        incidence=jnp.asarray(incid),
        bend_incidence=jnp.asarray(bincid),
        num_colors=num_colors,
        num_bend_colors=num_bcolors,
        n_particles=n,
        **tet_fields,
    )


def _build_incidence(constraints: np.ndarray, n: int,
                     pad_multiple: int = 4) -> np.ndarray:
    """(N, D) indices into the flattened (K*arity) contribution array; for
    constraint k touching particle p as its a-th endpoint, the contribution
    index is a*K + k.  Rows padded with K*arity (an appended zero row)."""
    cons = np.asarray(constraints, dtype=np.int64)
    k = cons.shape[0]
    if k == 0:
        return np.zeros((n, 0), np.int32)
    arity = cons.shape[1]
    counts = np.bincount(cons.reshape(-1), minlength=n)
    d = int(counts.max()) if len(counts) else 0
    d = max(pad_multiple, ((d + pad_multiple - 1) // pad_multiple)
            * pad_multiple)
    out = np.full((n, d), k * arity, dtype=np.int32)
    flat_p = cons.T.reshape(-1)              # particle of contribution a*k+j
    contrib_idx = np.arange(arity * k, dtype=np.int64)
    order = np.argsort(flat_p, kind="stable")
    sorted_p = flat_p[order]
    group_start = np.searchsorted(sorted_p, np.arange(n))
    ranks = np.arange(len(sorted_p)) - group_start[sorted_p]
    out[sorted_p, ranks] = contrib_idx[order]
    return out


def build_windowed_topology(
    positions: np.ndarray,
    edges: np.ndarray,
    compliance,
    hinges: Optional[np.ndarray] = None,
    triangles: Optional[np.ndarray] = None,
    rest_lengths: Optional[np.ndarray] = None,
    block_edges: int = 128,
    max_window: int = 1024,
    seg_align: int = 128,
    window_dtype="float32",
    colored: bool = False,
    order: Optional[np.ndarray] = None,
    **kw,
):
    """Build a Topology carrying the one-hot window structure
    (``topology/windows.py``) for the general engine's matmul distance
    backend.

    Particles are renumbered by reverse Cuthill-McKee and edges re-sorted
    by min endpoint, so the topology AND the returned positions live in the
    permuted index space.  Returns ``(positions_permuted (N,3) f32,
    Topology)`` — build the SimState from the returned positions.

    ``colored=True`` additionally re-sorts the edges COLOR-MAJOR (stable,
    so min-endpoint order is kept within each color) for the fused mesh
    kernel's exact-Gauss-Seidel COLORED mode: color classes become
    contiguous edge ranges the kernel can sweep sequentially.  Intra-color
    order is arithmetically free in exact GS (no two edges in a color
    share a particle), so the general engine's color-major sweep semantics
    are unchanged.  The XLA one-hot window structure is still attempted on
    the colored order but skipped if color-scattering blows the window
    bound (the kernel builds its own span-bounded blocks instead).
    """
    from . import windows as _windows

    positions = np.asarray(positions, np.float64)
    n = positions.shape[0]
    edges = np.asarray(edges, np.int32).reshape(-1, 2)
    e = edges.shape[0]
    comp = np.broadcast_to(np.asarray(compliance, np.float32), (e,)).copy()

    # order: caller-supplied particle permutation (new -> old), e.g.
    # identity from merge_topologies(windowed=True) where bodies must keep
    # their index ranges; default reverse Cuthill-McKee
    if order is None:
        order = _windows.rcm_order(edges, n)
    else:
        order = np.asarray(order, np.int64)
    rank = np.empty(n, np.int64)
    rank[order] = np.arange(n)
    pos2 = positions[order]
    e2 = rank[edges.astype(np.int64)].astype(np.int32)
    sortperm = _windows.sort_edges_by_window(e2)
    e2 = e2[sortperm]
    comp = comp[sortperm]
    if rest_lengths is not None:
        rest_lengths = np.asarray(rest_lengths, np.float32)[sortperm]
    if colored and e:
        from . import native as _native

        colors = _native.greedy_color(e2, n)
        cperm = np.argsort(colors, kind="stable")
        e2 = e2[cperm]
        comp = comp[cperm]
        colors = colors[cperm]
        if rest_lengths is not None:
            rest_lengths = rest_lengths[cperm]
        kw["colors"] = colors
    if hinges is not None and len(hinges):
        hinges = rank[np.asarray(hinges, np.int64)].astype(np.int32)
        # window-sort hinges too, so the bending sweep can block them
        hinges = hinges[_windows.sort_hinges_by_window(hinges)]
    if triangles is not None and len(triangles):
        triangles = rank[np.asarray(triangles, np.int64)].astype(np.int32)
    tets = kw.pop("tets", None)
    if tets is not None and len(tets):
        # renumber into the RCM-permuted space (orientation is index-order
        # -invariant under relabeling, so no re-fixing needed)
        tets = rank[np.asarray(tets, np.int64)].astype(np.int32)
        kw["tets"] = tets

    topo = build_topology(
        pos2, e2, comp,
        hinges=hinges,
        triangles=triangles,
        rest_lengths=rest_lengths,
        **kw,
    )
    deg = np.bincount(e2.reshape(-1).astype(np.int64), minlength=n)
    try:
        win = _windows.build_windows(
            e2, n, deg.astype(np.float32),
            block_edges=block_edges, max_window=max_window,
            seg_align=seg_align, dtype=window_dtype)
    except ValueError:
        if not colored:
            raise
        win = None   # color-scattered order blew the window bound; the
        #              COLORED sweep does not use the windows
    bwin = None
    if hinges is not None and len(hinges):
        try:
            bwin = _windows.build_hinge_windows(
                hinges, n, np.asarray(topo.bend_degree),
                block_hinges=min(block_edges, 128),
                max_window=max_window, seg_align=seg_align,
                dtype=window_dtype)
        except ValueError:
            bwin = None    # bandwidth too large: gather bending fallback
    twin = tperm = None
    if tets is not None and len(tets):
        # tets share the hinge-window shape (4 endpoints, e_i = tip -
        # root): block a min-endpoint-sorted COPY and keep the slot->tet
        # permutation so the per-tet state (lambda, rest volume,
        # compliance) stays in topo.tets order everywhere else
        import jax.numpy as _jnp

        torder = _windows.sort_hinges_by_window(tets)
        try:
            twin = _windows.build_hinge_windows(
                tets[torder], n, np.asarray(topo.tet_degree),
                block_hinges=min(block_edges, 128),
                max_window=max_window, seg_align=seg_align,
                dtype=window_dtype)
            tperm = _jnp.asarray(torder.astype(np.int32))
        except ValueError:
            twin = tperm = None  # e.g. centroid fans (the hub endpoint
            #                      spans the whole mesh): gather fallback
    return pos2.astype(np.float32), topo.replace(windows=win,
                                                 bend_windows=bwin,
                                                 tet_windows=twin,
                                                 tet_window_perm=tperm)


def validate_topology(topo: Topology) -> dict:
    """Constraint-data validation (the ``ValidateConstraintData`` analog,
    ``SoftBodySimulator.cs:1018-1044``): index bounds, positive rest
    lengths, non-negative compliances, coloring validity.  Returns a report
    dict; raises on hard violations."""
    edges = np.asarray(topo.edges)
    n = topo.n_particles
    report = {"n_particles": n, "n_edges": topo.n_edges,
              "n_hinges": topo.n_hinges, "num_colors": topo.num_colors}
    if topo.n_edges:
        if edges.min() < 0 or edges.max() >= n:
            raise ValueError("edge indices out of bounds")
        if (edges[:, 0] == edges[:, 1]).any():
            raise ValueError("degenerate edge (a == b)")
        rest = np.asarray(topo.rest_lengths)
        if not (rest > 0).all():
            raise ValueError("non-positive rest length")
        if (np.asarray(topo.compliance) < 0).any():
            raise ValueError("negative compliance")
        if not _coloring.validate_coloring(edges, np.asarray(topo.colors)):
            raise ValueError("edge coloring has conflicts")
    h = np.asarray(topo.hinges)
    if topo.n_hinges:
        if h.min() < 0 or h.max() >= n:
            raise ValueError("hinge indices out of bounds")
        if not _coloring.validate_coloring(h, np.asarray(topo.bend_colors)):
            raise ValueError("hinge coloring has conflicts")
    t = np.asarray(topo.triangles)
    if t.shape[0] and (t.min() < 0 or t.max() >= n):
        raise ValueError("triangle indices out of bounds")
    if topo.n_tets:
        tt = np.asarray(topo.tets)
        report["n_tets"] = topo.n_tets
        if tt.min() < 0 or tt.max() >= n:
            raise ValueError("tet indices out of bounds")
        if not (np.asarray(topo.rest_tet_volumes) > 0).all():
            raise ValueError("non-positive rest tet volume")
        ids = np.asarray(topo.tcol_tet_ids)
        val = np.asarray(topo.tcol_valid)
        for c in range(topo.num_tet_colors):
            flat = tt[ids[c][val[c] > 0]].reshape(-1)
            if len(np.unique(flat)) != len(flat):
                raise ValueError("tet coloring has conflicts")
    report["ok"] = True
    return report


def topology_from_mesh(
    mesh: "_mesh.TriMesh",
    compliance: float = 0.01,
    bending: bool = False,
    bend_compliance: float = 0.1,
    weld_eps: float = 0.0,
    windowed: bool = False,
    **kw,
):
    """Mesh -> particles + edge/hinge constraints, the
    ``InitializeSoftBodyFromMesh`` path (``SoftBodyCPU.cs:121-157``).
    Returns (positions, Topology).  ``weld_eps > 0`` welds first
    (``SoftBodyGPU.cs:121``).  ``windowed=True`` builds the one-hot
    window structure (RCM-renumbers the vertices — the returned positions
    and the topology's triangles are in the permuted space);
    ``windowed="colored"`` additionally orders edges color-major (the
    COLORED exact parallel-GS sweep's order)."""
    verts, tris = mesh.vertices, mesh.triangles
    if weld_eps > 0:
        verts, tris, _ = _edges.weld(verts, tris, weld_eps)
    e = _edges.unique_edges(tris)
    hn = _edges.hinges(tris) if bending else None
    if windowed:
        pos2, topo = build_windowed_topology(
            verts, e, compliance,
            hinges=hn,
            bend_compliance=bend_compliance,
            triangles=tris,
            colored=(windowed == "colored"),
            **kw,
        )
        return pos2, topo
    topo = build_topology(
        verts,
        e,
        compliance,
        hinges=hn,
        bend_compliance=bend_compliance,
        triangles=tris,
        **kw,
    )
    return verts.astype(np.float32), topo


class BodySpec:
    """Host-side description of ONE soft body, for ``merge_topologies``.

    A thin record of the same arrays ``build_topology`` takes — positions
    plus optional constraint families with per-body (scalar or per-element)
    compliances.  Indices are LOCAL to the body; merging offsets them.
    """

    def __init__(self, positions, edges=None, compliance=1e-4,
                 hinges=None, bend_compliance=0.1,
                 triangles=None, tets=None, tet_compliance=0.0):
        self.positions = np.asarray(positions, np.float64).reshape(-1, 3)
        n = self.positions.shape[0]
        self.edges = (np.zeros((0, 2), np.int32) if edges is None
                      else np.asarray(edges, np.int32).reshape(-1, 2))
        self.hinges = (np.zeros((0, 4), np.int32) if hinges is None
                       else np.asarray(hinges, np.int32).reshape(-1, 4))
        self.triangles = (np.zeros((0, 3), np.int32) if triangles is None
                          else np.asarray(triangles, np.int32).reshape(-1, 3))
        self.tets = (np.zeros((0, 4), np.int32) if tets is None
                     else np.asarray(tets, np.int32).reshape(-1, 4))
        for name, arr in (("edges", self.edges), ("hinges", self.hinges),
                          ("triangles", self.triangles), ("tets", self.tets)):
            if arr.size and (arr.min() < 0 or arr.max() >= n):
                raise ValueError(f"{name} index out of range for body "
                                 f"with {n} particles")
        self.compliance = np.broadcast_to(
            np.asarray(compliance, np.float32),
            (self.edges.shape[0],)).copy()
        self.bend_compliance = np.broadcast_to(
            np.asarray(bend_compliance, np.float32),
            (self.hinges.shape[0],)).copy()
        self.tet_compliance = np.broadcast_to(
            np.asarray(tet_compliance, np.float32),
            (self.tets.shape[0],)).copy()


class BodySlices:
    """Per-body index ranges into a merged topology: ``particles``,
    ``edges``, ``hinges``, ``triangles``, ``tets`` are ``slice`` objects
    into the corresponding merged arrays (positions / constraint rows)."""

    def __init__(self, particles, edges, hinges, triangles, tets):
        self.particles = particles
        self.edges = edges
        self.hinges = hinges
        self.triangles = triangles
        self.tets = tets

    def __repr__(self):
        return (f"BodySlices(particles={self.particles}, "
                f"edges={self.edges}, hinges={self.hinges}, "
                f"triangles={self.triangles}, tets={self.tets})")


def merge_topologies(bodies, windowed=False, **build_kwargs):
    """Merge several bodies into ONE topology sharing a particle index
    space — the first-class construction behind multi-body scenes
    (``core/scenes.ball_on_cloth``): constraint families stay disjoint
    per body, and the self-collision backends then resolve INTER-body
    contact exactly as intra-body contact, with no body IDs or pair
    tables (the capability Unity delegated to PhysX triggers,
    ``SoftBodyController.cs:110-118`` — here it composes for free).

    bodies — sequence of ``BodySpec`` (or kwargs-dicts for BodySpec).
    build_kwargs — forwarded to ``build_topology`` (coloring runs on the
    merged graph; bodies are disjoint so per-body colorings stay valid,
    but merged coloring may use fewer colors).
    windowed — route the merged arrays through ``build_windowed_topology``
    with the IDENTITY particle order, so the merged topology carries the
    one-hot window structure (the windowed engine backend)
    while every body keeps its particle index range.  Bodies are already
    index-contiguous, so windows stay body-local without an RCM pass, and
    the stable min-endpoint constraint sorts keep every ``BodySlices``
    range valid.  (``colored=True`` would re-sort edges color-major across
    bodies and break the edge slices — not supported here.)

    Returns ``(positions (N,3) f32, Topology, [BodySlices])``.
    """
    if windowed and build_kwargs.get("colored"):
        raise NotImplementedError(
            "merge_topologies(windowed=True) cannot also sort color-major "
            "(per-body edge slices would interleave)")
    specs = [b if isinstance(b, BodySpec) else BodySpec(**b) for b in bodies]
    if not specs:
        raise ValueError("merge_topologies needs at least one body")

    pos_parts, slices = [], []
    edge_parts, comp_parts = [], []
    hinge_parts, bcomp_parts = [], []
    tri_parts = []
    tet_parts, tcomp_parts = [], []
    np_off = ne_off = nh_off = nt_off = ntet_off = 0
    for s in specs:
        n, e = s.positions.shape[0], s.edges.shape[0]
        h, t = s.hinges.shape[0], s.triangles.shape[0]
        tt = s.tets.shape[0]
        slices.append(BodySlices(
            particles=slice(np_off, np_off + n),
            edges=slice(ne_off, ne_off + e),
            hinges=slice(nh_off, nh_off + h),
            triangles=slice(nt_off, nt_off + t),
            tets=slice(ntet_off, ntet_off + tt)))
        pos_parts.append(s.positions)
        edge_parts.append(s.edges + np_off)
        comp_parts.append(s.compliance)
        hinge_parts.append(s.hinges + np_off)
        bcomp_parts.append(s.bend_compliance)
        tri_parts.append(s.triangles + np_off)
        tet_parts.append(s.tets + np_off)
        tcomp_parts.append(s.tet_compliance)
        np_off += n
        ne_off += e
        nh_off += h
        nt_off += t
        ntet_off += tt

    pos = np.concatenate(pos_parts, axis=0)
    tets = np.concatenate(tet_parts, axis=0)
    kwargs = dict(
        hinges=np.concatenate(hinge_parts, axis=0),
        bend_compliance=np.concatenate(bcomp_parts, axis=0),
        triangles=np.concatenate(tri_parts, axis=0),
        tets=tets if tets.shape[0] else None,
        tet_compliance=np.concatenate(tcomp_parts, axis=0),
        **build_kwargs,
    )
    edges_cat = np.concatenate(edge_parts, axis=0)
    comp_cat = np.concatenate(comp_parts, axis=0)
    if windowed:
        pos2, topo = build_windowed_topology(
            pos, edges_cat, comp_cat,
            order=np.arange(pos.shape[0]), **kwargs)
        return pos2.astype(np.float32), topo, slices
    topo = build_topology(pos, edges_cat, comp_cat, **kwargs)
    return pos.astype(np.float32), topo, slices
