"""Self-collision via a fixed-capacity spatial hash grid, fully jit-able.

BASELINE config 4 capability.  The reference only carried the unused
``SphereCollision`` helper (``XPBDSimulatorCS.compute:213-217``); this is a
proper particle-particle resolver designed for XLA's static-shape regime:

  1. quantize predicted positions to a bounded G^3 grid (dynamic *values*,
     static *shapes*);
  2. sort particle ids by cell id (one argsort);
  3. each particle searches its 27 neighbor cells via vectorized
     ``searchsorted`` and inspects up to ``hash_cell_capacity`` entries per
     cell — a fixed (N, 27, K) gather block, masked;
  4. overlapping pairs are separated by a Jacobi position correction with
     under-relaxation (each pair discovered symmetrically, so per-particle
     accumulation needs no scatter at all).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.config import SolverConfig

_NEIGHBOR_OFFSETS = None


def _offsets():
    global _NEIGHBOR_OFFSETS
    if _NEIGHBOR_OFFSETS is None:
        import numpy as np

        o = np.array(
            [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
             for dz in (-1, 0, 1)],
            dtype=np.int32,
        )
        _NEIGHBOR_OFFSETS = o
    return _NEIGHBOR_OFFSETS


def self_collision_project(pred, inv_mass, cfg: SolverConfig):
    """One Jacobi separation pass.  Returns corrected predicted positions."""
    n = pred.shape[0]
    radius = cfg.particle_radius
    cell = 2.0 * radius
    g = cfg.hash_grid_dim
    k = cfg.hash_cell_capacity

    origin = pred.min(axis=0)
    coords = jnp.clip(
        jnp.floor((pred - origin) / cell).astype(jnp.int32), 0, g - 1
    )
    cid = (coords[:, 0] * g + coords[:, 1]) * g + coords[:, 2]

    order = jnp.argsort(cid)
    sorted_cid = cid[order]

    offs = jnp.asarray(_offsets())  # (27, 3)
    ncoords = coords[:, None, :] + offs[None, :, :]          # (N, 27, 3)
    in_grid = ((ncoords >= 0) & (ncoords < g)).all(axis=-1)  # (N, 27)
    ncid = (ncoords[..., 0] * g + ncoords[..., 1]) * g + ncoords[..., 2]

    starts = jnp.searchsorted(sorted_cid, ncid.reshape(-1)).reshape(n, 27)
    slot = starts[:, :, None] + jnp.arange(k)[None, None, :]  # (N, 27, K)
    slot_ok = slot < n
    slot_c = jnp.minimum(slot, n - 1)
    cand_cid = sorted_cid[slot_c]
    cand_idx = order[slot_c]
    valid = slot_ok & (cand_cid == ncid[:, :, None]) & in_grid[:, :, None]

    pj = pred[cand_idx]                       # (N, 27, K, 3)
    wj = inv_mass[cand_idx]                   # (N, 27, K)
    d = pred[:, None, None, :] - pj
    # guarded sqrt (NOT jnp.linalg.norm): the self-pair has d == 0 exactly,
    # and sqrt'(0) = inf poisons every gradient through this pass — the
    # downstream where-masks cannot block the NaN cotangents
    dist = jnp.sqrt(jnp.maximum(jnp.sum(d * d, axis=-1), 1e-24))
    not_self = cand_idx != jnp.arange(n)[:, None, None]
    overlap = 2.0 * radius - dist
    wi = inv_mass[:, None, None]
    wsum = wi + wj
    touch = valid & not_self & (overlap > 0) & (dist > 1e-9) & (wsum > 1e-12)
    ndir = d / jnp.maximum(dist, 1e-12)[..., None]
    push = jnp.where(
        touch, (wi / jnp.maximum(wsum, 1e-12)) * overlap, 0.0
    )
    corr = (ndir * push[..., None]).sum(axis=(1, 2))
    return pred + cfg.self_collision_omega * corr


# ---------------------------------------------------------------- dense path
def self_collision_project_dense(pred, inv_mass, cfg: SolverConfig):
    """One EXACT Jacobi separation pass computed as matrix products.

    All-pairs contact with zero gathers and zero capacity caveats — the
    dense formulation of the problem the reference's unused
    ``SphereCollision`` helper gestured at (``XPBDSimulatorCS.compute:213``):

      dist^2_ij = |x_i|^2 + |x_j|^2 - 2 x_i.x_j        (one (B,3)x(3,N) matmul)
      corr_i    = w_i * (x_i * sum_j m_ij - (m @ X)_i)  (one (B,N)x(N,3) matmul)

    with m_ij = overlap/(dist*wsum) masked to touching pairs — algebraically
    identical to the hash path's per-pair ``(w_i/wsum)*overlap*ndir`` sum.
    Rows are processed in ``cfg.dense_row_block``-sized blocks under
    ``lax.scan`` so peak memory is (B, N) rather than (N, N).  O(N^2) work,
    but dense f32 matrix products (HIGHEST precision: true f32 on every
    backend): exact, with no candidate capacity to overflow.  Positions are centered first to keep the
    |x|^2 cancellation benign at contact scale.

    Boundary-classification caveat: the Gram identity loses ~1e-7 absolute
    precision to cancellation for close pairs even after centering
    (mitigated by Precision.HIGHEST), so a pair sitting exactly at the
    overlap boundary can classify differently than the hash path's direct
    (xi-xj)^2 — a one-ulp cross-backend inconsistency, within the
    cross-backend test tolerances.
    """
    n = pred.shape[0]
    radius = cfg.particle_radius
    block = max(8, min(cfg.dense_row_block, n))
    npad = ((n + block - 1) // block) * block

    x = pred - pred.mean(axis=0)
    if npad != n:
        # park padding far away with zero inv-mass (wsum guard kills any
        # pad-pad pair; distance kills pad-real pairs)
        sent = 1e6 * (1.0 + jnp.arange(npad - n, dtype=pred.dtype))
        xpad = jnp.stack([sent, sent, sent], axis=-1)
        x = jnp.concatenate([x, xpad], axis=0)
        w = jnp.concatenate([inv_mass,
                             jnp.zeros(npad - n, inv_mass.dtype)])
    else:
        w = inv_mass
    sq = jnp.sum(x * x, axis=-1)
    ids = jnp.arange(npad, dtype=jnp.int32)
    nb = npad // block

    xb = x.reshape(nb, block, 3)
    sqb = sq.reshape(nb, block)
    wb = w.reshape(nb, block)
    idb = ids.reshape(nb, block)

    def row_block(_, inp):
        xi, sqi, wi, idi = inp
        g = jax.lax.dot_general(
            xi, x, (((1,), (1,)), ((), ())),
            precision=jax.lax.Precision.HIGHEST)        # (B, npad)
        d2 = sqi[:, None] + sq[None, :] - 2.0 * g
        dist = jnp.sqrt(jnp.maximum(d2, 1e-18))
        overlap = 2.0 * radius - dist
        wsum = wi[:, None] + w[None, :]
        touch = ((idi[:, None] != ids[None, :]) & (overlap > 0)
                 & (dist > 1e-9) & (wsum > 1e-12))
        m = jnp.where(touch,
                      overlap / (jnp.maximum(dist, 1e-12)
                                 * jnp.maximum(wsum, 1e-12)), 0.0)
        mx = jax.lax.dot_general(
            m, x, (((1,), (0,)), ((), ())),
            precision=jax.lax.Precision.HIGHEST)        # (B, 3)
        corr = wi[:, None] * (xi * jnp.sum(m, axis=1)[:, None] - mx)
        return _, corr

    _, corr = jax.lax.scan(row_block, None, (xb, sqb, wb, idb))
    corr = corr.reshape(npad, 3)[:n]
    return pred + cfg.self_collision_omega * corr


# -------------------------------------------------------------- blocked path
def _blocked_layout(pred, inv_mass, order, cfg: SolverConfig):
    """Morton-sorted, block-padded layout shared by the blocked projection
    and its overflow diagnostic.  Pads replicate the last real particle's
    position (so the final block's AABB is not inflated) and are excluded
    from every pair by the id < n mask."""
    n = pred.shape[0]
    block = max(8, min(cfg.collision_block_size, n))
    npad = ((n + block - 1) // block) * block
    nb = npad // block

    x = pred[order] - pred.mean(axis=0)
    w = inv_mass[order]
    ids = jnp.arange(npad, dtype=jnp.int32)
    if npad != n:
        x = jnp.concatenate([x, jnp.broadcast_to(x[-1], (npad - n, 3))])
        w = jnp.concatenate([w, jnp.zeros(npad - n, w.dtype)])

    xb = x.reshape(nb, block, 3)
    bmin = xb.min(axis=1)                      # (nb, 3)
    bmax = xb.max(axis=1)
    # min distance^2 between block AABBs; touch iff it can be < (2r)^2
    gap = jnp.maximum(
        jnp.maximum(bmin[:, None, :] - bmax[None, :, :],
                    bmin[None, :, :] - bmax[:, None, :]), 0.0)
    d2ab = jnp.sum(gap * gap, axis=-1)         # (nb, nb)
    touch = d2ab < (2.0 * cfg.particle_radius) ** 2
    return (x, w, ids, xb, w.reshape(nb, block), ids.reshape(nb, block),
            touch, d2ab, n, block, nb)


def self_collision_blocked_overflow(pred, inv_mass, order,
                                    cfg: SolverConfig):
    """Worst-case number of AABB-touching blocks dropped by the top-M
    candidate selection (0 => the blocked pass was EXACT this substep).

    This is the CONSERVATIVE a-priori bound: AABB-touching blocks may
    contain no actually-overlapping pairs (a flat cloth's blocks all
    "touch" in the thin axis while every particle pair sits well beyond
    the contact diameter).  ``self_collision_blocked_dropped_pairs`` is
    the pair-accurate a-posteriori check — 0 dropped pairs means the
    pass's coverage was IDENTICAL to the dense backend's at this state
    even when this bound is exceeded."""
    (*_, touch, _d2ab, _n, _block, _nb) = _blocked_layout(
        pred, inv_mass, order, cfg)
    per_row = jnp.sum(touch, axis=1)
    return jnp.maximum(jnp.max(per_row) - cfg.block_neighbors, 0)


def self_collision_blocked_dropped_pairs(pred, inv_mass, order,
                                         cfg: SolverConfig):
    """Number of real contact contributions the blocked pass MISSED at
    this state: directed pairs (a in block i, b in block j) with
    ``dist(a, b) < 2r`` (under the pass's own dist/mass guards) whose
    source block i did not select block j among its top-M candidates.

    0 => block i gathered every particle that the dense backend would
    have paired with block i's particles — the blocked corrections are
    coverage-identical to dense HERE, regardless of the conservative
    AABB worst-touch bound.  Nonzero counts include one entry per
    missing direction (a one-sidedly processed pair contributes 1 — the
    asymmetric-correction case the projection docstring warns about).
    O(N * block) per block under lax.scan — a diagnostic for gate
    points, not a hot-loop check."""
    (x, w, ids, xb, wb, idb, touch, d2ab, n, block, nb) = _blocked_layout(
        pred, inv_mass, order, cfg)
    m_nbr = min(cfg.block_neighbors, nb)
    key = jnp.where(touch, -d2ab, -jnp.inf)
    _, nbr_idx = jax.lax.top_k(key, m_nbr)                # (nb, M)
    nbr_ok = jnp.take_along_axis(touch, nbr_idx, axis=1)
    sel = jnp.zeros((nb, nb), dtype=bool)
    sel = sel.at[jnp.arange(nb)[:, None], nbr_idx].set(nbr_ok)
    # blocks whose particles block i would have needed but didn't gather
    bad = touch & ~sel                                    # (nb, nb)
    blk = ids // block                                    # (npad,)
    r2 = (2.0 * cfg.particle_radius) ** 2

    def row(count, inp):
        xi, wi, idi, badrow = inp
        d2 = jnp.sum((xi[:, None, :] - x[None, :, :]) ** 2, axis=-1)
        wsum = wi[:, None] + w[None, :]
        real = ((d2 < r2) & (d2 > 1e-18) & (wsum > 1e-12)
                & (idi[:, None] < n) & (ids[None, :] < n)
                & badrow[blk][None, :])
        return count + jnp.sum(real), None

    total, _ = jax.lax.scan(
        row, jnp.zeros((), jnp.int32),
        (xb, wb, idb, bad))
    return total


def self_collision_project_blocked(pred, inv_mass, order,
                                   cfg: SolverConfig):
    """One EXACT-at-scale Jacobi separation pass: dense contact math
    restricted to AABB-proximate Morton blocks.

    Pipeline: Morton-sort (``order``, computed once per substep) ->
    fixed ``collision_block_size`` blocks -> block AABB pair culling ->
    ``block_neighbors`` nearest candidate blocks per block (top-k on AABB
    distance, non-touching blocks masked) -> the dense backend's Gram-trick
    matmuls on each (B, M*B) candidate slab under ``lax.scan``.

    Arithmetic per surviving pair is identical to the dense backend; the
    result is exact whenever no block has more than ``block_neighbors``
    AABB-touching blocks — when the bound breaks, the pass silently drops
    the overflowing pairs (asymmetric, momentum-biased corrections).  The
    precondition is checkable per state via
    ``self_collision_blocked_overflow``, surfaced through
    ``diag.diagnostics.blocked_overflow`` and logged by the CLI's
    ``--log-every`` on blocked-backend scenes; with cell-scale blocks and
    physical densities the bound holds with room.  O(N * M * B) flops vs
    dense's O(N^2) — the exact path for 64k+ self-colliding particles
    (BASELINE config 4 at scale).
    """
    (x, w, ids, xb, wb, idb, touch, d2ab, n, block, nb) = _blocked_layout(
        pred, inv_mass, order, cfg)
    m_nbr = min(cfg.block_neighbors, nb)
    radius = cfg.particle_radius

    key = jnp.where(touch, -d2ab, -jnp.inf)
    _, nbr_idx = jax.lax.top_k(key, m_nbr)             # (nb, M)
    nbr_ok = jnp.take_along_axis(touch, nbr_idx, axis=1)  # (nb, M)

    sq = jnp.sum(x * x, axis=-1)
    sqb = sq.reshape(nb, block)

    def row_block(_, inp):
        xi, sqi, wi, idi, nbr, ok = inp
        cx = xb[nbr].reshape(m_nbr * block, 3)          # (MB, 3)
        csq = sqb[nbr].reshape(m_nbr * block)
        cw = wb[nbr].reshape(m_nbr * block)
        cid = idb[nbr].reshape(m_nbr * block)
        cok = jnp.repeat(ok, block)                     # (MB,)
        g = jax.lax.dot_general(
            xi, cx, (((1,), (1,)), ((), ())),
            precision=jax.lax.Precision.HIGHEST)        # (B, MB)
        d2 = sqi[:, None] + csq[None, :] - 2.0 * g
        dist = jnp.sqrt(jnp.maximum(d2, 1e-18))
        overlap = 2.0 * radius - dist
        wsum = wi[:, None] + cw[None, :]
        touch_p = ((idi[:, None] != cid[None, :]) & (overlap > 0)
                   & (dist > 1e-9) & (wsum > 1e-12)
                   & cok[None, :]
                   & (idi[:, None] < n) & (cid[None, :] < n))
        m = jnp.where(touch_p,
                      overlap / (jnp.maximum(dist, 1e-12)
                                 * jnp.maximum(wsum, 1e-12)), 0.0)
        mx = jax.lax.dot_general(
            m, cx, (((1,), (0,)), ((), ())),
            precision=jax.lax.Precision.HIGHEST)        # (B, 3)
        corr = wi[:, None] * (xi * jnp.sum(m, axis=1)[:, None] - mx)
        return _, corr

    _, corr = jax.lax.scan(
        row_block, None,
        (xb, sqb, wb, idb, nbr_idx, nbr_ok))
    corr = corr.reshape(nb * block, 3)[:n]
    inv_order = jnp.argsort(order)
    return pred + cfg.self_collision_omega * corr[inv_order]


# --------------------------------------------------------------- sorted path
def _spread_bits_3(x):
    """Spread the low 10 bits of x so consecutive bits land 3 apart
    (standard 32-bit Morton magic)."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


_HILBERT_BITS = 9                          # 512 cells per axis


def _hilbert_code(coords, b=_HILBERT_BITS):
    """Vectorized 3-D Hilbert index of integer cell coords in [0, 2^b).

    Skilling's transpose algorithm (AxestoTranspose: invert/swap walk from
    the top bit down, then Gray-encode) followed by bit interleave — all
    elementwise int32 ops, so the whole batch transforms in a handful of
    fused VPU passes.  Unlike the Morton/Z curve, the Hilbert curve is
    CONTINUOUS: consecutive indices are face-adjacent cells, so a
    contiguous run of sorted particles is always a compact spatial blob —
    no quadrant-seam blocks spanning half the scene (the Z-curve's jumps
    produced 256-particle blocks with 3.5-unit AABBs on a flat cloth,
    tripling the blocked backend's worst-case touching-block count)."""
    X = [coords[:, 0], coords[:, 1], coords[:, 2]]
    Q = 1 << (b - 1)
    while Q > 1:
        P = Q - 1
        for i in range(3):
            cond = (X[i] & Q) != 0
            t = (X[0] ^ X[i]) & P
            x0_swap = X[0] ^ t
            xi_swap = X[i] ^ t
            X[0] = jnp.where(cond, X[0] ^ P, x0_swap)
            if i:
                X[i] = jnp.where(cond, X[i], xi_swap)
        Q >>= 1
    X[1] = X[1] ^ X[0]
    X[2] = X[2] ^ X[1]
    t = jnp.zeros_like(X[0])
    Q = 1 << (b - 1)
    while Q > 1:
        t = jnp.where((X[2] & Q) != 0, t ^ (Q - 1), t)
        Q >>= 1
    X = [x ^ t for x in X]
    # transpose layout: X[0] holds the most significant bit of each triplet
    return ((_spread_bits_3(X[0]) << 2)
            | (_spread_bits_3(X[1]) << 1)
            | _spread_bits_3(X[2]))


def morton_order(pred, cfg: SolverConfig):
    """Sort permutation along a space-filling curve of the quantized cell
    coordinates (historically Morton; a HILBERT curve since round 5 — same
    contract, strictly better locality).  Computed ONCE per substep; the
    window/blocked passes reuse it across solver iterations (a neighbor
    list, in effect).  The downstream contact math is order-agnostic —
    the curve only decides which pairs land in the same window/block, so
    better locality means fewer missed pairs (sorted) and a smaller
    worst-case touching-block count (blocked exactness bound)."""
    radius = cfg.particle_radius
    g = 1 << _HILBERT_BITS
    origin = pred.min(axis=0)
    # Scene-adaptive cell: at least the contact diameter, but never so
    # small that the scene AABB clips the grid — clipping piles every
    # particle beyond the range into the boundary cell and the curve
    # degenerates to axis-major slabs (measured: a 3.5-unit cloth under
    # the old fixed 32-cell grid produced 256-particle blocks spanning
    # the full z extent, 73 AABB-touching blocks where a compact tile
    # touches ~9).  Coarser-than-diameter cells are harmless here: the
    # code only ORDERS particles — the sorted/blocked passes remain
    # exact/approximate by their own tests, and the blocked exactness
    # bound is re-checked per state via self_collision_blocked_overflow.
    extent = jnp.max(pred.max(axis=0) - origin)
    cell = jnp.maximum(2.0 * radius, extent / (g - 1))
    coords = jnp.clip(
        jnp.floor((pred - origin) / cell).astype(jnp.int32), 0, g - 1)
    return jnp.argsort(_hilbert_code(coords))


def self_collision_project_sorted(pred, inv_mass, order, cfg: SolverConfig):
    """One Jacobi separation pass over the Morton-sorted sliding window.

    Each particle is tested against its ``cfg.sorted_window`` successors in
    Morton order (every pair discovered once; the correction is applied to
    BOTH sides, mass-weighted, so the arithmetic matches the hash path).
    All hot-loop work is dense shifted arithmetic — the only gathers are
    the two permutations (sort/unsort) per pass.
    """
    n = pred.shape[0]
    w_win = min(cfg.sorted_window, n - 1)
    radius = cfg.particle_radius
    inv_order = jnp.argsort(order)

    ps = pred[order]                       # (N, 3)
    ws = inv_mass[order]                   # (N,)
    corr = jnp.zeros_like(ps)
    for j in range(1, w_win + 1):
        pi, pj = ps[:-j], ps[j:]
        wi, wj = ws[:-j], ws[j:]
        d = pi - pj
        dist = jnp.sqrt(jnp.maximum(jnp.sum(d * d, axis=-1), 1e-24))
        overlap = 2.0 * radius - dist
        wsum = wi + wj
        touch = (overlap > 0) & (dist > 1e-9) & (wsum > 1e-12)
        ndir = d / dist[..., None]
        mag = jnp.where(touch, overlap / jnp.maximum(wsum, 1e-12), 0.0)
        corr = corr.at[:n - j].add(ndir * (wi * mag)[..., None],
                                   indices_are_sorted=True,
                                   unique_indices=True)
        corr = corr.at[j:].add(-ndir * (wj * mag)[..., None],
                               indices_are_sorted=True,
                               unique_indices=True)
    return pred + cfg.self_collision_omega * corr[inv_order]


# ------------------------------------------------------------- dispatch
def project_self_collision(pred, inv_mass, order, cfg: SolverConfig):
    """One separation pass, backend-dispatched ((N,3) flat positions).

    The shared entry point for every engine (general, lattice stencil) so
    self-collision config semantics stay identical across them.  ``order``
    is the Morton sort computed once per substep (None for the hash/dense
    backends, which do not use it).
    """
    if cfg.self_collision_backend == "sorted":
        return self_collision_project_sorted(pred, inv_mass, order, cfg)
    if cfg.self_collision_backend == "blocked":
        return self_collision_project_blocked(pred, inv_mass, order, cfg)
    if cfg.self_collision_backend == "dense":
        return self_collision_project_dense(pred, inv_mass, cfg)
    return self_collision_project(pred, inv_mass, cfg)


def needs_morton_order(cfg: SolverConfig) -> bool:
    return cfg.enable_self_collision and cfg.self_collision_backend in (
        "sorted", "blocked")
