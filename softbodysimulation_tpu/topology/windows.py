"""Windowed one-hot incidence structure for the general (mesh) engine.

A matrix-unit answer to the reference's per-constraint scatter loops
(``SoftBodyCPU.cs:307-312``, ``XPBDSimulatorCS.compute:128-182``): the
Jacobi sweep is reformulated as dense block matmuls, for devices whose
irregular gathers are slow next to their matrix units (the ``gather``
backend computes the same sweep with indexed gathers):

1. particles are renumbered by reverse Cuthill-McKee so every edge connects
   nearby indices (bunny: bandwidth 2430 -> 135);
2. edges are sorted by min endpoint and cut into K blocks of S edges; each
   block touches a particle window of W contiguous (128-aligned) indices;
3. gathers become ``AB @ window`` and scatters become ``C @ corrections``
   with exact {0, +-1} one-hot block matrices — window extraction and
   overlap-add are themselves one-hot segment matmuls, so the entire sweep
   contains NO gather/scatter HLO at all.

Everything here runs once on host (NumPy); the arrays live in a ``Windows``
pytree attached to ``Topology``.
"""

from __future__ import annotations

import numpy as np

from ..core.state import HingeWindows, Windows


def rcm_order(edges: np.ndarray, n: int) -> np.ndarray:
    """Reverse Cuthill-McKee ordering. Returns ``order`` (new -> old index),
    i.e. particle ``order[i]`` of the input becomes particle ``i``."""
    adj = [[] for _ in range(n)]
    for a, b in edges:
        adj[int(a)].append(int(b))
        adj[int(b)].append(int(a))
    deg = np.array([len(a) for a in adj])
    visited = np.zeros(n, bool)
    order = []
    for start in np.argsort(deg, kind="stable"):
        if visited[start]:
            continue
        visited[start] = True
        queue = [int(start)]
        while queue:
            u = queue.pop(0)
            order.append(u)
            for v in sorted((v for v in adj[u] if not visited[v]),
                            key=lambda v: deg[v]):
                if visited[v]:      # duplicate adjacency entry
                    continue
                visited[v] = True
                queue.append(v)
    return np.array(order[::-1], dtype=np.int64)


def sort_edges_by_window(edges: np.ndarray):
    """Stable-sort edges by min endpoint (block locality). Returns the
    sort permutation (apply it to every per-edge array)."""
    return np.argsort(edges.min(axis=1), kind="stable")


def build_windows(edges: np.ndarray, n_particles: int, degree: np.ndarray,
                  block_edges: int = 128, max_window: int = 1024,
                  seg_align: int = 128, dtype=np.float32) -> Windows:
    """Build the one-hot window structure.

    ``edges`` must already be RCM-renumbered AND sorted by min endpoint
    (``rcm_order`` + ``sort_edges_by_window``); raises ValueError if any
    block's particle window exceeds ``max_window`` (mesh too irregular for
    the windowed backend — use the gather backend instead).
    """
    import jax.numpy as jnp

    E = len(edges)
    S = int(block_edges)
    K = max(1, -(-E // S))
    Epad = K * S
    pad = np.tile(edges[-1:], (Epad - E, 1)) if Epad > E else \
        np.zeros((0, 2), edges.dtype)
    e = np.vstack([edges, pad]).astype(np.int64)
    valid = (np.arange(Epad) < E).astype(np.float32).reshape(K, S)

    seg = int(seg_align)
    blocks = e.reshape(K, S, 2)
    bases = (blocks.min(axis=(1, 2)) // seg) * seg
    spans = blocks.max(axis=(1, 2)) - bases + 1
    W = int(seg * -(-int(spans.max()) // seg))
    if W > max_window:
        raise ValueError(
            f"windowed backend needs window {W} > max_window {max_window}; "
            "mesh bandwidth too large — use the gather backend")

    n_segs = max(-(-n_particles // seg),
                 int((bases.max() + W) // seg))
    # window piece p = (k, j) reads particle segment bases[k]//seg + j
    piece_seg = (bases[:, None] // seg + np.arange(W // seg)[None, :])
    P = K * (W // seg)
    piece_seg = piece_seg.reshape(P)
    win_onehot = np.zeros((P, n_segs), np.float32)
    win_onehot[np.arange(P), piece_seg] = 1.0
    seg_onehot = win_onehot.T.copy()      # overlap-ADD: rows sum pieces

    loc = blocks - bases[:, None, None]   # (K, S, 2) in [0, W)
    kk, ss = np.meshgrid(np.arange(K), np.arange(S), indexing="ij")
    # AB (K, 2S, W): rows 0..S-1 gather endpoint a, rows S..2S-1 endpoint b
    AB = np.zeros((K, 2 * S, W), np.float32)
    AB[kk, ss, loc[:, :, 0]] = valid
    AB[kk, ss + S, loc[:, :, 1]] = valid
    # C (K, W, 2S): scatter a-side corrections (cols 0..S-1) and b-side
    C = np.zeros((K, W, 2 * S), np.float32)
    C[kk, loc[:, :, 0], ss] = valid
    C[kk, loc[:, :, 1], ss + S] = valid

    deg = np.asarray(degree, np.float32)
    maxdeg = np.maximum(np.maximum(deg[e[:, 0]], deg[e[:, 1]]), 1.0)
    inv_maxdeg = (valid.reshape(-1) / maxdeg).reshape(K, S).astype(np.float32)

    # AB/C entries are {0, 1}: exact in bf16, halving the per-sweep HBM
    # traffic.  Accuracy does NOT ride on the one-hot dtype — the engine
    # splits the f32 DATA operand of every one-hot dot into three 8-bit
    # slices (ops/mxu_exact.py), exact at any matmul precision
    jdt = jnp.bfloat16 if str(dtype) in ("bf16", "bfloat16") else jnp.float32
    return Windows(
        AB=jnp.asarray(AB, jdt),
        C=jnp.asarray(C, jdt),
        valid=jnp.asarray(valid),
        inv_maxdeg=jnp.asarray(inv_maxdeg),
        win_onehot=jnp.asarray(win_onehot),
        seg_onehot=jnp.asarray(seg_onehot),
        n_blocks=K,
        block_edges=S,
        window=W,
        n_segs=int(n_segs),
        seg=seg,
    )


def sort_hinges_by_window(hinges: np.ndarray):
    """Stable-sort hinges by min endpoint (block locality)."""
    return np.argsort(hinges.min(axis=1), kind="stable")


def build_hinge_windows(hinges: np.ndarray, n_particles: int,
                        bend_degree: np.ndarray,
                        block_hinges: int = 128, max_window: int = 1024,
                        seg_align: int = 128,
                        dtype=np.float32) -> HingeWindows:
    """Build the signed one-hot window structure for the bending sweep
    (same blocking discipline as ``build_windows``; see
    ``core.state.HingeWindows`` for the algebra).  ``hinges`` must be
    RCM-renumbered AND sorted by min endpoint; raises ValueError when a
    block's window exceeds ``max_window``."""
    import jax.numpy as jnp

    h = len(hinges)
    s = int(block_hinges)
    k = max(1, -(-h // s))
    hpad = k * s
    pad = np.tile(hinges[-1:], (hpad - h, 1)) if hpad > h else \
        np.zeros((0, 4), hinges.dtype)
    hg = np.vstack([hinges, pad]).astype(np.int64)
    valid = (np.arange(hpad) < h).astype(np.float32).reshape(k, s)

    seg = int(seg_align)
    blocks = hg.reshape(k, s, 4)
    bases = (blocks.min(axis=(1, 2)) // seg) * seg
    spans = blocks.max(axis=(1, 2)) - bases + 1
    w = int(seg * -(-int(spans.max()) // seg))
    if w > max_window:
        raise ValueError(
            f"hinge windows need window {w} > max_window {max_window}; "
            "mesh bandwidth too large — use the gather bending path")

    n_segs = max(-(-n_particles // seg), int((bases.max() + w) // seg))
    piece_seg = (bases[:, None] // seg + np.arange(w // seg)[None, :])
    p = k * (w // seg)
    piece_seg = piece_seg.reshape(p)
    win_onehot = np.zeros((p, n_segs), np.float32)
    win_onehot[np.arange(p), piece_seg] = 1.0
    seg_onehot = win_onehot.T.copy()

    loc = blocks - bases[:, None, None]          # (k, s, 4) in [0, w)
    kk, ss = np.meshgrid(np.arange(k), np.arange(s), indexing="ij")
    vm = valid.reshape(k, s)
    # signed gather: lane block i in {0,1,2} computes e_i (tip - A).
    # padded slots keep all-zero columns (e = 0 -> geom_ok guard kills dl)
    g = np.zeros((k, w, 3 * s), np.float32)
    for i, tip in enumerate((1, 2, 3)):          # B, C, D
        g[kk, loc[:, :, tip], ss + i * s] += vm
        g[kk, loc[:, :, 0], ss + i * s] -= vm
    # endpoint inverse-mass gather ({0,1}; 4 lane blocks A,B,C,D)
    wsel = np.zeros((k, w, 4 * s), np.float32)
    for i in range(4):
        wsel[kk, loc[:, :, i], ss + i * s] = vm

    deg = np.asarray(bend_degree, np.float32)
    maxdeg = np.maximum(
        np.maximum(np.maximum(deg[hg[:, 0]], deg[hg[:, 1]]),
                   np.maximum(deg[hg[:, 2]], deg[hg[:, 3]])), 1.0)
    inv_maxdeg = (valid.reshape(-1) / maxdeg).reshape(k, s).astype(
        np.float32)

    # {0, +-1} entries are exact in bf16 (halves HBM traffic); the f32
    # data operand is split-compensated at use (same as Windows above)
    jdt = jnp.bfloat16 if str(dtype) in ("bf16", "bfloat16") else jnp.float32
    return HingeWindows(
        G=jnp.asarray(g, jdt),
        GT=jnp.asarray(np.ascontiguousarray(np.transpose(g, (0, 2, 1))),
                       jdt),
        wsel=jnp.asarray(wsel, jdt),
        valid=jnp.asarray(valid),
        inv_maxdeg=jnp.asarray(inv_maxdeg),
        win_onehot=jnp.asarray(win_onehot),
        seg_onehot=jnp.asarray(seg_onehot),
        n_blocks=k,
        block_hinges=s,
        window=w,
        n_segs=int(n_segs),
        seg=seg,
    )
