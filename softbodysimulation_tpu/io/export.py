"""Headless frame export: the render path without a renderer.

Replaces the reference's per-frame mesh update + engine-native normal
recompute + async readback pipeline (``SoftBodySimulator.cs:793-878``) with
an explicit export boundary: positions (and normals, computed on device by
``ops/normals.py``) cross to the host ONLY here.
"""

from __future__ import annotations

import os

import numpy as np

from ..core.state import SimState, Topology
from ..ops.normals import vertex_normals


def frame_arrays(state: SimState, topo: Topology,
                 recenter_com: bool = False):
    """(positions, normals, triangles) as host arrays — one device_get.

    recenter_com=True writes positions relative to the body's center of
    mass, matching the reference's per-frame COM-follow transform
    (``SoftBodySimulator.cs:850-863``: the render mesh is recentered on the
    COM and the transform carries the world offset)."""
    normals = vertex_normals(state.positions, topo.triangles)
    pos = np.asarray(state.positions)
    if recenter_com:
        pos = pos - pos.mean(axis=0)
    return (
        pos,
        np.asarray(normals),
        np.asarray(topo.triangles),
    )


def export_obj(path: str, state: SimState, topo: Topology,
               faceted: bool = False, recenter_com: bool = False) -> None:
    """Write the deformed surface as a Wavefront OBJ with normals.

    faceted=True duplicates vertices per face with flat face normals — the
    analog of the reference's 24-vertex display cube driven by 8 particles
    (``SoftBodyCubeCPU.cs:351-411``), for hard-shaded rendering.
    recenter_com=True applies the reference's COM-follow recentering
    (``SoftBodySimulator.cs:850-863``)."""
    pos, nrm, tri = frame_arrays(state, topo, recenter_com=recenter_com)
    _write_obj(path, pos, nrm, tri, faceted)


def export_npz(path: str, state: SimState, topo: Topology) -> None:
    pos, nrm, tri = frame_arrays(state, topo)
    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    np.savez(path, positions=pos, normals=nrm, triangles=tri)


class AsyncExporter:
    """Overlapped export pipeline — the honest device-side analog of the
    reference's double-buffered ``AsyncGPUReadback`` (``SoftBodySimulator.cs:
    793-823``).

    ``submit`` enqueues device arrays WITHOUT forcing them; a worker thread
    materializes (device->host fetch) and writes the OBJ while the main
    thread keeps dispatching simulation steps, so export I/O overlaps
    compute instead of blocking the device every frame.  ``max_pending``
    bounds the queue (back-pressure instead of unbounded device-buffer
    retention).  Use as a context manager or call ``close()``.
    """

    def __init__(self, max_pending: int = 2):
        import queue
        import threading

        self._q = queue.Queue(maxsize=max_pending)
        self._err = None
        self.written = 0

        def worker():
            while True:
                item = self._q.get()
                if item is None:
                    return
                path, pos, nrm, tri, faceted, recenter = item
                try:
                    pos = np.asarray(pos)   # blocks HERE, off-thread
                    if recenter:
                        pos = pos - pos.mean(axis=0)
                    _write_obj(path, pos, np.asarray(nrm),
                               np.asarray(tri), faceted)
                    self.written += 1
                except Exception as e:  # noqa: BLE001 — surfaced on close
                    self._err = e

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def submit(self, path: str, state: SimState, topo: Topology,
               faceted: bool = False, recenter_com: bool = False) -> None:
        normals = vertex_normals(state.positions, topo.triangles)
        self._q.put((path, state.positions, normals, topo.triangles,
                     faceted, recenter_com))

    def close(self) -> None:
        self._q.put(None)
        self._thread.join()
        if self._err is not None:
            raise self._err

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def _write_obj(path, pos, nrm, tri, faceted: bool) -> None:
    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    if faceted:
        p1, p2, p3 = pos[tri[:, 0]], pos[tri[:, 1]], pos[tri[:, 2]]
        fn = np.cross(p2 - p1, p3 - p1)
        lens = np.linalg.norm(fn, axis=1, keepdims=True)
        fn = fn / np.maximum(lens, 1e-12)
        with open(path, "w") as f:
            f.write("# softbodysimulation_tpu export (faceted)\n")
            for tri_pts in zip(p1, p2, p3):
                for p in tri_pts:
                    f.write(f"v {p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")
            for n in fn:
                f.write(f"vn {n[0]:.6f} {n[1]:.6f} {n[2]:.6f}\n")
            for i in range(len(tri)):
                a = 3 * i + 1
                ni = i + 1
                f.write(f"f {a}//{ni} {a + 1}//{ni} {a + 2}//{ni}\n")
        return
    with open(path, "w") as f:
        f.write("# softbodysimulation_tpu export\n")
        for p in pos:
            f.write(f"v {p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")
        for n in nrm:
            f.write(f"vn {n[0]:.6f} {n[1]:.6f} {n[2]:.6f}\n")
        for t in tri:
            a, b, c = t + 1
            f.write(f"f {a}//{a} {b}//{b} {c}//{c}\n")
