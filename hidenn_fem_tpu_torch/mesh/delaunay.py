"""Native unstructured mesh generation, gmsh-free (port of
``hidenn_fem_tpu/mesh/delaunay.py``).

The plate-with-holes meshes of the reference's gmsh backend, from first
principles, with the JAX package's numpy/scipy steps (the same steps give
the same arrays):

1. sample the rectangle edges and hole rims at spacing ``lc`` (rim points
   exactly on the circles),
2. fill the interior with a hex lattice at spacing ``lc``, cleared
   ``0.6*lc`` away from every sampled curve,
3. Delaunay-triangulate (scipy/Qhull) and drop triangles whose centroid
   falls inside a hole,
4. Laplacian-smooth the interior nodes (boundary samples pinned) and
   re-triangulate,
5. orient every triangle CCW and hand the arrays to
   ``gmsh_backend.assemble_gmsh_mesh`` (identity tags, RCM reorder).

A callable ``lc(points[N, 2]) -> [N]`` grades the mesh: boundary curves
are walked with the local step and interior candidates are generated at
the finest spacing, then greedily sieved to the local density.

These meshes are genuinely irregular: lattice detection rejects them, and
above 250,000 gather rows ``TriMesh.from_arrays`` builds the banded tables
that carry their energy (``ops/banded_energy.py``).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple, Union

import numpy as np
import torch

from .gmsh_backend import assemble_gmsh_mesh, generate_mesh_gmsh, have_gmsh
from .types import TriMesh

__all__ = ["generate_mesh_delaunay", "generate_mesh_unstructured"]

_Size = Union[float, Callable[[np.ndarray], np.ndarray]]


def _lc_fn(lc: _Size) -> Callable[[np.ndarray], np.ndarray]:
    if callable(lc):
        return lambda p: np.asarray(lc(np.asarray(p, dtype=np.float64)),
                                    dtype=np.float64)
    return lambda p: np.full(len(p), float(lc))


def _walk_segment(p0, p1, lcf) -> np.ndarray:
    """Points along p0->p1 stepped by the local size (excludes p1)."""
    p0 = np.asarray(p0, dtype=np.float64)
    p1 = np.asarray(p1, dtype=np.float64)
    total = float(np.hypot(*(p1 - p0)))
    ts, t = [], 0.0
    while t < 1.0 - 1e-9:
        ts.append(t)
        step = float(lcf(((1 - t) * p0 + t * p1)[None])[0])
        t += max(step, 1e-6 * total) / total
    if not ts:
        ts = [0.0]
        t = 1.0
    # rescale so the walk closes exactly on p1 (the overshoot t >= 1
    # would otherwise leave a sliver interval against the corner)
    ts = np.asarray(ts) / max(t, 1.0)
    return p0[None] + ts[:, None] * (p1 - p0)[None]


def _walk_circle(cx, cy, r, lcf) -> np.ndarray:
    """Points on the circle stepped by the local size (min 12)."""
    lc_here = float(lcf(np.array([[cx + r, cy]]))[0])
    n = max(12, int(round(2 * np.pi * r / lc_here)))
    th = np.linspace(0.0, 2 * np.pi, n, endpoint=False)
    return np.stack([cx + r * np.cos(th), cy + r * np.sin(th)], axis=1)


def _hex_candidates(length, height, h) -> np.ndarray:
    """Hex lattice at spacing ``h`` strictly inside the rectangle."""
    dy = h * np.sqrt(3.0) / 2.0
    ys = np.arange(dy, height - 0.25 * h, dy)
    rows = []
    for k, y in enumerate(ys):
        x0 = h if k % 2 == 0 else h / 2.0
        xs = np.arange(x0, length - 0.25 * h, h)
        rows.append(np.stack([xs, np.full_like(xs, y)], axis=1))
    if not rows:
        return np.zeros((0, 2))
    return np.concatenate(rows, axis=0)


def _sieve(cands: np.ndarray, lcf, seed: int = 0) -> np.ndarray:
    """Greedy density sieve: keep a candidate iff no kept point lies
    within ``0.87*lc(candidate)``.  Chunked cKDTree queries (a stale
    tree within a chunk is acceptable for meshing — the Laplacian
    smoothing pass evens out near-misses)."""
    from scipy.spatial import cKDTree

    lc_c = lcf(cands)
    order = np.argsort(lc_c, kind="stable")   # finest regions first
    cands, lc_c = cands[order], lc_c[order]
    kept = np.zeros((0, 2))
    out = []
    for i in range(0, len(cands), 2048):
        chunk, lc_k = cands[i:i + 2048], lc_c[i:i + 2048]
        if len(kept):
            d, _ = cKDTree(kept).query(chunk, k=1)
            ok = d >= 0.87 * lc_k
            chunk, lc_k = chunk[ok], lc_k[ok]
        # within-chunk suppression, greedy in order
        sel = []
        for j in range(len(chunk)):
            if not sel:
                sel.append(j)
                continue
            d = np.min(np.hypot(*(chunk[sel] - chunk[j]).T))
            if d >= 0.87 * lc_k[j]:
                sel.append(j)
        chunk = chunk[sel]
        out.append(chunk)
        kept = np.concatenate([kept] + [chunk], axis=0)
    return np.concatenate(out, axis=0) if out else cands


def _clear_of_curves(pts, holes, length, height, lcf) -> np.ndarray:
    """Mask of points at least ``0.6*lc`` from every sampled curve."""
    lc_p = lcf(pts)
    keep = ((pts[:, 0] > 0.6 * lc_p) & (pts[:, 0] < length - 0.6 * lc_p)
            & (pts[:, 1] > 0.6 * lc_p) & (pts[:, 1] < height - 0.6 * lc_p))
    for cx, cy, r in holes:
        d = np.hypot(pts[:, 0] - cx, pts[:, 1] - cy)
        keep &= d > r + 0.6 * lc_p
    return keep


def _triangulate(points, holes):
    """Delaunay + hole-triangle removal + CCW orientation."""
    from scipy.spatial import Delaunay

    tri = Delaunay(points)
    cells = tri.simplices.astype(np.int64)
    cen = points[cells].mean(axis=1)
    keep = np.ones(len(cells), dtype=bool)
    for cx, cy, r in holes:
        keep &= np.hypot(cen[:, 0] - cx, cen[:, 1] - cy) >= r
    cells = cells[keep]
    v = points[cells]
    area2 = ((v[:, 1, 0] - v[:, 0, 0]) * (v[:, 2, 1] - v[:, 0, 1])
             - (v[:, 2, 0] - v[:, 0, 0]) * (v[:, 1, 1] - v[:, 0, 1]))
    flip = area2 < 0
    cells[flip] = cells[flip][:, [0, 2, 1]]
    cells = cells[np.abs(area2) > 1e-14]
    return cells


def _smooth(points, cells, n_fixed, iters):
    """Laplacian smoothing of interior nodes (first ``n_fixed`` pinned),
    re-triangulating is the caller's job."""
    for _ in range(iters):
        e = np.concatenate([cells[:, [0, 1]], cells[:, [1, 2]],
                            cells[:, [2, 0]]], axis=0)
        e = np.concatenate([e, e[:, ::-1]], axis=0)
        acc = np.zeros_like(points)
        cnt = np.zeros(len(points))
        np.add.at(acc, e[:, 0], points[e[:, 1]])
        np.add.at(cnt, e[:, 0], 1.0)
        avg = acc / np.maximum(cnt, 1.0)[:, None]
        points = points.copy()
        points[n_fixed:] = avg[n_fixed:]
    return points


def generate_mesh_delaunay(
    length: float = 2.0,
    height: float = 1.0,
    holes: List[Tuple[float, float, float]] = (
        (0.5, 0.7, 0.12), (1.0, 0.3, 0.15), (1.4, 0.6, 0.1)),
    boundaries: Dict[str, int] = None,
    lc: _Size = 1e-1,
    smooth_iters: int = 2,
    reorder: bool = True,
    dtype=torch.float32,
    device=None,
) -> TriMesh:
    """Rectangle-with-holes unstructured mesh, gmsh-free (module doc).

    Same arguments and defaults as :func:`generate_mesh_gmsh`; ``lc`` may
    also be a callable size field ``lc(points[N, 2]) -> [N]``.

    ``reorder`` applies the RCM node permutation and the min-node element
    sort before the tables are built: the raw order (boundary samples
    first, then the interior) scatters each element block's node window
    across the whole table.  Disable only to inspect the raw ordering.
    The tensors go to ``device``, the card unless given.
    """
    if boundaries is None:
        boundaries = {"up": 0, "down": 0, "right": 2, "left": 1}
    lcf = _lc_fn(lc)

    corners = [(0.0, 0.0), (length, 0.0), (length, height), (0.0, height)]
    bnd = [_walk_segment(corners[i], corners[(i + 1) % 4], lcf)
           for i in range(4)]
    bnd += [_walk_circle(cx, cy, r, lcf) for cx, cy, r in holes]
    bnd = np.concatenate(bnd, axis=0)
    n_bnd = len(bnd)

    h_min = float(np.min(lcf(bnd))) if callable(lc) else float(lc)
    cands = _hex_candidates(length, height, h_min)
    cands = cands[_clear_of_curves(cands, holes, length, height, lcf)]
    if callable(lc):
        cands = _sieve(cands, lcf)
    points = np.concatenate([bnd, cands], axis=0)

    cells = _triangulate(points, holes)
    if smooth_iters:
        points = _smooth(points, cells, n_bnd, smooth_iters)
        cells = _triangulate(points, holes)

    # compact away any node no kept triangle references (safety; the
    # clearance margins make this rare)
    used = np.zeros(len(points), dtype=bool)
    used[cells] = True
    if not used.all():
        new_id = np.cumsum(used) - 1
        points = points[used]
        cells = new_id[cells]
        n_bnd = int(used[:n_bnd].sum())
    bnd_idx = np.arange(n_bnd)

    return assemble_gmsh_mesh(
        node_tags=np.arange(len(points)),
        points=points,
        tri_tags=cells,
        boundary_node_tags=bnd_idx,
        holes=holes, boundaries=boundaries,
        length=length, height=height, reorder=reorder, dtype=dtype,
        device=device)


def generate_mesh_unstructured(*args, prefer_hybrid: bool = True,
                               **kwargs) -> TriMesh:
    """The hybrid lattice+collar generator when the geometry qualifies,
    else gmsh when installed, else the native Delaunay backend: one entry
    point for reference users migrating ``generate_mesh_gmsh`` call sites,
    dispatching as the JAX package's does.

    With ``prefer_hybrid=True`` a rectangle-with-circular-holes call whose
    keyword arguments ``generate_mesh_hybrid`` takes (a constant ``lc``,
    holes clear of the boundary quad ring) gets a hybrid mesh: the same
    geometry with exact circular rims, whose energy runs on the lattice
    route.  Otherwise gmsh if installed, else Delaunay."""
    if prefer_hybrid and not args and not callable(kwargs.get("lc", 0.1)):
        from .hybrid import generate_mesh_hybrid
        allowed = {"length", "height", "holes", "boundaries", "lc",
                   "dtype", "device"}
        if set(kwargs) <= allowed:
            try:
                return generate_mesh_hybrid(**kwargs)
            except ValueError:
                pass      # hole reaches the boundary ring: general path
    if have_gmsh():
        return generate_mesh_gmsh(*args, **kwargs)
    return generate_mesh_delaunay(*args, **kwargs)
