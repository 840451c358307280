"""The plate with circular holes, meshed as the reference meshes it: an
unstructured triangulation with exact circular rims.  A frozen numpy/scipy
copy of the port's gmsh-free generator at a constant size ``lc``
(``mesh/delaunay.py``'s ``generate_mesh_delaunay``) and of the parts of
``gmsh_backend.assemble_gmsh_mesh`` it uses: geometric-boundary and
Neumann tagging, the reverse-Cuthill-McKee node order and the min-node
element sort.

1. the rectangle's edges and the hole rims sampled at spacing ``lc``
   (rim points exactly on the circles);
2. the interior filled by a hex lattice at spacing ``lc``, cleared
   ``0.6 lc`` away from every sampled curve;
3. Delaunay (scipy/Qhull), triangles whose centroid lies in a hole
   dropped, every triangle counter-clockwise;
4. ``smooth_iters`` Laplacian passes over the interior nodes, and the
   triangulation made again.

Returns the six arrays of ``TriMesh.from_arrays``.  ``arrays`` keeps what
it built for each configuration, so a process builds the 898K plate once
(its set-up and its check share it).
"""

from __future__ import annotations

import json

import numpy as np

_TOL = 1e-6
_BUILT: dict = {}


def _walk_segment(p0, p1, lc: float) -> np.ndarray:
    """Points along p0 -> p1 stepped by ``lc`` (p1 excluded), rescaled so
    that the walk closes exactly on p1."""
    p0 = np.asarray(p0, dtype=np.float64)
    p1 = np.asarray(p1, dtype=np.float64)
    total = float(np.hypot(*(p1 - p0)))
    ts, t = [], 0.0
    while t < 1.0 - 1e-9:
        ts.append(t)
        t += max(lc, 1e-6 * total) / total
    if not ts:
        ts, t = [0.0], 1.0
    ts = np.asarray(ts) / max(t, 1.0)
    return p0[None] + ts[:, None] * (p1 - p0)[None]


def _walk_circle(cx, cy, r, lc: float) -> np.ndarray:
    n = max(12, int(round(2 * np.pi * r / lc)))
    th = np.linspace(0.0, 2 * np.pi, n, endpoint=False)
    return np.stack([cx + r * np.cos(th), cy + r * np.sin(th)], axis=1)


def _hex_candidates(length, height, h) -> np.ndarray:
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


def _clear_of_curves(pts, holes, length, height, lc) -> np.ndarray:
    m = 0.6 * lc
    keep = ((pts[:, 0] > m) & (pts[:, 0] < length - m)
            & (pts[:, 1] > m) & (pts[:, 1] < height - m))
    for cx, cy, r in holes:
        keep &= np.hypot(pts[:, 0] - cx, pts[:, 1] - cy) > r + m
    return keep


def _triangulate(points, holes) -> np.ndarray:
    from scipy.spatial import Delaunay

    cells = Delaunay(points).simplices.astype(np.int64)
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
    return cells[np.abs(area2) > 1e-14]


def _smooth(points, cells, n_fixed, iters) -> np.ndarray:
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


def _face(points, face, length, height) -> np.ndarray:
    x, y = points[:, 0], points[:, 1]
    return {"up": np.abs(y - height) < _TOL, "down": np.abs(y) < _TOL,
            "left": np.abs(x) < _TOL,
            "right": np.abs(x - length) < _TOL}[face]


def _rcm(cells: np.ndarray, n: int) -> np.ndarray:
    """The reverse-Cuthill-McKee order (new position -> old index)."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    rows = np.concatenate([cells[:, 0], cells[:, 1], cells[:, 2]])
    cols = np.concatenate([cells[:, 1], cells[:, 2], cells[:, 0]])
    adj = sp.coo_matrix((np.ones(rows.size, dtype=np.int8), (rows, cols)),
                        shape=(n, n))
    adj = (adj + adj.T).tocsr()
    return np.asarray(reverse_cuthill_mckee(adj, symmetric_mode=True))


def _unique_edges(cells: np.ndarray) -> np.ndarray:
    pairs = np.concatenate([cells[:, [0, 1]], cells[:, [1, 2]],
                            cells[:, [2, 0]]], axis=0).astype(np.int64)
    lo, hi = pairs.min(axis=1), pairs.max(axis=1)
    keys = np.unique((lo << 32) | hi)
    return np.stack([keys >> 32, keys & 0xFFFFFFFF], axis=1)


def _build(mesh: dict) -> dict:
    length, height = float(mesh["length"]), float(mesh["height"])
    holes = [tuple(float(v) for v in h) for h in mesh["holes"]]
    lc = float(mesh["lc"])

    corners = [(0.0, 0.0), (length, 0.0), (length, height), (0.0, height)]
    bnd = [_walk_segment(corners[i], corners[(i + 1) % 4], lc)
           for i in range(4)]
    bnd += [_walk_circle(cx, cy, r, lc) for cx, cy, r in holes]
    bnd = np.concatenate(bnd, axis=0)
    n_bnd = len(bnd)
    cands = _hex_candidates(length, height, lc)
    cands = cands[_clear_of_curves(cands, holes, length, height, lc)]
    points = np.concatenate([bnd, cands], axis=0)

    cells = _triangulate(points, holes)
    if int(mesh["smooth_iters"]):
        points = _smooth(points, cells, n_bnd, int(mesh["smooth_iters"]))
        cells = _triangulate(points, holes)
    used = np.zeros(len(points), dtype=bool)
    used[cells] = True
    if not used.all():
        new_id = np.cumsum(used) - 1
        points, cells = points[used], new_id[cells]
        n_bnd = int(used[:n_bnd].sum())

    geom = np.zeros(len(points), dtype=bool)
    geom[:n_bnd] = True
    for cx, cy, r in holes:
        geom |= np.abs(np.hypot(points[:, 0] - cx, points[:, 1] - cy)
                       - r) < 1e-6
    dirichlet = np.zeros(len(points), dtype=bool)
    neumann = np.zeros(len(points), dtype=bool)
    for face, condition in mesh["boundaries"].items():
        if condition == 1:
            dirichlet |= _face(points, face, length, height)
        elif condition == 2:
            neumann |= _face(points, face, length, height)

    if mesh["reorder"]:
        perm = _rcm(cells, len(points))
        inv = np.empty(len(points), dtype=np.int64)
        inv[perm] = np.arange(len(points))
        points, geom = points[perm], geom[perm]
        dirichlet, neumann = dirichlet[perm], neumann[perm]
        cells = inv[cells]
        cells = cells[np.argsort(cells.min(axis=1), kind="stable")]
    edges = _unique_edges(cells)
    return {"coords": points.astype(np.float32), "connectivity": cells,
            "geom_boundary_mask": geom, "dirichlet_mask": dirichlet,
            "neumann_mask": neumann,
            "neumann_edges": edges[np.all(neumann[edges], axis=1)]}


def arrays(mesh: dict) -> dict:
    """``mesh``: length, height, holes [[cx, cy, r], ...], lc,
    smooth_iters, reorder, boundaries {face: 0 none | 1 Dirichlet |
    2 traction}."""
    key = json.dumps(mesh, sort_keys=True)
    if key not in _BUILT:
        _BUILT[key] = _build(mesh)
    return _BUILT[key]
