"""The plate with circular holes, meshed with exact rims at lattice speed:
a structured triangular lattice wherever the plate is rectangular, and a
thin Delaunay collar tying each hole's exact rim to the lattice.  A frozen
numpy/scipy copy of the port's hybrid generator (``mesh/hybrid.py``'s
``generate_mesh_hybrid``), which is example 12's mesh:

1. an (nx, ny) node lattice over the rectangle at spacing ``lc``; a node
   within ``clear * h`` of a hole is bad (h the larger spacing), and a
   quad with a bad corner is dead;
2. the live quads split along the diagonal ``variant`` ("up", "down",
   "zigzag"), the first triangle of every live quad, then the second;
3. each rim sampled at spacing ``lc`` (exact circles), and the staircase
   nodes (not bad, on a dead quad) Delaunay-triangulated with the rim
   points (scipy/Qhull); a triangle is kept where its centroid lies in a
   dead quad and outside every hole, zero-area slivers (collinear
   staircase triples) dropped, every triangle counter-clockwise; the kept
   triangles must tile the dead region less the rim polygons, by area;
4. Dirichlet and traction faces from ``boundaries``; the dead lattice
   nodes kept, used by no triangle, pinned (Dirichlet and geometric
   boundary); the rim points geometric boundary; the Neumann edges the
   triangle edges with both ends on a traction face.

The node table is [lattice nodes (lexicographic, node i * ny + j) | rim
points], the triangles [lattice | collar]: the layout of the port's
``hybrid_mesh_from_arrays``.  Returns the six arrays of a mesh and
``nx``, ``ny`` and ``variant``.  ``arrays`` keeps what it built for each
configuration, so a process builds the 847K plate once (its set-up and
its check share it).
"""

from __future__ import annotations

import json

import numpy as np

_BUILT: dict = {}
SIX = ("coords", "connectivity", "geom_boundary_mask", "dirichlet_mask",
       "neumann_mask", "neumann_edges")


def _walk_circle(cx, cy, r, lc: float) -> np.ndarray:
    n = max(12, int(round(2 * np.pi * r / lc)))
    th = np.linspace(0.0, 2 * np.pi, n, endpoint=False)
    return np.stack([cx + r * np.cos(th), cy + r * np.sin(th)], axis=1)


def _shoelace(pts: np.ndarray) -> float:
    x, y = pts[:, 0], pts[:, 1]
    return 0.5 * float(np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y))


def _lattice_triangles(live, variant, nx, ny) -> np.ndarray:
    sel = np.zeros((nx - 1, ny - 1), dtype=bool)
    if variant == "up":
        sel[:] = True
    elif variant == "zigzag":
        sel = np.add.outer(np.arange(nx - 1), np.arange(ny - 1)) % 2 == 0
    qi, qj = np.nonzero(live)
    up = sel[qi, qj]
    n00 = qi * ny + qj
    n10 = (qi + 1) * ny + qj
    n01 = qi * ny + (qj + 1)
    n11 = (qi + 1) * ny + (qj + 1)
    t1 = np.where(up[:, None], np.stack([n00, n10, n11], 1),
                  np.stack([n00, n10, n01], 1))
    t2 = np.where(up[:, None], np.stack([n00, n11, n01], 1),
                  np.stack([n10, n11, n01], 1))
    return np.concatenate([t1, t2], axis=0).astype(np.int64)


def _collar(lat_pts, badg, dead, rim_pts, holes, nx, ny, hx, hy,
            rim_area) -> np.ndarray:
    from scipy.spatial import Delaunay

    n_lat = nx * ny
    inc_dead = np.zeros((nx, ny), dtype=bool)
    inc_dead[:-1, :-1] |= dead
    inc_dead[1:, :-1] |= dead
    inc_dead[:-1, 1:] |= dead
    inc_dead[1:, 1:] |= dead
    stair = np.nonzero((~badg & inc_dead).ravel())[0]
    pts = np.concatenate([lat_pts[stair], rim_pts], axis=0)
    gids = np.concatenate([stair, n_lat + np.arange(len(rim_pts))])
    cells = Delaunay(pts).simplices.astype(np.int64)
    cen = pts[cells].mean(axis=1)
    keep = np.ones(len(cells), dtype=bool)
    for cx, cy, r in holes:
        keep &= np.hypot(cen[:, 0] - cx, cen[:, 1] - cy) >= r
    ci = np.clip((cen[:, 0] / hx).astype(np.int64), 0, nx - 2)
    cj = np.clip((cen[:, 1] / hy).astype(np.int64), 0, ny - 2)
    keep &= dead[ci, cj]
    cells = cells[keep]
    v = pts[cells]
    area2 = ((v[:, 1, 0] - v[:, 0, 0]) * (v[:, 2, 1] - v[:, 0, 1])
             - (v[:, 2, 0] - v[:, 0, 0]) * (v[:, 1, 1] - v[:, 0, 1]))
    sliver = np.abs(area2) < 1e-6 * hx * hy
    cells, area2 = cells[~sliver], area2[~sliver]
    flip = area2 < 0
    cells[flip] = cells[flip][:, [0, 2, 1]]
    got = 0.5 * float(np.abs(area2).sum())
    want = float(dead.sum()) * hx * hy - abs(rim_area)
    if not np.isclose(got, want, rtol=1e-8, atol=1e-12):
        raise ValueError(f"the collar does not tile the dead region "
                         f"(area {got:.12g} against {want:.12g})")
    return gids[cells]


def _build(mesh: dict) -> dict:
    length, height = float(mesh["length"]), float(mesh["height"])
    holes = [tuple(float(v) for v in h) for h in mesh["holes"]]
    lc, clear = float(mesh["lc"]), float(mesh["clear"])
    variant = mesh["variant"]

    nx = max(2, int(round(length / lc)) + 1)
    ny = max(2, int(round(height / lc)) + 1)
    hx, hy = length / (nx - 1), height / (ny - 1)
    h = max(hx, hy)
    gx, gy = np.meshgrid(np.linspace(0.0, length, nx),
                         np.linspace(0.0, height, ny), indexing="ij")
    lat_pts = np.stack([gx.ravel(), gy.ravel()], axis=1)
    bad = np.zeros(nx * ny, dtype=bool)
    for cx, cy, r in holes:
        bad |= np.hypot(lat_pts[:, 0] - cx,
                        lat_pts[:, 1] - cy) < r + clear * h
    badg = bad.reshape(nx, ny)
    dead = (badg[:-1, :-1] | badg[1:, :-1] | badg[:-1, 1:] | badg[1:, 1:])
    if dead[0, :].any() or dead[-1, :].any() or dead[:, 0].any() \
            or dead[:, -1].any():
        raise ValueError("a hole reaches the boundary quad ring")
    lat_cells = _lattice_triangles(~dead, variant, nx, ny)

    rims = [_walk_circle(cx, cy, r, lc) for cx, cy, r in holes]
    rim_pts = np.concatenate(rims, axis=0) if rims else np.zeros((0, 2))
    extra = np.zeros((0, 3), dtype=np.int64)
    if dead.any():
        extra = _collar(lat_pts, badg, dead, rim_pts, holes, nx, ny, hx,
                        hy, sum(_shoelace(rp) for rp in rims))
    coords = np.concatenate([lat_pts, rim_pts], axis=0)
    cells = np.concatenate([lat_cells, extra], axis=0)
    n, n_lat = len(coords), nx * ny

    tol = 1e-9 * max(length, height)
    faces = {"left": np.abs(coords[:, 0]) < tol,
             "right": np.abs(coords[:, 0] - length) < tol,
             "down": np.abs(coords[:, 1]) < tol,
             "up": np.abs(coords[:, 1] - height) < tol}
    used = np.zeros(n, dtype=bool)
    used[cells] = True
    pinned = ~used
    geom = faces["left"] | faces["right"] | faces["down"] | faces["up"]
    geom[n_lat:] = True
    geom |= pinned
    dirichlet = pinned.copy()
    neumann = np.zeros(n, dtype=bool)
    for face, condition in mesh["boundaries"].items():
        if condition == 1:
            dirichlet |= faces[face]
        elif condition == 2:
            neumann |= faces[face]
    neumann &= ~pinned

    on = neumann[cells]
    pairs = [cells[on[:, a] & on[:, b]][:, [a, b]]
             for a, b in ((0, 1), (1, 2), (2, 0))]
    pairs = np.concatenate(pairs, axis=0)
    keys = np.unique((pairs.min(axis=1) << 32) | pairs.max(axis=1))
    edges = np.stack([keys >> 32, keys & 0xFFFFFFFF], axis=1)
    return {"coords": coords.astype(np.float32), "connectivity": cells,
            "geom_boundary_mask": geom, "dirichlet_mask": dirichlet,
            "neumann_mask": neumann, "neumann_edges": edges,
            "nx": nx, "ny": ny, "variant": variant}


def arrays(mesh: dict) -> dict:
    """``mesh``: length, height, holes [[cx, cy, r], ...], lc, variant,
    clear, boundaries {face: 0 none | 1 Dirichlet | 2 traction}.  The six
    arrays (``SIX``) and nx, ny, variant."""
    key = json.dumps(mesh, sort_keys=True)
    if key not in _BUILT:
        _BUILT[key] = _build(mesh)
    return _BUILT[key]
