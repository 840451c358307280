"""The plate with circular holes on a structured triangulation: a frozen
numpy copy of the port's ``mesh/structured.py`` (``rectangle_tri_zigzag``
and ``generate_mesh``), which is itself the JAX package's recipe.

Returns the six arrays of ``TriMesh.from_arrays``.  With
``keep_dead_nodes`` the hole-interior nodes stay in the node table,
pinned (Dirichlet and frozen) and referenced by no triangle, so the node
numbering is the lattice's.
"""

from __future__ import annotations

import numpy as np

_TOL = 1e-6


def _cells(nx: int, ny: int, variant: str) -> np.ndarray:
    """Two counter-clockwise triangles per quad, interleaved, node index
    i * ny + j; "zigzag" alternates the diagonal by the parity of i + j."""
    i, j = np.meshgrid(np.arange(nx - 1), np.arange(ny - 1), indexing="ij")
    i, j = i.ravel(), j.ravel()
    n00 = i * ny + j
    n10 = (i + 1) * ny + j
    n01 = i * ny + (j + 1)
    n11 = (i + 1) * ny + (j + 1)
    up0 = np.stack([n00, n10, n11], axis=1)
    up1 = np.stack([n00, n11, n01], axis=1)
    dn0 = np.stack([n00, n10, n01], axis=1)
    dn1 = np.stack([n10, n11, n01], axis=1)
    if variant == "up":
        t0, t1 = up0, up1
    elif variant == "down":
        t0, t1 = dn0, dn1
    elif variant == "zigzag":
        even = ((i + j) % 2 == 0)[:, None]
        t0 = np.where(even, up0, dn0)
        t1 = np.where(even, up1, dn1)
    else:
        raise ValueError(f"unknown variant {variant!r}")
    return np.stack([t0, t1], axis=1).reshape(-1, 3)


def _face(points: np.ndarray, face: str, length: float,
          height: float) -> np.ndarray:
    x, y = points[:, 0], points[:, 1]
    return {"up": np.abs(y - height) < _TOL, "down": np.abs(y) < _TOL,
            "left": np.abs(x) < _TOL,
            "right": np.abs(x - length) < _TOL}[face]


def _unique_pairs(pairs: np.ndarray) -> np.ndarray:
    lo = pairs.min(axis=1)
    hi = pairs.max(axis=1)
    keys = np.unique((lo << 32) | hi)
    return np.stack([keys >> 32, keys & 0xFFFFFFFF], axis=1)


def arrays(mesh: dict) -> dict:
    """``mesh``: length, height, holes [[cx, cy, r], ...], nx, ny,
    variant, keep_dead_nodes, boundaries {face: 0 none | 1 Dirichlet |
    2 traction}."""
    length, height = float(mesh["length"]), float(mesh["height"])
    nx, ny = int(mesh["nx"]), int(mesh["ny"])
    xs = np.linspace(0.0, length, nx)
    ys = np.linspace(0.0, height, ny)
    xv, yv = np.meshgrid(xs, ys, indexing="ij")
    points = np.stack([xv.ravel(), yv.ravel()], axis=1)
    cells = _cells(nx, ny, mesh["variant"])

    keep = np.ones(points.shape[0], dtype=bool)
    for cx, cy, r in mesh["holes"]:
        dx = points[:, 0] - cx
        dy = points[:, 1] - cy
        keep &= (dx * dx + dy * dy) > r * r
    if mesh["keep_dead_nodes"]:
        kept = points
        old_to_new = np.arange(points.shape[0], dtype=np.int64)
    else:
        kept = points[keep]
        old_to_new = -np.ones(points.shape[0], dtype=np.int64)
        old_to_new[keep] = np.arange(kept.shape[0])

    tri_keep = keep[cells].all(axis=1)
    conn = old_to_new[cells[tri_keep]]
    geom = np.zeros(kept.shape[0], dtype=bool)
    partial = cells[~tri_keep]
    if partial.size:
        geom[old_to_new[partial[keep[partial]]]] = True
    dead = ~keep if mesh["keep_dead_nodes"] else None
    if dead is not None:
        geom |= dead
    for face in ("up", "down", "left", "right"):
        geom |= _face(kept, face, length, height)

    dirichlet = np.zeros(kept.shape[0], dtype=bool)
    neumann = np.zeros(kept.shape[0], dtype=bool)
    for face, condition in mesh["boundaries"].items():
        if condition == 1:
            dirichlet |= _face(kept, face, length, height)
        elif condition == 2:
            neumann |= _face(kept, face, length, height)
    if dead is not None:
        dirichlet |= dead
        neumann &= ~dead

    on_face = neumann[conn]
    cand = [conn[on_face[:, a] & on_face[:, b]][:, [a, b]]
            for a, b in ((0, 1), (1, 2), (2, 0))]
    cand = np.concatenate(cand, axis=0).astype(np.int64)
    edges = (_unique_pairs(cand) if cand.size
             else np.zeros((0, 2), dtype=np.int64))
    return {"coords": kept.astype(np.float32), "connectivity": conn,
            "geom_boundary_mask": geom, "dirichlet_mask": dirichlet,
            "neumann_mask": neumann, "neumann_edges": edges}
