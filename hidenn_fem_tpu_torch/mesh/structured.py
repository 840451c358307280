"""Structured triangular mesh generation (port of
``hidenn_fem_tpu/mesh/structured.py``; host-side numpy, the same arrays as
the JAX package's numpy paths)."""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from .types import TriMesh

__all__ = ["rectangle_tri_zigzag", "unique_edges", "generate_mesh",
           "proxy_plate_mesh"]

_TOL = 1e-6


def rectangle_tri_zigzag(nx: int, ny: int, length: float, height: float,
                         variant: str = "zigzag"
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Triangulate [0,length]x[0,height] on an nx-by-ny point grid.

    variant: "zigzag" (alternating diagonals by (i+j) parity), "up"
    (every quad split along n00-n11) or "down" (along n10-n01).  All
    triangles are counter-clockwise.  Returns (points [N,2] f64, cells
    [Ne,3] int64), node index i*ny + j.
    """
    xs = np.linspace(0.0, length, nx)
    ys = np.linspace(0.0, height, ny)
    xv, yv = np.meshgrid(xs, ys, indexing="ij")
    points = np.stack([xv.ravel(), yv.ravel()], axis=1)

    i, j = np.meshgrid(np.arange(nx - 1), np.arange(ny - 1), indexing="ij")
    i = i.ravel()
    j = j.ravel()
    n00 = i * ny + j
    n10 = (i + 1) * ny + j
    n01 = i * ny + (j + 1)
    n11 = (i + 1) * ny + (j + 1)

    up0 = np.stack([n00, n10, n11], axis=1)    # diagonal n00-n11
    up1 = np.stack([n00, n11, n01], axis=1)
    dn0 = np.stack([n00, n10, n01], axis=1)    # diagonal n10-n01
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
    # interleave the two triangles of each quad (banded element order)
    cells = np.stack([t0, t1], axis=1).reshape(-1, 3)
    return points, cells


def _face_mask(points: np.ndarray, face: str, length: float,
               height: float) -> np.ndarray:
    if face == "up":
        return np.abs(points[:, 1] - height) < _TOL
    if face == "down":
        return np.abs(points[:, 1] - 0.0) < _TOL
    if face == "left":
        return np.abs(points[:, 0] - 0.0) < _TOL
    if face == "right":
        return np.abs(points[:, 0] - length) < _TOL
    return np.zeros(points.shape[0], dtype=bool)


def _pack_unique(pairs: np.ndarray) -> np.ndarray:
    """Unique sorted (lo, hi) rows of an int64 [M, 2] pair array."""
    lo = pairs.min(axis=1)
    hi = pairs.max(axis=1)
    keys = np.unique((lo << 32) | hi)
    return np.stack([keys >> 32, keys & 0xFFFFFFFF], axis=1)


def unique_edges(cells: np.ndarray) -> np.ndarray:
    """All unique (sorted) element edges, deduplicated as int64 keys."""
    cells = np.ascontiguousarray(cells, dtype=np.int64)
    return _pack_unique(np.concatenate(
        [cells[:, [0, 1]], cells[:, [1, 2]], cells[:, [2, 0]]], axis=0))


def generate_mesh(
    length: float = 2.0,
    height: float = 1.0,
    holes: List[Tuple[float, float, float]] = (
        (0.5, 0.7, 0.12), (1.0, 0.3, 0.15), (1.4, 0.6, 0.1)),
    boundaries: Dict[str, int] = None,
    nx: int = 100,
    ny: int = 50,
    variant: str = "zigzag",
    keep_dead_nodes: bool = False,
    dtype=torch.float32,
    device=None,
) -> TriMesh:
    """Rectangle-with-holes triangular mesh + BC tags.

    ``boundaries`` maps face -> {0: none, 1: Dirichlet, 2: Neumann}.
    ``keep_dead_nodes=True`` keeps hole-interior nodes (pinned Dirichlet
    and frozen, referenced by no triangle) instead of renumbering; such
    nodes have all -1 incidence rows and get exactly zero gradients.
    """
    if boundaries is None:
        boundaries = {"up": 0, "down": 0, "right": 2, "left": 1}

    points, cells = rectangle_tri_zigzag(nx, ny, length, height, variant)

    keep = np.ones(points.shape[0], dtype=bool)
    for cx, cy, r in holes:
        dx = points[:, 0] - cx
        dy = points[:, 1] - cy
        keep &= (dx * dx + dy * dy) > r * r
    if keep_dead_nodes:
        points_kept = points
        old_to_new = np.arange(points.shape[0], dtype=np.int64)
    else:
        points_kept = points[keep]
        old_to_new = -np.ones(points.shape[0], dtype=np.int64)
        old_to_new[keep] = np.arange(points_kept.shape[0])

    # keep fully-surviving triangles; survivors of cut triangles are
    # geometric boundary nodes
    tri_keep = keep[cells].all(axis=1)
    cells_kept = old_to_new[cells[tri_keep]]
    geom_boundary = np.zeros(points_kept.shape[0], dtype=bool)
    partial = cells[~tri_keep]
    if partial.size:
        surv = partial[keep[partial]]
        geom_boundary[old_to_new[surv]] = True
    dead = ~keep if keep_dead_nodes else None
    if dead is not None:
        geom_boundary |= dead

    for face in ("up", "down", "left", "right"):
        geom_boundary |= _face_mask(points_kept, face, length, height)

    bc_mask = np.zeros(points_kept.shape[0], dtype=bool)
    mn_mask = np.zeros(points_kept.shape[0], dtype=bool)
    for face, condition in boundaries.items():
        if condition == 0:
            continue
        m = _face_mask(points_kept, face, length, height)
        if condition == 1:
            bc_mask |= m
        elif condition == 2:
            mn_mask |= m
    if dead is not None:
        bc_mask |= dead
        mn_mask &= ~dead

    # Neumann edges: both endpoints Neumann; filter candidates before the
    # dedup so it stays O(boundary)
    mn_elem = mn_mask[cells_kept]
    cand = []
    for a, b in ((0, 1), (1, 2), (2, 0)):
        sel = mn_elem[:, a] & mn_elem[:, b]
        if sel.any():
            cand.append(cells_kept[sel][:, [a, b]])
    if cand:
        neumann_edges = _pack_unique(
            np.concatenate(cand, axis=0).astype(np.int64))
    else:
        neumann_edges = np.zeros((0, 2), dtype=np.int64)

    return TriMesh.from_arrays(
        coords=points_kept.astype(np.float32),
        connectivity=cells_kept,
        geom_boundary_mask=geom_boundary,
        dirichlet_mask=bc_mask,
        neumann_mask=mn_mask,
        neumann_edges=neumann_edges,
        dtype=dtype,
        device=device,
    )


def proxy_plate_mesh(nx: int = 81, ny: int = 41, length: float = 2.0,
                     height: float = 1.0, variant: str = "up",
                     dtype=torch.float32, device=None) -> TriMesh:
    """The hole-free benchmark plate: left edge Dirichlet, right edge
    Neumann; nx=81, ny=41 gives 6,400 elements / 3,321 nodes."""
    return generate_mesh(length=length, height=height, holes=(),
                         boundaries={"up": 0, "down": 0, "right": 2,
                                     "left": 1},
                         nx=nx, ny=ny, variant=variant, dtype=dtype,
                         device=device)
