"""The structured-lattice plate of ``StructuredGridP1``: a frozen numpy
copy of the port's ``generate_structured_grid``
(``models/structured_grid.py``), itself the JAX package's recipe.

Returns the fields of a ``StructuredGrid`` as numpy arrays, which
``convert.grid_from_numpy`` takes as they are.
"""

from __future__ import annotations

import numpy as np

_TOL = 1e-6


def _rim(active: np.ndarray, nx: int, ny: int) -> np.ndarray:
    """Nodes that touch an active quad and an inactive one."""
    touched = np.zeros((nx, ny), bool)
    near_hole = np.zeros((nx, ny), bool)
    for di, dj in ((0, 0), (1, 0), (1, 1), (0, 1)):
        touched[di:nx - 1 + di, dj:ny - 1 + dj] |= active
        near_hole[di:nx - 1 + di, dj:ny - 1 + dj] |= ~active
    return touched & near_hole


def arrays(mesh: dict) -> dict:
    """``mesh``: length, height, holes, nx, ny, split, boundaries."""
    length, height = float(mesh["length"]), float(mesh["height"])
    nx, ny = int(mesh["nx"]), int(mesh["ny"])
    xs = np.linspace(0.0, length, nx)
    ys = np.linspace(0.0, height, ny)
    xv, yv = np.meshgrid(xs, ys, indexing="ij")

    inside = np.zeros((nx, ny), bool)
    for cx, cy, r in mesh["holes"]:
        inside |= ((xv - cx) ** 2 + (yv - cy) ** 2) <= r * r
    bad = inside[:-1, :-1] | inside[1:, :-1] | inside[1:, 1:] \
        | inside[:-1, 1:]
    quad_mask = (~bad).astype(np.float32)

    face = {"left": np.abs(xv) < _TOL, "right": np.abs(xv - length) < _TOL,
            "down": np.abs(yv) < _TOL, "up": np.abs(yv - height) < _TOL}
    geom = face["left"] | face["right"] | face["down"] | face["up"]
    geom |= inside | _rim(quad_mask > 0, nx, ny)

    adjacent = {"right": quad_mask[-1, :], "left": quad_mask[0, :],
                "up": quad_mask[:, -1], "down": quad_mask[:, 0]}
    dirichlet = np.zeros((nx, ny), bool)
    edge_masks = {}
    for f, condition in mesh["boundaries"].items():
        if condition == 1:
            dirichlet |= face[f]
        elif condition == 2:
            edge_masks[f] = (adjacent[f] > 0).astype(np.float32)
    return {"coords": np.stack([xv, yv], axis=-1).astype(np.float32),
            "geom_boundary_mask": geom, "dirichlet_mask": dirichlet,
            "quad_mask": quad_mask, "neumann_edge_masks": edge_masks,
            "u_dirichlet": None, "split": mesh["split"],
            "zigzag_phase": 0}
