"""The structured-lattice plate as P1 triangles: node (i, j) is
i * ny + j, each quad (i, j) splits along the n00-n11 diagonal ("up"),
the n10-n01 diagonal ("down"), or by the parity of i + j ("zigzag"), and
both its triangles carry the quad's mask as their weight.  A face with a
traction mask carries the traction on its masked segments.
"""

from __future__ import annotations

import numpy as np

from .p1_plate import P1Plate

_FACE = {"right": lambda nx, ny: (nx - 1) * ny + np.arange(ny),
         "left": lambda nx, ny: np.arange(ny),
         "up": lambda nx, ny: np.arange(nx) * ny + ny - 1,
         "down": lambda nx, ny: np.arange(nx) * ny}


def triangles(nx: int, ny: int, split: str) -> np.ndarray:
    i, j = np.meshgrid(np.arange(nx - 1), np.arange(ny - 1), indexing="ij")
    i, j = i.ravel(), j.ravel()
    n00, n10 = i * ny + j, (i + 1) * ny + j
    n01, n11 = i * ny + j + 1, (i + 1) * ny + j + 1
    up = (np.stack([n00, n10, n11], 1), np.stack([n00, n11, n01], 1))
    down = (np.stack([n00, n10, n01], 1), np.stack([n10, n11, n01], 1))
    if split == "up":
        t1, t2 = up
    elif split == "down":
        t1, t2 = down
    else:
        even = ((i + j) % 2 == 0)[:, None]
        t1 = np.where(even, up[0], down[0])
        t2 = np.where(even, up[1], down[1])
    return np.stack([t1, t2], axis=1).reshape(-1, 3)


def grid_plate(grid: dict, E: float, nu: float, traction, prec=None,
               device="cpu") -> P1Plate:
    """The ``P1Plate`` of a grid's numpy arrays (``coords`` [nx, ny, 2],
    the node masks, ``quad_mask``, ``neumann_edge_masks``, ``split``)."""
    nx, ny = grid["coords"].shape[:2]
    edges = []
    for face, mask in grid["neumann_edge_masks"].items():
        line = _FACE[face](nx, ny)
        edges.append(np.stack([line[:-1], line[1:]], 1)[np.asarray(mask)
                                                        > 0])
    edges = np.concatenate(edges) if edges else np.zeros((0, 2), np.int64)
    return P1Plate(np.asarray(grid["coords"]).reshape(-1, 2),
                   triangles(nx, ny, grid["split"]),
                   np.asarray(grid["geom_boundary_mask"]).ravel(),
                   np.asarray(grid["dirichlet_mask"]).ravel(), edges, E, nu,
                   traction=traction,
                   weights=np.repeat(np.asarray(grid["quad_mask"]).ravel(),
                                     2), prec=prec, device=device)
