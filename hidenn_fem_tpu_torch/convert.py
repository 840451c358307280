"""Inputs of the JAX package, as numpy arrays, turned into the port's.

The port never imports JAX; these take anything ``np.asarray`` reads
(numpy arrays, or the JAX package's arrays), so one numpy mesh or grid and
one set of numpy params can feed both packages.  Their tensors go to the
card unless ``device`` names another device (``device.resolve_device``).
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .mesh.types import TriMesh
from .models.structured_grid import StructuredGrid

__all__ = ["params_from_numpy", "mesh_from_numpy", "grid_from_numpy"]


def params_from_numpy(params_np: dict, device=None,
                      dtype=torch.float32) -> dict:
    """Params as tensors on ``device``: ``TriangleP1``'s {"coords": [N, 2],
    "u": [N, 2]} or ``StructuredGridP1``'s {"coords": [nx, ny, 2],
    "u": [nx, ny, 2]} (any shapes are carried as they are)."""
    device = resolve_device(device)
    return {k: torch.tensor(np.asarray(v), dtype=dtype, device=device)
            for k, v in params_np.items()}


def mesh_from_numpy(mesh, device=None, dtype=torch.float32,
                    build_lattice=True, build_banded="auto") -> TriMesh:
    """``TriMesh.from_arrays`` on the six arrays of a mesh object (for
    example the JAX package's ``TriMesh``); ``build_banded`` as there."""
    return TriMesh.from_arrays(
        np.asarray(mesh.coords), np.asarray(mesh.connectivity),
        np.asarray(mesh.geom_boundary_mask), np.asarray(mesh.dirichlet_mask),
        np.asarray(mesh.neumann_mask), np.asarray(mesh.neumann_edges),
        dtype=dtype, device=device, build_lattice=build_lattice,
        build_banded=build_banded)


def grid_from_numpy(grid, device=None) -> StructuredGrid:
    """A ``StructuredGrid`` from the arrays and static fields of a grid
    object (for example the JAX package's ``StructuredGrid``)."""
    device = resolve_device(device)

    def t(a):
        return torch.tensor(np.asarray(a), device=device)

    return StructuredGrid(
        coords=t(grid.coords).to(torch.float32),
        geom_boundary_mask=t(grid.geom_boundary_mask),
        dirichlet_mask=t(grid.dirichlet_mask),
        quad_mask=t(grid.quad_mask).to(torch.float32),
        neumann_edge_masks={f: t(m) for f, m in
                            grid.neumann_edge_masks.items()},
        u_dirichlet=(None if grid.u_dirichlet is None
                     else t(grid.u_dirichlet)),
        split=grid.split, zigzag_phase=int(grid.zigzag_phase))
