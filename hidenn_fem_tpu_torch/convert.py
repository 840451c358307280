"""Inputs of the JAX package, as numpy arrays, turned into the port's.

The port never imports JAX; these take anything ``np.asarray`` reads
(numpy arrays, or the JAX package's arrays), so one numpy mesh or grid and
one set of numpy params can feed both packages.  Their tensors go to the
card unless ``device`` names another device (``device.resolve_device``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .device import resolve_device
from .mesh.banded import _TABLES, BandedAssembly
from .mesh.types import TriMesh
from .models.structured_grid import StructuredGrid

__all__ = ["params_from_numpy", "mesh_from_numpy", "grid_from_numpy",
           "banded_from_numpy"]


def params_from_numpy(params_np: dict, device=None,
                      dtype=torch.float32) -> dict:
    """Params as tensors on ``device``: ``TriangleP1``'s {"coords": [N, 2],
    "u": [N, 2]} or ``StructuredGridP1``'s {"coords": [nx, ny, 2],
    "u": [nx, ny, 2]} (any shapes are carried as they are)."""
    device = resolve_device(device)
    return {k: torch.tensor(np.asarray(v), dtype=dtype, device=device)
            for k, v in params_np.items()}


def banded_from_numpy(ba, device=None) -> BandedAssembly:
    """A ``BandedAssembly`` from the tables and window sizes of a banded
    table object (for example the JAX package's, built with any
    ``block_multiple``), its arrays taken as they are."""
    device = resolve_device(device)
    tables = {name: (None if getattr(ba, name) is None else torch.tensor(
        np.asarray(getattr(ba, name), dtype=np.int32), device=device))
        for name in _TABLES}
    return BandedAssembly(**tables, wnode=int(ba.wnode), wct=int(ba.wct),
                          re_wnode=int(ba.re_wnode), re_ew=int(ba.re_ew),
                          k=int(ba.k))


def mesh_from_numpy(mesh, device=None, dtype=torch.float32,
                    build_lattice=True, build_banded="auto",
                    build_incidence=True) -> TriMesh:
    """``TriMesh.from_arrays`` on the six arrays of a mesh object (for
    example the JAX package's ``TriMesh``, padded by ``pad_mesh`` or not);
    ``build_banded`` and ``build_incidence`` as there.  Under
    ``build_banded="auto"``, banded tables the mesh carries (``banded``,
    ``banded_paired``; for example rebuilt by the JAX package's
    ``reband_for_shards``) are carried across as they are, in place of
    tables built anew."""
    carried = {name: getattr(mesh, name, None)
               for name in ("banded", "banded_paired")}
    have = build_banded == "auto" and any(
        t is not None for t in carried.values())
    tri = TriMesh.from_arrays(
        np.asarray(mesh.coords), np.asarray(mesh.connectivity),
        np.asarray(mesh.geom_boundary_mask), np.asarray(mesh.dirichlet_mask),
        np.asarray(mesh.neumann_mask), np.asarray(mesh.neumann_edges),
        dtype=dtype, device=device, build_lattice=build_lattice,
        build_banded=False if have else build_banded,
        build_incidence=build_incidence)
    if not have:
        return tri
    return dataclasses.replace(tri, **{
        name: None if t is None else banded_from_numpy(t, device=tri.device)
        for name, t in carried.items()})


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
