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
           "banded_from_numpy", "levels_from_numpy"]


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


def grid_from_numpy(grid, device=None, dtype=torch.float32
                    ) -> StructuredGrid:
    """A ``StructuredGrid`` from the arrays and static fields of a grid
    object (for example the JAX package's ``StructuredGrid``, a coarse
    multigrid level's with its fractional quad mask included); coords and
    quad mask in ``dtype``."""
    device = resolve_device(device)

    def t(a):
        return torch.tensor(np.asarray(a), device=device)

    return StructuredGrid(
        coords=t(grid.coords).to(dtype),
        geom_boundary_mask=t(grid.geom_boundary_mask),
        dirichlet_mask=t(grid.dirichlet_mask),
        quad_mask=t(grid.quad_mask).to(dtype),
        neumann_edge_masks={f: t(m) for f, m in
                            grid.neumann_edge_masks.items()},
        u_dirichlet=(None if grid.u_dirichlet is None
                     else t(grid.u_dirichlet)),
        split=grid.split, zigzag_phase=int(grid.zigzag_phase))


def levels_from_numpy(levels, grid=None, device=None, dtype=torch.float32):
    """A multigrid hierarchy (``solve.multigrid.build_hierarchy``'s tuple)
    from the levels of another one, for example the JAX package's: each
    level's grid, coords, inverse diagonal ``dinv``, Chebyshev bound
    ``lmax`` and ``free`` mask, taken as they are.  ``grid``, when given,
    is the port's fine grid and stands for level 0's; every other grid is
    carried by ``grid_from_numpy``.  Both packages' V-cycles can then run
    on the same levels."""
    from .solve.multigrid import _Level

    device = resolve_device(device)

    def t(a):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    out = []
    for i, lev in enumerate(levels):
        g = grid if (i == 0 and grid is not None) else grid_from_numpy(
            lev.grid, device=device, dtype=dtype)
        lmax = t(lev.lmax)
        out.append(_Level(grid=g, coords=t(lev.coords), dinv=t(lev.dinv),
                          lmax=lmax, free=t(lev.free),
                          lmax_host=float(lmax)))
    return tuple(out)
