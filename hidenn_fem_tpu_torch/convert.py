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
from .mesh.hybrid import hybrid_mesh_from_arrays
from .mesh.types import TriMesh
from .models.structured_grid import StructuredGrid

__all__ = ["params_from_numpy", "mesh_from_numpy", "grid_from_numpy",
           "banded_from_numpy", "levels_from_numpy", "aux_from_numpy"]

_FLOATS = {np.dtype(np.float32): torch.float32,
           np.dtype(np.float64): torch.float64}


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
    tables built anew.  A mesh with a hybrid lattice + collar route
    (``hybrid``, the JAX package's ``generate_mesh_hybrid``) keeps it:
    the mesh is rebuilt by ``hybrid_mesh_from_arrays`` on the lattice
    shape and diagonals of its route, and the build options do not apply
    (the route owns the fast path, as in the generator)."""
    hy = getattr(mesh, "hybrid", None)
    if hy is not None:
        route = hy.lattice
        return hybrid_mesh_from_arrays(
            *[np.asarray(a) for a in (
                mesh.coords, mesh.connectivity, mesh.geom_boundary_mask,
                mesh.dirichlet_mask, mesh.neumann_mask,
                mesh.neumann_edges)],
            nx=route.nx, ny=route.ny,
            variant=route.uniform_sel or "zigzag", dtype=dtype,
            device=device)
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
    """A multigrid hierarchy (a ``solve.multigrid.Hierarchy``, as
    ``build_hierarchy`` returns) from the levels of another one, for
    example the JAX package's: each level's grid, coords, inverse
    diagonal ``dinv``, Chebyshev bound ``lmax`` and ``free`` mask, taken
    as they are.  ``grid``, when given, is the port's fine grid and stands
    for level 0's; every other grid is carried by ``grid_from_numpy``.
    Both packages' V-cycles can then run on the same levels."""
    from .solve.multigrid import Hierarchy, _Level

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
    return Hierarchy(out)


def aux_from_numpy(pre, device=None):
    """An auxiliary-space preconditioner (``solve.auxspace
    .build_aux_preconditioner``'s product) from the fields of another one,
    for example the JAX package's: its levels (``levels_from_numpy``, in
    their own precision), background grid (``grid_from_numpy``), inverse
    diagonal, transfer, window, permutation and rim tables (float arrays
    in their own dtype, index tables as int64) and static fields, taken
    as they are; its background model as the port's ``StructuredGridP1``
    of the same E, nu and dtype.  Both packages' ``_apply_aux`` can then
    run on the same tables."""
    from .models.structured_grid import StructuredGridP1
    from .solve.auxspace import _AuxPrecond

    device = resolve_device(device)

    def t(a):
        if a is None:
            return None
        a = np.asarray(a)
        if a.dtype.kind in "iu":
            return torch.tensor(a.astype(np.int64), device=device)
        return torch.tensor(a, device=device)

    grid = grid_from_numpy(pre.grid, device=device,
                           dtype=_FLOATS[np.asarray(pre.grid.coords).dtype])
    levels = levels_from_numpy(
        pre.levels, grid=grid, device=device,
        dtype=_FLOATS[np.asarray(pre.levels[0].dinv).dtype])
    bg = None
    if pre.bg_model is not None:
        m = pre.bg_model
        bg = StructuredGridP1(E=m.E, nu=m.nu, F_total=m.F_total,
                              traction_length=m.traction_length,
                              u_fixed=m.u_fixed, init_scale=m.init_scale,
                              dtype=_FLOATS[np.dtype(m.dtype)],
                              tractions=m.tractions)
    arrays = {f.name: t(getattr(pre, f.name))
              for f in dataclasses.fields(_AuxPrecond)
              if f.init and f.name not in ("levels", "grid", "bg_model", "ptw_width",
                                "omega", "lat_kind", "lat_nx", "lat_ny")}
    return _AuxPrecond(levels=levels, grid=grid, bg_model=bg,
                       ptw_width=int(pre.ptw_width), omega=float(pre.omega),
                       lat_kind=str(pre.lat_kind), lat_nx=int(pre.lat_nx),
                       lat_ny=int(pre.lat_ny), **arrays)
