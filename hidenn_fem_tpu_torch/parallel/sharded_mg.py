"""Multigrid-PCG row-sharded over a ``torch.distributed`` group (port of
``hidenn_fem_tpu/parallel/sharded_mg.py``).

The multigrid lattices are 2^k + 1 node rows, which never divide a rank
count, so each sharded level is padded with DEAD rows (``pad_lattice``:
quads deactivated, nodes pinned) up to a multiple of the rank count D,
and its D equal row blocks are the ranks' windows, as the JAX package's
``NamedSharding`` splits the padded rows.  Two engines:

* ``engine="all"`` (default): every level with at least
  ``min_rows_per_dev`` rows a rank is padded and sharded; smaller levels
  are replicated;
* ``engine="replicated_coarse"``: only the fine level is sharded.

The sharded level operator.  Every rank holds the whole level vector, as
in ``parallel/sharded_slab.py``.  A rank runs K6 over its window of the
padded level's node rows (``lattice_stencil_vg_rows``; its plain version
on the CPU), whose gradient rows for the window's nodes are complete from
the one-row halo and bit-equal to the whole-level K6's; the displacement
columns of the placed rows (zero outside the window) are then summed over
the ranks by one ``all_reduce``, so every rank holds the whole result,
bit-equal across ranks: each entry has exactly one non-zero addend.  The
combine is an ``all_reduce`` of the [N, 2] placed rows rather than an
``all_gather`` of the [N/D, 2] owned blocks, which would move about half
the bytes, because gloo runs only ``all_reduce`` and ``broadcast`` on CUDA
tensors, and the groups that share one card are gloo groups.

The JAX package runs the levels under GSPMD, which turns the stencil's
slices into halo permutes, and compiles the PCG loop.  Here the PCG
vectors are replicated and the iteration is the single-device solvers'
masked body (``solve/linear.py``) around ``solve/multigrid.py``'s
V-cycle with the pad counts: one NCCL rank or several record it in a
CUDA graph and replay it, gloo ranks (the groups that share one card)
run it eagerly (``solve/loop.py``).  Every rank reads the same stop flag,
computed from bit-equal all-reduced scalars, after the same number of
iterations (``loop.READ_EVERY``), so no rank leaves the loop while
another waits in a collective, as in ``parallel/sharded_aux.py``.  A
solve issues one ``all_reduce`` for each level operator on a sharded
level and no other collective.

Set-up (each level's probed diagonal and ``lmax``, ``solve/multigrid.py``'s
``_setup_level``) runs whole on every rank with no collective: it is a
one-off, and it lets the hierarchy be built, and compared with the JAX
package's, in one process for any D.

Zero padding and row slicing are adjoint, so the transfer pair
``pad0 . prolong . unpad`` / ``pad0 . restrict . unpad`` keeps the V-cycle
a symmetric positive definite preconditioner, and dead rows stay exactly
zero through every smoother (their probed diagonal is zero).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from ..models.structured_grid import (StructuredGrid, pad_lattice,
                                      pad_lattice_side)
from ..ops.lattice_slab import (lattice_stencil_vg_rows,
                                lattice_stencil_vg_rows_plain,
                                structured_stencil)
from ..solve import multigrid as mg
from ..solve.linear import _pcg
from .sharded_slab import row_window
from .sharding import DeviceMesh, all_reduce, device_mesh

__all__ = ["mg_pcg_solve_sharded", "mg_pcg_solve_all_sharded",
           "build_sharded_hierarchy", "count_collectives"]

_NU, _COARSE_DEGREE, _POWER_ITERS = 3, 24, 30


def _pad(grid: StructuredGrid, coords, u, n: int):
    """(padded grid, padded coords, padded u, signed pad count)."""
    gP, pP = pad_lattice(grid, {"coords": coords, "u": u}, n)
    k = gP.nx - grid.nx
    if pad_lattice_side(grid) == "append":
        k = -k
    return gP, pP["coords"].contiguous(), pP["u"].contiguous(), k


def _plan(grid: StructuredGrid, D: int, min_rows_per_dev: int,
          min_size: int = 4, max_levels: int = 16) -> List[bool]:
    """Whether each level of the all-levels hierarchy is sharded (the JAX
    package's rule: at least ``min_rows_per_dev`` rows a rank)."""
    flags, g = [], grid
    while True:
        flags.append(g.nx >= D * min_rows_per_dev)
        gc = mg.coarsen_grid(g)
        if (gc is None or gc.nx < min_size or gc.ny < min_size
                or len(flags) >= max_levels):
            return flags
        g = gc


def build_sharded_hierarchy(model, grid: StructuredGrid,
                            coords: torch.Tensor, dmesh: DeviceMesh,
                            axis: str = "row",
                            min_rows_per_dev: int = 4,
                            min_size: int = 4, max_levels: int = 16,
                            power_iters: int = 30):
    """Row-sharded MG hierarchy: per-level dead-row padding to the rank
    count, every level with >= ``min_rows_per_dev`` rows a rank sharded,
    smaller levels replicated.  Each level is set up whole on this rank
    (no collective).  Returns (levels tuple, signed pad counts tuple)."""
    D = dmesh.size
    levels, ks = [], []
    g, c = grid, coords.detach()
    for sharded in _plan(grid, D, min_rows_per_dev, min_size, max_levels):
        if sharded:
            gP, cP, _, k = _pad(g, c, torch.zeros_like(c), D)
        else:
            gP, cP, k = g, c, 0
        levels.append(mg._setup_level(model, gP, cP, int(power_iters)))
        ks.append(k)
        g = mg.coarsen_grid(g)
        c = c[::2, ::2].contiguous()
    return tuple(levels), tuple(ks)


def _rows_level_grad(model, grid: StructuredGrid, coords: torch.Tensor,
                     dmesh: DeviceMesh):
    """u -> d domain_energy / d u on a sharded level (module doc): K6
    over this rank's row window, the placed displacement columns summed
    over the ranks, the pinned rows zero."""
    nx, ny = grid.nx, grid.ny
    lo, hi = row_window(nx, dmesh.rank, dmesh.size)
    with torch.no_grad():
        cpin = model.coords({"coords": coords}, grid)
    kw = structured_stencil(grid.quad_mask, grid.split, grid.zigzag_phase,
                            cpin.dtype)
    pinned = grid.dirichlet_mask[..., None]

    def g(u):
        with torch.no_grad():
            node = torch.cat([cpin, model.u_full({"u": u}, grid)],
                             dim=-1).reshape(nx * ny, 4)
            vg = (lattice_stencil_vg_rows if model._use_kernel(node)
                  else lattice_stencil_vg_rows_plain)
            _, gn = vg(node, nx, ny, model.E, model.nu, 0.5, lo, hi, **kw)
            gu = all_reduce(gn[:, 2:].contiguous(), dmesh)
            return torch.where(pinned, 0.0,
                               gu.reshape(nx, ny, 2)).to(u.dtype)
    return g


def _level_ops(model, levels, flags, dmesh: DeviceMesh):
    """Each level's operator v -> K v, its affine part computed once:
    sharded levels on ``_rows_level_grad``, the others on the
    single-device level gradient."""
    out = []
    for lev, sharded in zip(levels, flags):
        g = (_rows_level_grad(model, lev.grid, lev.coords, dmesh) if sharded
             else mg._level_grad(model, lev.grid, lev.coords))
        g0 = g(torch.zeros_like(lev.coords))
        out.append(lambda v, g=g, g0=g0: g(v) - g0)
    return out


def _solve(model, levels, ks, flags, gridP, coordsP, uP, dmesh,
           max_iters: int, tol: float, nu: int, coarse_degree: int):
    """MG-PCG on the padded fine lattice (the JAX package's loop, the
    body of ``solve/linear.py``): returns (padded solution, relres
    history [max_iters])."""
    # the right-hand side, once a solve: the total energy's gradient at
    # the start, computed whole on every rank (no collective)
    u = uP.detach().clone().requires_grad_(True)
    with torch.enable_grad():
        (g0,) = torch.autograd.grad(
            model({"coords": coordsP, "u": u}, gridP), u)
    ops = _level_ops(model, levels, flags, dmesh)
    x, hist = _pcg(lambda v: {"u": ops[0](v["u"])},
                   lambda r: {"u": mg._vcycle(ops, levels, r["u"], nu,
                                              coarse_degree, ks)},
                   mg._udot, {"u": -g0}, max_iters, tol)
    return uP.detach() + x["u"], hist


def mg_pcg_solve_all_sharded(model, grid: StructuredGrid, params,
                             dmesh: Optional[DeviceMesh] = None,
                             n_devices: Optional[int] = None,
                             max_iters: int = 60, tol: float = 1e-6,
                             nu: int = 3, coarse_degree: int = 24,
                             min_rows_per_dev: int = 4,
                             axis: str = "row"
                             ) -> Tuple[dict, torch.Tensor]:
    """Multigrid-PCG with every sufficiently large level row-sharded
    (module doc).  Same semantics and returns as
    ``mg_pcg_solve_sharded``."""
    if dmesh is None:
        dmesh = device_mesh(n_devices, axis=axis)
    with torch.no_grad():
        coords = model.coords(params, grid)
    levels, ks = build_sharded_hierarchy(
        model, grid, coords, dmesh, axis=axis,
        min_rows_per_dev=min_rows_per_dev)
    flags = [lev.grid.nx >= dmesh.size * min_rows_per_dev for lev in levels]
    # the fine PCG state matches level 0: padded when it is sharded
    if flags[0]:
        gridP, coordsP, uP, _ = _pad(grid, coords, params["u"], dmesh.size)
    else:
        gridP, coordsP, uP = grid, coords, params["u"]
    u, hist = _solve(model, levels, ks, flags, gridP, coordsP, uP, dmesh,
                     int(max_iters), float(tol), int(nu),
                     int(coarse_degree))
    return {"coords": params["coords"], "u": mg._unpad_rows(u, ks[0])}, hist


def _replicated_coarse(model, grid: StructuredGrid, coords, u,
                       dmesh: DeviceMesh):
    """The replicated-coarse engine's hierarchy: the fine level padded and
    sharded, the coarse levels the single-device hierarchy of the unpadded
    grid.  Returns (levels, ks, flags, padded grid, coords, u)."""
    gridP, coordsP, uP, k = _pad(grid, coords, u, dmesh.size)
    gc = mg.coarsen_grid(grid)
    if gc is None:
        raise ValueError("lattice too small to coarsen: use the "
                         "single-device mg_pcg_solve")
    lev0 = mg._setup_level(model, gridP, coordsP, _POWER_ITERS)
    rest = mg.build_hierarchy(model, gc, coords[::2, ::2].contiguous())
    return ((lev0,) + rest, (k,) + (0,) * len(rest),
            [True] + [False] * len(rest), gridP, coordsP, uP)


def count_collectives(model, grid: StructuredGrid, params,
                      n_devices: int = 8, engine: str = "all",
                      max_iters: int = 4) -> dict:
    """The collectives one rank issues in a sharded MG solve whose loop
    calls its body ``max_iters`` times (the iterations run, and the
    masked calls past the stop: ``solve/loop.py``; nu 3, coarse degree
    24), by kind, derived from the hierarchy without running it: one
    ``all_reduce`` for each level operator on a sharded level, that is
    for each level's affine part, each fine matvec (one a call) and the
    V-cycles (one before the loop and one a call; 2 nu + 1 level operators on
    every level but the coarsest, ``coarse_degree`` there).  The set-up,
    the right-hand side and the stop reads issue none.  The JAX package
    counts the collective HLOs of its compiled program instead, where
    GSPMD turns the stencil's slices into halo permutes."""
    if engine == "all":
        flags = _plan(grid, n_devices, 4)
    elif engine == "replicated_coarse":
        gc = mg.coarsen_grid(grid)
        if gc is None:
            raise ValueError("lattice too small to coarsen: use the "
                             "single-device mg_pcg_solve")
        flags = [True] + [False] * len(_plan(gc, 1, 4))
    else:
        raise ValueError(f"unknown engine {engine!r}")
    per_level = [2 * _NU + 1] * (len(flags) - 1) + [_COARSE_DEGREE]
    vcycle = sum(n for n, s in zip(per_level, flags) if s)
    reduces = (sum(flags) + (max_iters + 1) * vcycle
               + max_iters * int(flags[0]))
    return {"all_reduce": reduces, "broadcast": 0}


def mg_pcg_solve_sharded(model, grid: StructuredGrid, params,
                         dmesh: Optional[DeviceMesh] = None,
                         n_devices: Optional[int] = None,
                         max_iters: int = 60, tol: float = 1e-6,
                         nu: int = 3, coarse_degree: int = 24,
                         axis: str = "row", engine: str = "all",
                         min_rows_per_dev: int = 4
                         ) -> Tuple[dict, torch.Tensor]:
    """Multigrid-PCG displacement solve row-sharded over the ranks of
    ``dmesh`` (default: ``device_mesh(n_devices)``, the initialized
    group on the card); run it on every rank of the group, on the same
    grid and params.  Same semantics and returns as
    ``solve.multigrid.mg_pcg_solve``; the returned solution is unpadded,
    alike on every rank, and follows the single-process solve.

    ``engine="all"`` (default) shards every sufficiently large level
    (``mg_pcg_solve_all_sharded``); ``engine="replicated_coarse"``
    shards the fine level only.  ``count_collectives`` gives each
    engine's collectives.
    """
    if engine == "all":
        return mg_pcg_solve_all_sharded(
            model, grid, params, dmesh=dmesh, n_devices=n_devices,
            max_iters=max_iters, tol=tol, nu=nu,
            coarse_degree=coarse_degree, axis=axis,
            min_rows_per_dev=min_rows_per_dev)
    if engine != "replicated_coarse":
        raise ValueError(f"unknown engine {engine!r}")
    if dmesh is None:
        dmesh = device_mesh(n_devices, axis=axis)
    with torch.no_grad():
        coords = model.coords(params, grid)
    levels, ks, flags, gridP, coordsP, uP = _replicated_coarse(
        model, grid, coords, params["u"], dmesh)
    u, hist = _solve(model, levels, ks, flags, gridP, coordsP, uP, dmesh,
                     int(max_iters), float(tol), int(nu),
                     int(coarse_degree))
    return {"coords": params["coords"], "u": mg._unpad_rows(u, ks[0])}, hist
