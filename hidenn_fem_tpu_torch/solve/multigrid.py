"""Geometric multigrid-preconditioned CG for the structured-grid plate
(port of ``hidenn_fem_tpu/solve/multigrid.py``).

At fixed node coordinates the ``StructuredGridP1`` energy is quadratic in
``u``, so its minimum solves the FEM system K u = f.  Plain CG needs
O(nx) iterations for it; a V-cycle preconditioner makes the count
independent of the resolution.  Everything is matrix-free against the
production energy:

* level operators are two-point gradient differences
  ``K_l v = grad(E_l)(v) - grad(E_l)(0)`` of the domain energy on the
  coarsened grids (exact for the quadratic energy, reverse mode only):
  the stencil kernel K6's value-and-grad (``lattice_stencil_vg``, the
  one ``torch.autograd.grad`` of ``domain_energy`` would run; its ``u``
  columns, zero on the Dirichlet rows) or its plain version.  On a CUDA
  float32 lattice with no prescribed displacement the cycle is fused
  instead (``ops/lattice_slab.lattice_level_cycle``): each Chebyshev
  step of a level one launch of a level epilogue of K6, the restriction
  one launch, the bottom levels one launch of one CTA, bit for bit the
  composition below where the stencil sums keep K6's order;
* level diagonals come exactly from 8 colored probes: the lattice node
  adjacency (8-neighbourhood for every split) is properly 4-colored by
  ``(i % 2, j % 2)``, times 2 displacement components;
* smoothing is fixed-degree Chebyshev-Jacobi over ``[lmax/4, lmax]`` of
  the ``D^{-1}K`` spectrum (lmax from a power iteration at set-up).  A
  fixed polynomial is a linear, symmetric operator, so the V(nu,nu)
  cycle is an SPD preconditioner and plain PCG applies.

Coarse levels keep the quad mask by volume fraction (the mean of the 4
fine quads), so the stencil weights there are fractional.  Dirichlet
DOFs and hole interiors probe a zero diagonal, which the guarded
``1/diag`` freezes; prolongation is masked to the free DOFs.

The JAX package builds the hierarchy and runs the PCG loop as compiled
programs.  Here the hierarchy is a Python loop and the PCG iteration is
``solve/linear.py``'s masked body (``_pcg``), which ``solve/loop.py``
records once in a CUDA graph on the card and replays, reading the stop
flag on the host once every ``loop.READ_EVERY`` iterations.  Everything
the graph reads is built before the first iteration: each level's
operator (its pinned coordinates, stencil weights and gradient at zero:
``_level_ops``) and each level's Chebyshev coefficients, computed once on
the host from ``lmax_host`` in the level's dtype and baked into the
graph.  None of it depends on the load: the traction enters only the
right-hand side.  So a solve on a hierarchy from ``build_hierarchy``
keeps its plan (a kept ``linear.PCGLoop`` on the level operators, whose
start and iteration are each recorded once) on that hierarchy, and the
next solve on it with the same key replays both graphs after one copy of
its right-hand side (``plan_counts`` counts the plans built and
reused).  A solve with no prebuilt hierarchy, as
``radapt_mg_solve``'s on every epoch, builds a plan and drops it.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..models.structured_grid import StructuredGrid
from ..ops.lattice_slab import (MATVEC, LatticeLevel, lattice_level_cycle,
                                lattice_level_step, lattice_stencil_vg,
                                lattice_stencil_vg_plain, prolong,
                                restrict_plain as _restrict,
                                structured_stencil)
from ..utils.profiling import annotate
from . import loop as _loop
from .linear import PCGLoop, _pcg, hold_plan, take_plan

__all__ = ["coarsen_grid", "prolong", "build_hierarchy", "vcycle",
           "mg_pcg_solve", "radapt_mg_solve"]

_TINY = 1e-30

# MG-PCG plans built (every solve on a new hierarchy or a new key) and
# reused (a solve on a hierarchy that held a plan of its key)
plan_counts = {"built": 0, "reused": 0}


# --------------------------------------------------------------- hierarchy
def coarsen_grid(grid: StructuredGrid) -> Optional[StructuredGrid]:
    """One geometric coarsening step (``None`` if the quad lattice is not
    2-divisible).  Coords and the node masks are sampled (a coarse node
    is pinned iff its fine image is); the quad mask is coarsened by
    volume fraction (the mean of the 4 fine quads), so hole rims get
    fractionally stiff coarse quads.  Neumann data is dropped: the
    traction shifts the right-hand side, not K."""
    nx, ny = grid.nx, grid.ny
    if nx < 3 or ny < 3 or (nx - 1) % 2 or (ny - 1) % 2:
        return None
    nxc, nyc = (nx - 1) // 2 + 1, (ny - 1) // 2 + 1
    qm = grid.quad_mask.reshape(nxc - 1, 2, nyc - 1, 2)
    return StructuredGrid(
        coords=grid.coords[::2, ::2].contiguous(),
        geom_boundary_mask=grid.geom_boundary_mask[::2, ::2].contiguous(),
        dirichlet_mask=grid.dirichlet_mask[::2, ::2].contiguous(),
        quad_mask=qm.mean(dim=(1, 3)),
        neumann_edge_masks={},
        u_dirichlet=None,
        split=grid.split,
        zigzag_phase=grid.zigzag_phase % 2,
    )


@dataclasses.dataclass(frozen=True)
class _Level:
    """One multigrid level: its grid, sampled coords, guarded inverse
    diagonal, the Chebyshev upper eigenvalue bound of D^{-1}K (a 0-dim
    tensor, and ``lmax_host``, the same value on the host), and ``free``,
    [nx, ny, 2] 1/0 over the DOFs in the operator's support (Dirichlet
    nodes and hole interiors probe a zero diagonal)."""

    grid: StructuredGrid
    coords: torch.Tensor
    dinv: torch.Tensor
    lmax: torch.Tensor
    free: torch.Tensor
    lmax_host: float


class Hierarchy(tuple):
    """``build_hierarchy``'s levels, finest first: a tuple of ``_Level``s
    that also holds the plan of the last ``mg_pcg_solve`` on it
    (``plan``, None before one), which dies with it.  Nothing of the plan
    refers back to the hierarchy; a copy or a pickle leaves it out."""

    plan = None

    def __reduce__(self):
        return Hierarchy, (tuple(self),)


def _level_grad(model, grid: StructuredGrid, coords: torch.Tensor):
    """u -> d domain_energy / d u on ``grid`` at the (pinned) ``coords``:
    one value-and-grad of the stencil, K6 on a CUDA float32 lattice (as
    ``model.domain_energy`` would run it), its plain version otherwise."""
    nx, ny = grid.nx, grid.ny
    with torch.no_grad():
        cpin = model.coords({"coords": coords}, grid)
    kw = structured_stencil(grid.quad_mask, grid.split, grid.zigzag_phase,
                            cpin.dtype)
    pinned = grid.dirichlet_mask[..., None]

    def g(u):
        with torch.no_grad():
            node = torch.cat([cpin, model.u_full({"u": u}, grid)],
                             dim=-1).reshape(nx * ny, 4)
            vg = (lattice_stencil_vg if model._use_kernel(node)
                  else lattice_stencil_vg_plain)
            _, gn = vg(node, nx, ny, model.E, model.nu, 0.5, **kw)
            # in u's dtype, as jax.grad returns it (a float64 model on
            # float32 coords computes in float64)
            return torch.where(pinned, 0.0,
                               gn.reshape(nx, ny, 4)[..., 2:]).to(u.dtype)
    return g


def level_g0s(model, levels) -> tuple:
    """Per-level gradients at zero, the affine part of each level
    operator: compute them once outside an iteration loop."""
    return tuple(_level_grad(model, lev.grid, lev.coords)(
        torch.zeros_like(lev.coords)) for lev in levels)


def _stencil_level(model, grid: StructuredGrid, coords: torch.Tensor):
    """The level as the level-step kernels take it (``LatticeLevel``), or
    None off their route.  They take the level where its gradient would
    run K6 (a float32 lattice on the card, ``model._use_kernel``) and
    grad E(0) is 0, so that K v is the stencil gradient at v alone: no
    prescribed displacement on the pinned rows."""
    if not coords.is_cuda or grid.u_dirichlet is not None \
            or float(model.u_fixed) != 0.0:
        return None
    with torch.no_grad():
        cpin = model.coords({"coords": coords}, grid)
    if cpin.dtype != torch.float32 or not model._use_kernel(cpin):
        return None
    return LatticeLevel(coords=cpin.contiguous(),
                        pinned=grid.dirichlet_mask.contiguous(),
                        E=float(model.E), nu=float(model.nu),
                        stencil=structured_stencil(
                            grid.quad_mask, grid.split, grid.zigzag_phase,
                            cpin.dtype))


class _LevelOp:
    """The stiffness action v -> K v on a level's ``grid`` at its
    ``coords``: the two-point gradient difference g(v) - g(0) of the
    quadratic domain energy (``g0`` its affine part g(0), unless given).
    Where the level takes the level-step kernels' route, ``stencil`` is
    its ``LatticeLevel`` (else None): a float32 v on the card then takes
    one launch of K v, ``_vcycle`` runs the fused cycle on it
    (``smoother``), and the gradient difference is built only for another
    v (a float64 one)."""

    def __init__(self, model, grid: StructuredGrid, coords: torch.Tensor,
                 g0=None):
        self.stencil = _stencil_level(model, grid, coords)
        self.g, self.g0 = None, g0
        self._level = (model, grid, coords)
        self._smoothers = {}
        if self.stencil is None:
            self._difference()

    def _difference(self):
        """g and g0, the first time the gradient difference is needed."""
        if self.g is None:
            self.g = _level_grad(*self._level)
        if self.g0 is None:
            self.g0 = self.g(torch.zeros_like(self._level[2]))

    def __call__(self, v):
        if self.stencil is not None and v.dtype == torch.float32:
            return lattice_level_step(MATVEC, self.stencil, v.contiguous())
        self._difference()
        return self.g(v) - self.g0

    def smoother(self, lev: _Level, degree: int) -> LatticeLevel:
        """``stencil`` with the Chebyshev-Jacobi smoother of ``degree``
        on ``lev`` (the level this operator was built for; float32), built
        the first time a cycle asks for it."""
        out = self._smoothers.get(degree)
        if out is None:
            theta, coeffs = _cheb_coeffs(lev.lmax_host, int(degree), False)
            out = self._smoothers[degree] = dataclasses.replace(
                self.stencil, dinv=lev.dinv.contiguous(),
                free=lev.free.contiguous(), theta=theta, coeffs=coeffs)
        return out


def _level_ops(model, levels, g0s=None) -> list:
    """Every level's operator (``_LevelOp``), built once a solve: the
    pinned coordinates, the stencil weights and (off the level-step route,
    unless ``g0s`` gives them) the affine parts are computed here, not on
    every V-cycle."""
    if g0s is None:
        g0s = (None,) * len(levels)
    return [_LevelOp(model, lev.grid, lev.coords, g0)
            for lev, g0 in zip(levels, g0s)]


def _setup_level(model, grid: StructuredGrid, coords: torch.Tensor,
                 power_iters: int) -> _Level:
    op = _LevelOp(model, grid, coords)
    nx, ny = grid.nx, grid.ny
    dev, dtype = coords.device, coords.dtype
    # exact diagonal by colored probing: (i%2, j%2, comp) is a proper
    # coloring of the stiffness sparsity graph
    ii = torch.arange(nx, device=dev)[:, None, None] % 2
    jj = torch.arange(ny, device=dev)[None, :, None] % 2
    kk = torch.arange(2, device=dev)[None, None, :]
    diag = torch.zeros((nx, ny, 2), dtype=dtype, device=dev)
    for color in range(8):
        ci, cj, ck = color >> 2, (color >> 1) & 1, color & 1
        z = ((ii == ci) & (jj == cj) & (kk == ck)).to(dtype)
        diag = diag + z * op(z)
    live = diag > _TINY
    dinv = torch.where(live, 1.0 / torch.clamp_min(diag, _TINY), 0.0)

    # lmax(D^{-1} K) by power iteration from JAX's deterministic start.
    # The 30% headroom is not tuning: Chebyshev smoothing with an
    # underestimated lmax amplifies the top of the spectrum (the JAX
    # package measured a stall, then NaN, at 481x241).
    v = torch.sin(torch.arange(nx * ny * 2, dtype=dtype, device=dev)
                  ).reshape(nx, ny, 2) * live.to(dtype)
    v = v / torch.clamp_min(torch.sqrt(torch.sum(v * v)), _TINY)
    nrm = None
    for _ in range(power_iters):
        w = dinv * op(v)
        nrm = torch.sqrt(torch.sum(w * w))
        v = w / torch.clamp_min(nrm, _TINY)
    lmax = 1.3 * nrm
    # the preconditioner must never write outside the operator's range
    free = live.to(dtype)
    return _Level(grid=grid, coords=coords, dinv=dinv, lmax=lmax,
                  free=free, lmax_host=float(lmax))


def build_hierarchy(model, grid: StructuredGrid, coords: torch.Tensor,
                    min_size: int = 4, max_levels: int = 16,
                    power_iters: int = 30) -> Hierarchy:
    """Coarsen ``grid`` (with the given, possibly r-adapted, pinned node
    coordinates) while the quad lattice divides by 2 and stays at least
    ``min_size`` nodes per axis; set up diagonals and Chebyshev bounds
    per level (``8 + power_iters + 1`` level gradients each)."""
    coords = coords.detach()
    levels: List[_Level] = [_setup_level(model, grid, coords,
                                         int(power_iters))]
    g = grid
    while len(levels) < max_levels:
        gc = coarsen_grid(g)
        if gc is None or gc.nx < min_size or gc.ny < min_size:
            break
        coords = coords[::2, ::2].contiguous()
        levels.append(_setup_level(model, gc, coords, int(power_iters)))
        g = gc
    return Hierarchy(levels)


# --------------------------------------------------------------- smoothing
@functools.lru_cache(maxsize=256)
def _cheb_coeffs(lmax: float, degree: int, f64: bool):
    """(theta, [(c1, c2)] * (degree - 1)) of the Chebyshev recursion
    d <- c1 d + c2 D^{-1} r, in the level's precision (numpy scalars of
    its dtype, so the values are the JAX package's float32 scalars)."""
    f = np.float64 if f64 else np.float32
    lmax = f(lmax)
    lmin = lmax * f(0.25)
    theta = f(0.5) * (lmax + lmin)
    delta = f(0.5) * (lmax - lmin)
    sigma = theta / delta
    rho = f(1.0) / sigma
    coeffs = []
    for _ in range(degree - 1):
        rho_new = f(1.0) / (f(2.0) * sigma - rho)
        coeffs.append((float(rho_new * rho),
                       float(f(2.0) * rho_new / delta)))
        rho = rho_new
    return float(theta), tuple(coeffs)


def _cheb_smooth(op, lev: _Level, b, x, degree: int):
    """``degree`` steps of Chebyshev-Jacobi smoothing of K x = b over
    [lmax/4, lmax] of D^{-1}K (a fixed polynomial: linear and symmetric,
    safe inside an SPD preconditioner).  The coefficients take the level's
    precision, as the JAX package's do (float32 levels under a float64
    right-hand side: the auxiliary-space background)."""
    theta, coeffs = _cheb_coeffs(lev.lmax_host, int(degree),
                                 lev.lmax.dtype == torch.float64)
    r = b - op(x)
    d = (lev.dinv * r) / theta
    x = x + d
    for c1, c2 in coeffs:
        r = r - op(d)
        d = c1 * d + c2 * (lev.dinv * r)
        x = x + d
    return x


def _unpad_rows(a: torch.Tensor, k: int) -> torch.Tensor:
    """Drop |k| dead rows of a padded level: k > 0 prepended (slice the
    front), k < 0 appended (slice the back), 0 none."""
    if k == 0:
        return a
    return a[k:] if k > 0 else a[:k]


def _pad0_rows(a: torch.Tensor, k: int) -> torch.Tensor:
    """Exact adjoint of ``_unpad_rows``: zero rows on the matching side."""
    if k == 0:
        return a
    z = a.new_zeros((abs(k),) + tuple(a.shape[1:]))
    return torch.cat([z, a] if k > 0 else [a, z], dim=0)


def _fused_levels(ops, levels, nu: int, coarse_degree: int, _l: int = 0):
    """The levels from ``_l`` as ``lattice_level_cycle`` takes them, each
    with its smoother (``_LevelOp.smoother``, built once an operator), or
    None where a level is off the level-step route (a plain callable, or
    not float32) or a degree is below 2."""
    if min(nu, coarse_degree) < 2:
        return None
    out = []
    for k in range(_l, len(levels)):
        op, lev = ops[k], levels[k]
        if getattr(op, "stencil", None) is None \
                or lev.dinv.dtype != torch.float32:
            return None
        out.append(op.smoother(
            lev, coarse_degree if k == len(levels) - 1 else nu))
    return out


def _vcycle(ops, levels, b, nu: int, coarse_degree: int, ks=None,
            _l: int = 0):
    """One V(nu, nu) cycle from level ``_l`` on the level operators
    ``ops``; ``ks`` are the levels' signed dead-row pad counts
    (``parallel/sharded_mg.py``; None: no level is padded).  Where b is
    float32 on the card, no level is padded and every level takes the
    level-step kernels' route (``_fused_levels``) the cycle is
    ``lattice_level_cycle``: each Chebyshev step of a level one launch,
    the bottom levels one; elsewhere (the CPU, float64, a float64 b on
    float32 levels, the sharded engines) the composition below, the same
    function (bit for bit where the stencil sums keep K6's order)."""
    fused = None
    if ks is None and b.is_cuda and b.dtype == torch.float32:
        fused = _fused_levels(ops, levels, nu, coarse_degree, _l)
    if fused is not None:
        return lattice_level_cycle(fused, b.contiguous())
    lev, op = levels[_l], ops[_l]
    if _l == len(levels) - 1:
        return _cheb_smooth(op, lev, b, torch.zeros_like(b), coarse_degree)
    k0, k1 = (0, 0) if ks is None else (ks[_l], ks[_l + 1])
    x = _cheb_smooth(op, lev, b, torch.zeros_like(b), nu)
    rc = _pad0_rows(_restrict(_unpad_rows(b - op(x), k0)), k1)
    xc = _vcycle(ops, levels, rc, nu, coarse_degree, ks, _l + 1)
    x = x + lev.free * _pad0_rows(prolong(_unpad_rows(xc, k1)), k0)
    return _cheb_smooth(op, lev, b, x, nu)


def vcycle(model, levels: Tuple[_Level, ...], b, nu: int = 3,
           coarse_degree: int = 24, _l: int = 0, g0s=None):
    """One V(nu, nu) cycle approximating K^{-1} b on the finest level;
    linear and symmetric in ``b`` (a valid PCG preconditioner).  Pass
    ``g0s = level_g0s(model, levels)`` so the affine parts are not
    recomputed per call (the solvers build the level operators once a
    solve and call ``_vcycle``)."""
    return _vcycle(_level_ops(model, levels, g0s), levels, b, nu,
                   coarse_degree, _l=_l)


# -------------------------------------------------------------------- PCG
def _udot(a: dict, b: dict) -> torch.Tensor:
    return torch.sum(a["u"] * b["u"])


def _plan(key, model, levels: tuple, r: dict, max_iters: int, tol: float,
          nu: int, coarse_degree: int) -> PCGLoop:
    """What an MG-PCG solve on one hierarchy runs besides its right-hand
    side: the PCG loop on the level operators (their gradients at zero
    included), kept under ``key`` (``_plan_key``; None: one solve's).  Its
    closures hold the ``_Level``s, not the ``Hierarchy`` that holds it."""
    ops = _level_ops(model, levels)
    return PCGLoop(lambda v: {"u": ops[0](v["u"])},
                   lambda b: {"u": _vcycle(ops, levels, b["u"], nu,
                                           coarse_degree)},
                   _udot, r, max_iters, tol, key=key)


def _plan_key(model, u0: torch.Tensor, max_iters: int, tol: float,
              nu: int, coarse_degree: int) -> tuple:
    """What a plan is built from besides the hierarchy: what the level
    operators read of the model, the solution's dtype and device, whether
    the loop is captured, and the solve's settings."""
    return (type(model), model.E, model.nu, model.dtype, model.u_fixed,
            model.backend, u0.dtype, u0.device, _loop.capturable(u0.device),
            max_iters, tol, nu, coarse_degree)


def _mg_pcg(model, levels, grid, params, max_iters: int, tol: float,
            nu: int, coarse_degree: int, keep: bool = False):
    u0 = params["u"].detach()
    coords = levels[0].coords
    key = (_plan_key(model, u0, max_iters, tol, nu, coarse_degree) if keep
           else None)
    plan = take_plan(levels, key) if keep else None
    with annotate("hidenn.mg.level_ops"):
        u = u0.clone().requires_grad_(True)
        (g0,) = torch.autograd.grad(model({"coords": coords, "u": u}, grid),
                                    u)
        r = {"u": -g0}
        if plan is None:
            # loop invariants: every level's operator (level 0's is K of
            # the full energy: the traction term is linear in u)
            plan = _plan(key, model, tuple(levels), r, max_iters, tol, nu,
                         coarse_degree)
            plan_counts["built"] += 1
        else:
            plan_counts["reused"] += 1
    x, hist = _pcg(plan.matvec, plan.precond, _udot, r, max_iters, tol,
                   loop=plan)
    if keep:
        hold_plan(levels, plan)
    return {"coords": params["coords"], "u": u0 + x["u"]}, hist


def mg_pcg_solve(model, grid: StructuredGrid, params,
                 max_iters: int = 60, tol: float = 1e-6, nu: int = 3,
                 coarse_degree: int = 24,
                 levels: Optional[Tuple[_Level, ...]] = None
                 ) -> Tuple[dict, torch.Tensor]:
    """Solve the fixed-mesh displacement problem ``min_u E(u)`` on a
    ``StructuredGridP1`` model by V-cycle-preconditioned CG.

    Args:
      model: a ``StructuredGridP1`` (its ``total`` supplies the RHS, its
        domain energy every level operator).
      grid: the fine ``StructuredGrid``.
      params: ``{"coords", "u"}``; coordinates are frozen (pinned by the
        model's getter, so r-adapted meshes work), ``u`` is the initial
        guess.
      levels: a prebuilt ``build_hierarchy(...)`` (or
        ``convert.levels_from_numpy(...)``) to amortize set-up over
        repeated solves at the same coordinates.  The solve keeps its
        plan on it: the level operators with their gradients at zero,
        the PCG loop's carried tensors and, on the card, its start (the
        first V-cycle and the dots) and iteration, each recorded once in
        a CUDA graph.  A later solve on the same hierarchy copies in its
        right-hand side and replays both, where the key matches: the
        model's type, E, nu, dtype, ``u_fixed`` and backend (not its
        tractions), u's dtype and device, whether the card captures,
        ``max_iters``, ``tol``, ``nu`` and ``coarse_degree``.  Otherwise
        it builds a new plan, which replaces the held one.  The
        first solve on a plan warms up and records the iteration, the
        second records the start; at most these two graphs stay alive,
        and they die with the hierarchy.  Without ``levels`` the solve
        builds a hierarchy and a plan and drops both.

    Returns (solved params, per-iteration relative residual norms
    [max_iters], zero for iterations never run); neither shares memory
    with the plan.
    """
    with annotate("hidenn.mg_pcg_solve"):
        with torch.no_grad():
            coords = model.coords(params, grid)
        keep = isinstance(levels, Hierarchy)
        if levels is None:
            levels = build_hierarchy(model, grid, coords)
        return _mg_pcg(model, levels, grid, params, int(max_iters),
                       float(tol), int(nu), int(coarse_degree), keep)


def radapt_mg_solve(model, grid: StructuredGrid, params,
                    outer_epochs: int = 10, mg_iters: int = 40,
                    mg_tol: float = 1e-6, coord_steps: int = 20,
                    coord_lr: float = 1e-7) -> Tuple[dict, torch.Tensor]:
    """r-adaptivity on the structured path with exact multigrid inner
    solves: each outer epoch (1) MG-PCG-solves the displacement system at
    the current node coordinates (rebuilding the hierarchy, since the
    level diagonals and spectra follow the moved mesh), then (2) takes
    ``coord_steps`` Adam steps on the coordinates at the equilibrated
    displacements.

    Returns (params, per-epoch energies at the equilibrated states).
    """
    from . import optimizers as _opt
    from .drivers import run_optimizer

    opt_c = _opt.freeze_groups(_opt.adam(coord_lr), ["u"])
    energies = []
    for _ in range(outer_epochs):
        params, _ = mg_pcg_solve(model, grid, params, max_iters=mg_iters,
                                 tol=mg_tol)
        with torch.no_grad():
            energies.append(model(params, grid))
        params, _ = run_optimizer(model.total, params, opt_c, coord_steps,
                                  (grid,))
    return params, torch.stack(energies)
