"""Auxiliary-space preconditioned CG for unstructured meshes (port of
``hidenn_fem_tpu/solve/auxspace.py``).

Geometric multigrid (``solve/multigrid.py``) needs a lattice; general
gmsh-style meshes have none.  The auxiliary-space method (Xu's two-level
trick) preconditions the unstructured system with

    M^{-1} r  =  omega * D^{-1} r  +  P · B_bg(P^T r)

where D is the exact colored-probe Jacobi diagonal
(``solve/linear.py:jacobi_diagonal``), P the bilinear interpolation from
a regular background lattice covering the mesh to the mesh nodes, and
B_bg one multigrid V-cycle of the same plane-stress operator on the
background lattice (every level operator one launch of the stencil kernel
K6 on a CUDA float32 lattice).  The diagonal takes the high-frequency
error, the V-cycle the smooth error that makes plain CG's iteration count
grow like O(1/h).  Both terms are symmetric positive (semi-)definite, so
plain PCG applies.

The lattice, hierarchy and transfer tables are built once at set-up
(numpy, array-equal to the JAX package's).  P is four weighted rows of a
flat gather; P^T a gather through a background-node -> fine-node
incidence table, or the same table in blocked windows above 200,000
nodes where the fine numbering is local (the JAX package's rule, kept so
that the results follow the reference).  When the mesh carries a lattice
or hybrid route, the background is the fine node lattice itself: P^T is a
reshape (kind "reshape", with tiny bilinear tables for a hybrid mesh's
rim nodes) or a permutation gather (kind "perm").

The JAX package runs the PCG loop as one compiled ``while_loop``.  Here
the iteration is ``solve/linear.py``'s masked body, which
``solve/loop.py`` records once in a CUDA graph on the card and replays,
reading the stop flag once every ``loop.READ_EVERY`` iterations; the
background levels' operators and the windowed P^T's gather index are
built before the first iteration, and the history holds zeros past the
stop.  None of that depends on the load, so a solve on a prebuilt
preconditioner keeps its plan there (a kept ``linear.PCGLoop`` on the
level operators and the fine operator at the plan's base point, whose
start and iteration are each recorded once), and the next solve with the
same key replays both graphs after one copy of its right-hand side.
The fine operator is the caller's loss, which the key cannot see, so a
replayed answer is returned only where the solve's own loss passes it
(``_replayed``); ``plan_counts`` counts the plans built, reused and
refused.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..models.structured_grid import StructuredGrid, StructuredGridP1
from ..ops.assembly import weighted_incidence_gather_sum
from ..utils.profiling import annotate
from . import loop as _loop
from . import multigrid as mg
from .linear import (PCGLoop, _grad, _pcg, _tree_axpy, hold_plan,
                     jacobi_diagonal, take_plan)

__all__ = ["build_aux_preconditioner", "aux_pcg_solve", "radapt_aux_solve"]

_TINY = 1e-30

# aux-space PCG plans built (a solve on a prebuilt preconditioner with no
# plan of its key, or whose held plan's answer was refused), reused (a
# solve that replayed the held plan and returned its answer) and refused
# (a replayed answer that the check threw away)
plan_counts = {"built": 0, "reused": 0, "refused": 0}


@dataclasses.dataclass(frozen=True)
class _AuxPrecond:
    """Set-up products of the auxiliary-space preconditioner (the JAX
    package's fields; index tables are int64 tensors).

    The generic bilinear tables (``p_idx``, ``p_w``, ``pt_idx``, ``pt_w``)
    are None when a lattice-aligned background is active (``lat_kind``
    not ""); the windowed P^T tables (``ptw_*``) are None unless the
    windowed layout was selected; the permutation tables (``lat_inv``,
    ``lat_pos``) belong to kind "perm" and the rim tables (``rim_*``,
    ``aff_*``) to a hybrid mesh on kind "reshape".  ``bg_model`` is the
    model the hierarchy was built with: solves run the V-cycle with it.
    """

    levels: tuple                 # multigrid hierarchy on the background
    grid: StructuredGrid          # background lattice
    dinv: torch.Tensor            # [N, 2] guarded inverse fine diagonal
    p_idx: Optional[torch.Tensor]   # [N*4] flat bg-node ids (corner gather)
    p_w: Optional[torch.Tensor]     # [N, 4] bilinear weights
    pt_idx: Optional[torch.Tensor]  # [Nb*D] fine-node ids (N: sentinel)
    pt_w: Optional[torch.Tensor]    # [Nb, D] weights (0 on pad)
    free: torch.Tensor            # [N, 1] 1/0: used and not Dirichlet
    ptw_rel: Optional[torch.Tensor] = None     # [BB, R, D] window-relative
    ptw_w: Optional[torch.Tensor] = None       # [BB, R, D] weights
    ptw_starts: Optional[torch.Tensor] = None  # [BB] window starts
    ptw_width: int = 0
    omega: float = 0.5
    bg_model: Optional[StructuredGridP1] = None
    lat_kind: str = ""
    lat_nx: int = 0
    lat_ny: int = 0
    lat_inv: Optional[torch.Tensor] = None    # [nx*ny] pos -> node (N: none)
    lat_pos: Optional[torch.Tensor] = None    # [N] node -> pos
    rim_corners: Optional[torch.Tensor] = None  # [R*4] flat padded bg ids
    rim_w: Optional[torch.Tensor] = None        # [R, 4]
    aff_ids: Optional[torch.Tensor] = None      # [A] flat padded bg ids
    aff_inc: Optional[torch.Tensor] = None      # [A*D] rim-relative (R: none)
    aff_w: Optional[torch.Tensor] = None        # [A, D]
    # [BB, R, D] fine-node ids of the windowed P^T's gather (N: the zero
    # row), derived from the window tables once, not on every application
    ptw_idx: Optional[torch.Tensor] = dataclasses.field(init=False,
                                                        default=None)
    # the plan of the last ``aux_pcg_solve`` on this preconditioner (a
    # kept ``PCGLoop``; None before one), which dies with it:
    # ``dataclasses.replace`` makes a preconditioner without it
    plan: Optional[PCGLoop] = dataclasses.field(init=False, default=None,
                                                repr=False, compare=False)

    def __post_init__(self):
        if self.ptw_rel is not None:
            object.__setattr__(self, "ptw_idx", torch.where(
                self.ptw_rel == self.ptw_width, self.free.shape[0],
                self.ptw_starts[:, None, None] + self.ptw_rel))


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _grid(bgc: np.ndarray, dirichlet: np.ndarray, quad_mask: np.ndarray,
          split: str, device) -> StructuredGrid:
    nx, ny = bgc.shape[:2]
    return StructuredGrid(
        coords=torch.tensor(bgc, dtype=torch.float32, device=device),
        geom_boundary_mask=torch.zeros((nx, ny), dtype=torch.bool,
                                       device=device),
        dirichlet_mask=torch.tensor(dirichlet, device=device),
        quad_mask=torch.tensor(quad_mask, dtype=torch.float32,
                               device=device),
        neumann_edge_masks={}, u_dirichlet=None, split=split)


def _bg_lattice(coords: np.ndarray, dirichlet: np.ndarray, bg_nx: int,
                bg_ny: int, device) -> StructuredGrid:
    """Uniform background grid covering the mesh bbox, with Dirichlet
    transferred by rasterizing the fine Dirichlet nodes to their nearest
    lattice node (preconditioner quality only: the fine BCs stay exact
    through the fine operator)."""
    x0, y0 = coords.min(axis=0)
    x1, y1 = coords.max(axis=0)
    pad = 1e-6 * max(x1 - x0, y1 - y0, 1.0)
    x0, y0, x1, y1 = x0 - pad, y0 - pad, x1 + pad, y1 + pad
    xs = np.linspace(x0, x1, bg_nx)
    ys = np.linspace(y0, y1, bg_ny)
    xv, yv = np.meshgrid(xs, ys, indexing="ij")
    bgc = np.stack([xv, yv], axis=-1).astype(np.float32)

    bc = np.zeros((bg_nx, bg_ny), bool)
    if dirichlet.any():
        dc = coords[dirichlet]
        ix = np.clip(np.rint((dc[:, 0] - x0) / (x1 - x0) * (bg_nx - 1)),
                     0, bg_nx - 1).astype(np.int64)
        iy = np.clip(np.rint((dc[:, 1] - y0) / (y1 - y0) * (bg_ny - 1)),
                     0, bg_ny - 1).astype(np.int64)
        bc[ix, iy] = True
    return _grid(bgc, bc, np.ones((bg_nx - 1, bg_ny - 1), np.float32), "up",
                 device)


def _lattice_bg_setup(coords: np.ndarray, route, dirichlet: np.ndarray,
                      device):
    """Fine-lattice-resolution background grid and transfer tables.

    The background reuses the mesh's node lattice (``mesh/lattice.py``
    route): the same coordinates, Dirichlet taken exactly from the fine
    mask, hole quads masked from the route's triangle-presence masks.  The
    quad lattice is padded append-side to the next multiple of 2^L (L so
    that the coarsest level keeps ~8-16 nodes on the short axis) with dead
    quads, so ``build_hierarchy`` coarsens any lattice shape; dead padding
    is outside the operator's support, so the V-cycle's output there is
    zero.  Returns ``(grid, extras)``, extras the ``_AuxPrecond`` lattice
    fields (kind "reshape" or "perm"; rim and affected-node tables for a
    hybrid mesh's suffix nodes).
    """
    nx, ny = route.nx, route.ny
    n_lat = nx * ny
    n = coords.shape[0]

    # per-axis levels of the (monotone) lattice
    if route.identity or route.prefix_identity:
        lat = coords[:n_lat].reshape(nx, ny, 2)
        xs, ys = lat[:, 0, 0].copy(), lat[0, :, 1].copy()
        extras = dict(lat_kind="reshape", lat_nx=nx, lat_ny=ny)
    else:
        inv = _np(route.inv_map).astype(np.int64)
        live = inv < n
        xs = np.full(nx, np.nan)
        ys = np.full(ny, np.nan)
        li, lj = np.flatnonzero(live) // ny, np.flatnonzero(live) % ny
        xs[li] = coords[inv[live], 0]
        ys[lj] = coords[inv[live], 1]
        # a level is empty only if a whole lattice row or column died:
        # fill it by linear interpolation of the others
        for arr in (xs, ys):
            bad = np.isnan(arr)
            if bad.any():
                idx = np.arange(arr.size)
                arr[bad] = np.interp(idx[bad], idx[~bad], arr[~bad])
        extras = dict(lat_kind="perm", lat_nx=nx, lat_ny=ny,
                      lat_inv=torch.tensor(inv, device=device),
                      lat_pos=torch.tensor(
                          _np(route.fwd_map).astype(np.int64),
                          device=device))

    hx = xs[-1] - xs[-2] if nx > 1 else 1.0
    hy = ys[-1] - ys[-2] if ny > 1 else 1.0
    m = max(2, min(nx, ny) - 1)
    lvl = max(1, int(np.floor(np.log2(m))) - 3)
    step = 1 << lvl
    big_nx = -(-(nx - 1) // step) * step + 1
    big_ny = -(-(ny - 1) // step) * step + 1
    xs_pad = np.concatenate(
        [xs, xs[-1] + hx * np.arange(1, big_nx - nx + 1)])
    ys_pad = np.concatenate(
        [ys, ys[-1] + hy * np.arange(1, big_ny - ny + 1)])
    xv, yv = np.meshgrid(xs_pad, ys_pad, indexing="ij")
    bgc = np.stack([xv, yv], axis=-1).astype(np.float32)

    core = (_np(route.t1) + _np(route.t2)) > 0
    if n > n_lat:
        # hybrid collar band: rim and collar dofs live inside quads the
        # lattice route marks dead, and a dof whose background
        # neighbourhood is all dead gets only the omega D^{-1} term.
        # Activating the cells that contain rim points, 1-dilated, gives
        # the staircase-to-rim band background stiffness; the hole
        # interior proper stays dead.
        rimc = coords[n_lat:]
        ix = np.clip(((rimc[:, 0] - xs[0]) / max(hx, 1e-30)).astype(
            np.int64), 0, nx - 2)
        iy = np.clip(((rimc[:, 1] - ys[0]) / max(hy, 1e-30)).astype(
            np.int64), 0, ny - 2)
        band = np.zeros_like(core)
        band[ix, iy] = True
        # non-wrapping 1-dilation (np.roll would wrap a rim cell on an
        # edge row onto the opposite edge)
        bp = np.pad(band, 1)
        d = np.zeros_like(band)
        for si in (0, 1, 2):
            for sj in (0, 1, 2):
                d |= bp[si:si + band.shape[0], sj:sj + band.shape[1]]
        core = core | d
    qm = np.zeros((big_nx - 1, big_ny - 1), np.float32)
    qm[:nx - 1, :ny - 1] = core.astype(np.float32)

    reshape = extras["lat_kind"] == "reshape"
    bc = np.zeros((big_nx, big_ny), bool)
    if reshape:
        bc[:nx, :ny] = dirichlet[:n_lat].reshape(nx, ny)
    else:
        pos = _np(route.fwd_map).astype(np.int64)
        dn = np.flatnonzero(dirichlet)
        bc[pos[dn] // ny, pos[dn] % ny] = True
    grid = _grid(bgc, bc, qm, route.uniform_sel or "up", device)

    # hybrid rim suffix: tiny bilinear tables into the padded background,
    # restricted (and renormalized) to supported corners, the background
    # nodes an active quad references; the rest get no coarse correction
    # (the V-cycle masks them), so weighting them would only attenuate z
    if reshape and n > n_lat:
        rimc = coords[n_lat:]
        fx = np.clip((rimc[:, 0] - xs[0]) / max(hx, 1e-30), 0, nx - 1)
        fy = np.clip((rimc[:, 1] - ys[0]) / max(hy, 1e-30), 0, ny - 1)
        ix = np.clip(np.floor(fx).astype(np.int64), 0, nx - 2)
        iy = np.clip(np.floor(fy).astype(np.int64), 0, ny - 2)
        tx = np.clip(fx - ix, 0.0, 1.0)
        ty = np.clip(fy - iy, 0.0, 1.0)
        corners = np.stack([ix * big_ny + iy,
                            (ix + 1) * big_ny + iy,
                            ix * big_ny + (iy + 1),
                            (ix + 1) * big_ny + (iy + 1)], axis=1)
        w = np.stack([(1 - tx) * (1 - ty), tx * (1 - ty),
                      (1 - tx) * ty, tx * ty], axis=1)
        act = qm[:nx - 1, :ny - 1] > 0
        sup = np.zeros((nx, ny), bool)
        sup[:-1, :-1] |= act
        sup[1:, :-1] |= act
        sup[:-1, 1:] |= act
        sup[1:, 1:] |= act
        sup_pad = np.zeros((big_nx, big_ny), bool)
        sup_pad[:nx, :ny] = sup
        w = w * sup_pad.reshape(-1)[corners]
        s = w.sum(axis=1, keepdims=True)
        w = np.where(s > 0, w / np.maximum(s, 1e-30), 0.0).astype(
            np.float32)
        # P^T side: incidence of the affected background nodes over the
        # rim indices (unique ids: one addend a row in the scatter-add)
        r_cnt = rimc.shape[0]
        flat_b = corners.reshape(-1)
        flat_r = np.repeat(np.arange(r_cnt, dtype=np.int64), 4)
        flat_w = w.reshape(-1)
        keep = flat_w > 0
        flat_b, flat_r, flat_w = flat_b[keep], flat_r[keep], flat_w[keep]
        aff = np.unique(flat_b)
        remap = np.zeros(big_nx * big_ny, np.int64)
        remap[aff] = np.arange(aff.size)
        rows = remap[flat_b]
        counts = np.bincount(rows, minlength=aff.size)
        d = max(int(counts.max()) if counts.size else 1, 1)
        order = np.argsort(rows, kind="stable")
        rows, flat_r, flat_w = rows[order], flat_r[order], flat_w[order]
        slot = (np.arange(rows.size)
                - np.concatenate([[0], np.cumsum(counts)[:-1]])[rows])
        aff_inc = np.full((aff.size, d), r_cnt, np.int64)
        aff_w = np.zeros((aff.size, d), np.float32)
        aff_inc[rows, slot] = flat_r
        aff_w[rows, slot] = flat_w
        extras.update(
            rim_corners=torch.tensor(corners.reshape(-1), device=device),
            rim_w=torch.tensor(w, device=device),
            aff_ids=torch.tensor(aff, device=device),
            aff_inc=torch.tensor(aff_inc.reshape(-1), device=device),
            aff_w=torch.tensor(aff_w, device=device))
    return grid, extras


def _transfer_tables(coords: np.ndarray, grid_np):
    """Bilinear interpolation tables fine <-> background: (p_idx [N, 4]
    flat background ids, p_w [N, 4], pt_idx [Nb, D] fine ids padded with
    N, pt_w [Nb, D])."""
    bgc, bg_nx, bg_ny = grid_np
    x0, y0 = bgc[0, 0]
    hx = bgc[1, 0, 0] - bgc[0, 0, 0]
    hy = bgc[0, 1, 1] - bgc[0, 0, 1]
    n = coords.shape[0]

    fx = (coords[:, 0] - x0) / hx
    fy = (coords[:, 1] - y0) / hy
    ix = np.clip(np.floor(fx).astype(np.int64), 0, bg_nx - 2)
    iy = np.clip(np.floor(fy).astype(np.int64), 0, bg_ny - 2)
    tx = np.clip(fx - ix, 0.0, 1.0)
    ty = np.clip(fy - iy, 0.0, 1.0)

    corners = np.stack([ix * bg_ny + iy,
                        (ix + 1) * bg_ny + iy,
                        ix * bg_ny + (iy + 1),
                        (ix + 1) * bg_ny + (iy + 1)], axis=1)
    weights = np.stack([(1 - tx) * (1 - ty), tx * (1 - ty),
                        (1 - tx) * ty, tx * ty], axis=1).astype(np.float32)

    nb = bg_nx * bg_ny
    flat_b = corners.reshape(-1)
    flat_f = np.repeat(np.arange(n, dtype=np.int64), 4)
    flat_w = weights.reshape(-1)
    order = np.argsort(flat_b, kind="stable")
    flat_b, flat_f, flat_w = flat_b[order], flat_f[order], flat_w[order]
    counts = np.bincount(flat_b, minlength=nb)
    d = max(int(counts.max()), 1)
    pt_idx = np.full((nb, d), n, dtype=np.int64)      # N: the sentinel row
    pt_w = np.zeros((nb, d), dtype=np.float32)
    slot = (np.arange(flat_b.size)
            - np.concatenate([[0], np.cumsum(counts)[:-1]])[flat_b])
    pt_idx[flat_b, slot] = flat_f
    pt_w[flat_b, slot] = flat_w
    return corners, weights, pt_idx, pt_w


def _windowed_pt(pt_idx: np.ndarray, pt_w: np.ndarray, n: int, bg_nx: int,
                 bg_ny: int, window_limit: int = 65536):
    """Blocked-window form of the P^T tables (numpy, one-time set-up).

    Groups background-lattice rows into ~64 blocks; if every block's
    referenced fine nodes fit a ``window_limit`` contiguous range (true
    for locality-preserving fine numberings), returns (rel [BB, R, D],
    w [BB, R, D], starts [BB], width) with sentinel entries ``width``
    pointing at the zero row after the window; None when the numbering is
    too scattered (flat tables then)."""
    d = pt_w.shape[1]
    idx2 = pt_idx.reshape(bg_nx, bg_ny * d)
    gb = max(1, bg_nx // 64)
    bb = -(-bg_nx // gb)
    real = idx2 != n
    width = 0
    starts = np.zeros(bb, np.int32)
    for blk in range(bb):
        rows = idx2[blk * gb:(blk + 1) * gb]
        rr = rows[real[blk * gb:(blk + 1) * gb]]
        lo, hi = (int(rr.min()), int(rr.max())) if rr.size else (0, 0)
        starts[blk] = lo
        width = max(width, hi - lo + 1)
    if width > window_limit:
        return None
    width = min(width, n)
    r = gb * bg_ny
    rel = np.full((bb, r, d), width, np.int64)
    w_out = np.zeros((bb, r, d), pt_w.dtype)
    w2 = pt_w.reshape(bg_nx, bg_ny, d)
    for blk in range(bb):
        s = min(int(starts[blk]), n - width)
        starts[blk] = s
        rows = idx2[blk * gb:(blk + 1) * gb].reshape(-1, d)
        rel[blk, :rows.shape[0]] = np.where(rows != n, rows - s, width)
        w_out[blk, :rows.shape[0]] = w2[blk * gb:(blk + 1) * gb].reshape(
            -1, d)
    return rel, w_out, starts, int(width)


def _guarded_inverse(d: torch.Tensor) -> torch.Tensor:
    return torch.where(d > _TINY, 1.0 / torch.clamp_min(d, _TINY), 0.0)


def build_aux_preconditioner(loss_fn, params, loss_args, mesh,
                             bg_model: Optional[StructuredGridP1] = None,
                             bg_shape: Optional[Tuple[int, int]] = None,
                             node_colors=None, omega: float = 0.5,
                             u_key: str = "u",
                             lattice_bg: bool = True) -> _AuxPrecond:
    """One-time set-up: background lattice, multigrid hierarchy, transfer
    tables and the exact Jacobi diagonal, on the mesh's device.

    Args:
      loss_fn/params/loss_args: the quadratic fine problem, as for
        ``cg_solve`` (params must be ``{u_key: [N, 2]}``).
      mesh: the ``TriMesh`` (coords, Dirichlet mask, connectivity, and its
        lattice or hybrid route when ``lattice_bg``).
      bg_model: ``StructuredGridP1`` carrying E and nu of the background
        operator (default E=10e9, nu=0.3: match the energy); on a CUDA
        float32 model every level operator is one K6 launch.
      bg_shape: background lattice (nx, ny); default about half the fine
        resolution per axis, at least 33.  Passing it also turns off the
        lattice-aligned background.
    """
    coords = _np(mesh.coords)
    dirichlet = _np(mesh.dirichlet_mask).astype(bool)
    conn = _np(mesh.connectivity)
    n = coords.shape[0]
    dev = mesh.coords.device
    # Only real constraints shape the background operator: a node no
    # element references (dead nodes kept by structured and hybrid
    # meshes, pinned as Dirichlet) carries no boundary condition, and
    # rasterizing it would stamp Dirichlet over the hole regions.
    used = np.zeros(n, dtype=bool)
    used[conn.reshape(-1)] = True
    dirichlet = dirichlet & used

    # lattice and hybrid meshes: the background is the fine lattice itself
    # unless the caller pinned a bg_shape
    hyb = getattr(mesh, "hybrid", None)
    route = hyb.lattice if hyb is not None else getattr(mesh, "lattice",
                                                        None)
    lat_grid = lat_extras = None
    if lattice_bg and route is not None and bg_shape is None \
            and route.nx >= 9 and route.ny >= 9:
        lat_grid, lat_extras = _lattice_bg_setup(coords, route, dirichlet,
                                                 dev)

    if bg_shape is None:
        side = max(33, int(np.sqrt(n) / 2))
        k = 1 << max(5, int(np.ceil(np.log2(max(side - 1, 1)))))
        ext = coords.max(axis=0) - coords.min(axis=0)
        bg_shape = (k + 1, k // 2 + 1) if ext[0] >= ext[1] else (
            k // 2 + 1, k + 1)
    bg_nx, bg_ny = bg_shape
    if bg_model is None:
        bg_model = StructuredGridP1(E=10e9, nu=0.3)

    grid = lat_grid if lat_grid is not None else _bg_lattice(
        coords, dirichlet, bg_nx, bg_ny, dev)
    levels = mg.build_hierarchy(bg_model, grid, grid.coords)
    tables = dict(p_idx=None, p_w=None, pt_idx=None, pt_w=None)
    win = None
    if lat_grid is None:
        p_idx, p_w, pt_idx, pt_w = _transfer_tables(
            coords, (_np(grid.coords), bg_nx, bg_ny))
        tables = {k: torch.tensor(v, device=dev) for k, v in dict(
            p_idx=p_idx.reshape(-1), p_w=p_w, pt_idx=pt_idx.reshape(-1),
            pt_w=pt_w).items()}
        # the windowed layout only above 200,000 nodes (the JAX package's
        # rule); the lattice path needs neither
        if n > 200_000:
            win = _windowed_pt(pt_idx, pt_w, n, bg_nx, bg_ny)

    if node_colors is None:
        from ..mesh.coloring import color_nodes
        node_colors = color_nodes(conn, n)
    dinv = _guarded_inverse(
        jacobi_diagonal(loss_fn, params, loss_args, node_colors)[u_key])
    # free excludes dead nodes too: the background would otherwise
    # interpolate junk into dofs the operator never sees
    free = torch.tensor((used & ~dirichlet).astype(np.float32)[:, None],
                        device=dev)
    windowed = {}
    if win is not None:
        rel, w, starts, width = win
        windowed = dict(ptw_rel=torch.tensor(rel, device=dev),
                        ptw_w=torch.tensor(w, device=dev),
                        ptw_starts=torch.tensor(starts.astype(np.int64),
                                                device=dev),
                        ptw_width=width)
    return _AuxPrecond(levels=levels, grid=grid, dinv=dinv, free=free,
                       omega=float(omega), bg_model=bg_model, **tables,
                       **windowed, **(lat_extras or {}))


def _pad_to(x: torch.Tensor, nb_nx: int, nb_ny: int) -> torch.Tensor:
    """[nx, ny, 2] zero-padded append-side to [nb_nx, nb_ny, 2]."""
    out = x.new_zeros((nb_nx, nb_ny, x.shape[-1]))
    out[:x.shape[0], :x.shape[1]] = x
    return out


def _zero_row(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, x.new_zeros((1, x.shape[-1]))])


def _generic_pt(pre: _AuxPrecond, rf: torch.Tensor) -> torch.Tensor:
    """P^T rf [N, 2] -> [nb_nx, nb_ny, 2] through the generic tables:
    the windowed layout when the set-up selected it, else the flat one."""
    nb_nx, nb_ny = pre.grid.nx, pre.grid.ny
    r_pad = _zero_row(rf)
    if pre.ptw_idx is not None:
        # each background-row block reads the fine rows [start, start +
        # width) and, for the sentinel, the zero row: one batched gather
        out = torch.sum(pre.ptw_w[..., None] * r_pad[pre.ptw_idx], dim=2)
        return out.reshape(-1, 2)[:nb_nx * nb_ny].reshape(nb_nx, nb_ny, 2)
    # the fine-node incidence gather (sentinel N: the zero row)
    return weighted_incidence_gather_sum(
        r_pad, pre.pt_idx.reshape(pre.pt_w.shape),
        pre.pt_w).reshape(nb_nx, nb_ny, 2)


def _apply_aux(bg_model, pre: _AuxPrecond, r, ops=None):
    """M^{-1} r (module doc); [N, 2] in and out.  ``ops``: the background
    levels' operators (``multigrid._level_ops``), built once a solve."""
    nb_nx, nb_ny = pre.grid.nx, pre.grid.ny
    if ops is None:
        ops = mg._level_ops(bg_model, pre.levels)

    def vcycle(b):
        return mg._vcycle(ops, pre.levels, b, nu=3, coarse_degree=24)

    rf = r * pre.free
    if pre.lat_kind == "reshape":
        # the lattice prefix is the background's core: P^T is a reshape
        # and a zero pad, P a slice; hybrid rim nodes (the suffix) ride
        # their small incidence and corner tables
        nx, ny = pre.lat_nx, pre.lat_ny
        n_lat = nx * ny
        r_bg = _pad_to(rf[:n_lat].reshape(nx, ny, 2), nb_nx, nb_ny)
        if pre.rim_corners is not None:
            g = _zero_row(rf[n_lat:])[pre.aff_inc].reshape(
                *pre.aff_w.shape, 2)
            contrib = torch.sum(pre.aff_w[..., None] * g, dim=1)
            # aff_ids are unique: one addend a row, so the add is exact
            # and deterministic
            r_bg = r_bg.reshape(-1, 2).index_add(
                0, pre.aff_ids, contrib.to(rf.dtype)).reshape(nb_nx, nb_ny,
                                                              2)
        z_bg = vcycle(r_bg)
        zf = z_bg[:nx, :ny].reshape(-1, 2)
        if pre.rim_corners is not None:
            zc = z_bg.reshape(-1, 2)[pre.rim_corners].reshape(-1, 4, 2)
            z_rim = torch.sum(pre.rim_w[..., None] * zc, dim=1)
            zf = torch.cat([zf, z_rim.to(zf.dtype)], dim=0)
        return pre.free * (pre.omega * pre.dinv * r + zf)
    if pre.lat_kind == "perm":
        # a lattice with deleted nodes: P^T and P are one permutation
        # gather each
        nx, ny = pre.lat_nx, pre.lat_ny
        r_bg = _pad_to(_zero_row(rf)[pre.lat_inv].reshape(nx, ny, 2),
                       nb_nx, nb_ny)
        z_bg = vcycle(r_bg)
        zf = z_bg[:nx, :ny].reshape(-1, 2)[pre.lat_pos]
        return pre.free * (pre.omega * pre.dinv * r + zf)
    z_bg = vcycle(_generic_pt(pre, rf)).reshape(-1, 2)
    # P z_bg: four weighted corner rows per fine node
    z_coarse = weighted_incidence_gather_sum(z_bg, pre.p_idx.reshape(-1, 4),
                                             pre.p_w)
    return pre.free * (pre.omega * pre.dinv * r + z_coarse)


def _system(loss_fn, bg_model, pre: _AuxPrecond, u0: dict, g0: dict,
            loss_args: tuple, u_key: str):
    """(matvec, precond, dot) of the PCG loop: v -> grad loss(u0 + v) - g0
    with g0 = grad loss(u0), which is K v for a quadratic loss whatever
    its load, and M^{-1} on the background levels' operators, built here
    once (loop-invariant).  The closures hold u0, g0 and ``loss_args``,
    so a plan made of them keeps the identities in its key."""
    ops = mg._level_ops(bg_model, pre.levels)

    def matvec(v):
        gv = _grad(loss_fn, _tree_axpy(1.0, v, u0), loss_args)
        return {k: gv[k] - g0[k] for k in gv}

    def precond(rt):
        return {u_key: _apply_aux(bg_model, pre, rt[u_key], ops)}

    def dot(a, b):
        return torch.sum(a[u_key] * b[u_key])

    return matvec, precond, dot


def _unplanned(pre: _AuxPrecond) -> _AuxPrecond:
    """``pre`` without its plan: the same tensors (none copied or derived
    again), for a plan's closures to hold without a cycle through the
    preconditioner that holds the plan."""
    out = copy.copy(pre)
    object.__setattr__(out, "plan", None)
    return out


def _plan_key(bg_model, params: dict, loss_args: tuple, max_iters: int,
              tol: float, u_key: str) -> tuple:
    """What a plan is built from that the code can see: each of
    ``loss_args`` by identity, a tensor with its in-place version too;
    the params' keys, shapes, dtypes and devices; ``u_key``, the solve's
    settings, the background model, and whether the card captures.  What
    the loss computes from them it cannot see: the check does."""
    return (tuple((id(a), a._version if isinstance(a, torch.Tensor)
                   else None) for a in loss_args),
            tuple((k, tuple(v.shape), v.dtype, v.device)
                  for k, v in sorted(params.items())),
            u_key, max_iters, tol, bg_model,
            _loop.capturable(params[u_key].device))


def _replayed(plan: PCGLoop, loss_fn, params: dict, loss_args: tuple):
    """The held plan's (solution, history) for this solve's loss and
    start, or None where the check refuses the answer.

    The check holds the two operators to each other on the answer x: the
    solve's own loss, grad loss(u0 + x) - grad loss(u0), against the
    plan's matvec of x.  Their difference, (K_solve - K_plan) x, must lie
    within max(tol, the loop's final relative residual) of ||grad
    loss(u0)||: a stiffness off by more than the tolerance the caller
    asked for is refused.  The answer's own float32 rounding is in both
    terms and cancels (on a new load the difference reads at most 3.6e-8
    of ||grad loss(u0)||, PERF.md section 6), whereas the true residual
    of a float32 answer lies near eps x cond(K), far above ``tol``, so it
    cannot be held to it.  A load enters both gradients of the solve's
    loss alike, so a new load passes.  The host reads the comparison
    once the loop has stopped."""
    with annotate("hidenn.aux.level_ops"):
        r = {k: -g for k, g in _grad(loss_fn, params, loss_args).items()}
    # through ``_pcg``, as ``multigrid``'s plan: with ``loop=`` it runs the
    # kept loop, on the system the loop was made with, which the other
    # arguments name
    x, hist = _pcg(plan.matvec, plan.precond, plan.dot, r, plan.max_iters,
                   plan.tol, loop=plan)
    sol = {k: params[k] + x[k] for k in params}
    with annotate("hidenn.aux.check"):
        g = _grad(loss_fn, sol, loss_args)
        kx = plan.matvec(x)
        d = {k: g[k] + r[k] - kx[k] for k in g}
        c = plan.carried
        # rs0 = ||grad loss(u0)||^2, rs the loop's last recursive ||r||^2
        limit = torch.maximum(plan.tol * plan.tol * c.rs0, c.rs)
        passed = bool(plan.dot(d, d) <= limit)
    return (sol, hist) if passed else None


def _kept(loss_fn, bg_model, max_iters: int, tol: float, u_key: str,
          params: dict, loss_args: tuple, pre: _AuxPrecond):
    """``_aux_pcg`` through the plan held on ``pre`` (``aux_pcg_solve``):
    the held plan replayed where its key matches and the check passes its
    answer, else a new plan, built, run and held in its place."""
    key = _plan_key(bg_model, params, loss_args, max_iters, tol, u_key)
    plan = take_plan(pre, key)
    if plan is not None:
        out = _replayed(plan, loss_fn, params, loss_args)
        plan_counts["reused" if out is not None else "refused"] += 1
        if out is not None:
            hold_plan(pre, plan)
            return out
    plan = None                 # its graphs go before new ones are made
    with annotate("hidenn.aux.level_ops"):
        g0 = _grad(loss_fn, params, loss_args)
        r = {k: -g for k, g in g0.items()}
        # the system at a static copy of the base point u0, and at g0
        u0 = {k: v.clone() for k, v in params.items()}
        plan = PCGLoop(*_system(loss_fn, bg_model, _unplanned(pre), u0, g0,
                                loss_args, u_key),
                       r, max_iters, tol, key=key)
    plan_counts["built"] += 1
    x, hist = _pcg(plan.matvec, plan.precond, plan.dot, r, max_iters, tol,
                   loop=plan)
    hold_plan(pre, plan)
    return {k: params[k] + x[k] for k in params}, hist


def _aux_pcg(loss_fn, bg_model, max_iters: int, tol: float, u_key: str,
             params, loss_args: tuple, pre: _AuxPrecond,
             keep: bool = False):
    """Solve from ``params`` (module doc).  ``keep``: through the plan
    held on ``pre`` (``_kept``); without it the solve makes its own loop
    and touches no plan (the sharded solve's all-reduced loss and
    ``radapt_aux_solve``, whose preconditioner lives one epoch)."""
    params = {k: v.detach() for k, v in params.items()}
    if keep:
        return _kept(loss_fn, bg_model, max_iters, tol, u_key, params,
                     loss_args, pre)
    with annotate("hidenn.aux.level_ops"):
        g0 = _grad(loss_fn, params, loss_args)
        system = _system(loss_fn, bg_model, pre, params, g0, loss_args,
                         u_key)
    # the stop flag is identical on every rank of a sharded solve, whose
    # matvecs are all-reduced
    x, hist = _pcg(*system, {k: -g for k, g in g0.items()}, max_iters, tol)
    return {k: params[k] + x[k] for k in params}, hist


def aux_pcg_solve(loss_fn, params, loss_args: tuple = (), mesh=None,
                  bg_model: Optional[StructuredGridP1] = None,
                  bg_shape: Optional[Tuple[int, int]] = None,
                  pre: Optional[_AuxPrecond] = None,
                  max_iters: int = 200, tol: float = 1e-6,
                  u_key: str = "u") -> Tuple[dict, torch.Tensor]:
    """Auxiliary-space-preconditioned CG for quadratic losses on
    unstructured meshes (module doc).

    Pass a prebuilt ``pre`` (``build_aux_preconditioner``) to amortize
    the set-up across solves.  The solve keeps its plan on it: the
    background levels' operators, static copies of the start u0 and of
    g0 = grad loss(u0) of its loss, the matvec v -> grad loss(u0 + v) -
    g0 (K v for a quadratic loss, whatever its load), the PCG loop's
    carried tensors and, on the card, its start (the first
    preconditioner application and the dots) and iteration, each
    recorded once in a CUDA graph.  A later solve on ``pre`` whose key
    matches builds its right-hand side -grad loss(u0) with its own loss,
    copies it in and replays both.  The key: each of ``loss_args`` by
    identity (a tensor with its in-place version), the params' keys,
    shapes, dtypes and devices, ``u_key``, ``max_iters``, ``tol``, the
    background model and whether the card captures; otherwise the solve
    builds a new plan, which replaces the held one.  The key cannot see
    what the loss computes (its E, nu, coordinates held elsewhere), so a
    replayed answer u0 + x is checked with the solve's own loss: it is
    returned where grad loss(u0 + x) - grad loss(u0) and the plan's
    matvec of x differ by at most max(tol, the loop's final relative
    residual) x ||grad loss(u0)|| (``_replayed``), two more gradients and
    one host read a solve.  Otherwise the answer is thrown away
    (``plan_counts["refused"]``) and the solve runs afresh on its own
    loss, on a new plan that replaces the held one.  So the plan pays
    where solves on ``pre`` repeat with the same ``loss_args`` objects and
    one stiffness, as a sweep of load cases from rest does.  A refused
    solve costs the replay and the check on top of a fresh solve, up to
    twice a solve without a plan: a loss of another stiffness, and a
    start near its answer and away from the plan's base point, which can
    be refused for float32 rounding alone (its two gradients then cancel
    their large terms in ||grad loss(u0)||'s small units).  The first
    solve on a plan warms up and records the iteration, the second
    records the start; at most these two graphs stay alive, and they die
    with the preconditioner (``dataclasses.replace`` makes one without
    the plan).  Without ``pre`` the solve builds a preconditioner and
    keeps no plan.

    Returns (solution params, per-iteration relative residual norms
    [max_iters], zero for iterations never run); neither shares memory
    with the plan.
    """
    with annotate("hidenn.aux_pcg_solve"):
        keep = pre is not None
        if pre is None:
            pre = build_aux_preconditioner(
                loss_fn, params, tuple(loss_args), mesh, bg_model=bg_model,
                bg_shape=bg_shape, u_key=u_key)
        # the V-cycle must run the model the hierarchy was built with (its
        # dinv and lmax): a mismatch would silently degrade convergence
        if pre.bg_model is not None:
            if bg_model is not None and bg_model != pre.bg_model:
                raise ValueError(
                    "bg_model does not match the model the preconditioner "
                    "was built with; rebuild with build_aux_preconditioner"
                    f" (got {bg_model!r}, built with {pre.bg_model!r})")
            bg_model = pre.bg_model
        elif bg_model is None:
            bg_model = StructuredGridP1(E=10e9, nu=0.3)
        return _aux_pcg(loss_fn, bg_model, int(max_iters), float(tol),
                        u_key, params, tuple(loss_args), pre, keep=keep)


def radapt_aux_solve(loss_fn, params, mesh, loss_args: tuple = (),
                     bg_model: Optional[StructuredGridP1] = None,
                     outer_epochs: int = 10, pcg_iters: int = 100,
                     pcg_tol: float = 1e-6, coord_steps: int = 20,
                     coord_lr: float = 1e-7, u_key: str = "u",
                     coord_key: str = "coords"
                     ) -> Tuple[dict, torch.Tensor]:
    """r-adaptivity on unstructured meshes with auxiliary-space inner
    solves: each epoch (1) aux-PCG-solves the displacement system at the
    current node coordinates, then (2) takes ``coord_steps`` Adam steps
    on the coordinates (the unstructured analog of
    ``multigrid.radapt_mg_solve``).

    Only the exact Jacobi diagonal is rebuilt per epoch (the coordinates
    change the stiffness); the background hierarchy and the transfer
    tables come from the initial geometry and lag the moving mesh, which
    sets preconditioner quality only, not the solution.

    ``loss_fn(params, *loss_args)`` with ``params = {u_key, coord_key}``
    must be quadratic in ``params[u_key]`` at fixed coordinates.
    Returns (params, per-epoch energies at the equilibrated states).
    """
    from ..mesh.coloring import color_nodes
    from . import optimizers as _opt
    from .drivers import run_optimizer

    if bg_model is None:
        bg_model = StructuredGridP1(E=10e9, nu=0.3)
    opt_c = _opt.freeze_groups(_opt.adam(coord_lr), [u_key])
    colors = color_nodes(mesh.connectivity, mesh.n_nodes)

    def u_loss(pu, coords, *a):
        return loss_fn({u_key: pu[u_key], coord_key: coords}, *a)

    pre = None
    energies = []
    for _ in range(outer_epochs):
        coords0 = params[coord_key]
        up = {u_key: params[u_key]}
        args = (coords0,) + tuple(loss_args)
        if pre is None:
            pre = build_aux_preconditioner(
                u_loss, up, args, mesh, bg_model=bg_model,
                node_colors=colors, u_key=u_key)
        else:                        # refresh only the exact diagonal
            diag = jacobi_diagonal(u_loss, up, args, colors)[u_key]
            pre = dataclasses.replace(pre, dinv=_guarded_inverse(diag))
        # no plan: an epoch's preconditioner serves one solve
        with annotate("hidenn.aux_pcg_solve"):
            pu, _ = _aux_pcg(u_loss, pre.bg_model or bg_model,
                             int(pcg_iters), float(pcg_tol), u_key, up, args,
                             pre)
        params = {u_key: pu[u_key], coord_key: coords0}
        with torch.no_grad():
            energies.append(loss_fn(params, *loss_args))
        params, _ = run_optimizer(loss_fn, params, opt_c, coord_steps,
                                  tuple(loss_args))
    return params, torch.stack(energies)
