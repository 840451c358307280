"""Gather-free P1 elasticity on structured grids (port of
``hidenn_fem_tpu/models/structured_grid.py``).

On a structured grid every element's nodes are fixed index offsets of an
[nx, ny] node lattice, so per-element nodal data are slices and the
energy needs no connectivity gather.  ``StructuredGridP1`` keeps full
r-adaptivity (nodal coordinates are parameters, as in ``TriangleP1``) and
supports holes by masking whole quads (weight-0 quads contribute nothing
to the energy or the gradients).  ``to_trimesh`` emits the equivalent
unstructured ``TriMesh`` (same triangles, same nodes), for the
post-processing of the gather route and for the equality tests.

Triangulation variants (``split``, as ``mesh.structured
.rectangle_tri_zigzag``): "up" splits quad (i, j) into (n00, n10, n11) and
(n00, n11, n01); "down" into (n00, n10, n01) and (n10, n11, n01);
"zigzag" alternates by the parity of i + j + ``zigzag_phase``.

On a CUDA float32 node lattice the domain energy runs the stencil kernels
K6/K7 (``ops/lattice_slab.structured_domain_slab``), else the plain torch
stencil; ``backend`` forces either, as in ``PlaneStressEnergy``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..ops.lattice_energy import face_work, lattice_face
from ..ops.lattice_slab import (lattice_stencil_fwd_plain,
                                structured_domain_slab, structured_stencil)

__all__ = ["StructuredGrid", "StructuredGridP1",
           "generate_structured_grid", "pad_lattice", "pad_lattice_side"]


@dataclasses.dataclass(frozen=True)
class StructuredGrid:
    """Static lattice data ([nx, ny]-shaped tensors).

    Attributes:
      coords: [nx, ny, 2] float32 initial node coordinates.
      geom_boundary_mask / dirichlet_mask: [nx, ny] bool node masks.
      quad_mask: [nx-1, ny-1] float32 1/0, active quads (0 = punched).
      neumann_edge_masks: face -> float32 1/0 segment mask carrying the
        traction: "left"/"right" are [ny-1], "up"/"down" are [nx-1].
      u_dirichlet: optional [nx, ny, 2] prescribed values on Dirichlet
        nodes (None: the model's scalar ``u_fixed``).
      split: triangulation variant ("up" | "down" | "zigzag").
      zigzag_phase: quad (i, j) of a zigzag split uses the "up" diagonal
        when i + j + zigzag_phase is even (``pad_lattice`` shifts it so
        that padding keeps the physical triangulation).
    """

    coords: torch.Tensor
    geom_boundary_mask: torch.Tensor
    dirichlet_mask: torch.Tensor
    quad_mask: torch.Tensor
    neumann_edge_masks: Dict[str, torch.Tensor]
    u_dirichlet: Optional[torch.Tensor] = None
    split: str = "up"
    zigzag_phase: int = 0

    @property
    def neumann_edge_mask(self) -> Optional[torch.Tensor]:
        """The right face's segment mask (the JAX package's alias)."""
        return self.neumann_edge_masks.get("right")

    @property
    def nx(self) -> int:
        return self.coords.shape[0]

    @property
    def ny(self) -> int:
        return self.coords.shape[1]

    @property
    def device(self) -> torch.device:
        return self.coords.device

    @property
    def n_elements(self) -> int:
        """Active triangle count (2 per active quad)."""
        return 2 * int(self.quad_mask.sum())

    def to(self, device) -> "StructuredGrid":
        """A copy with every tensor on ``device``."""
        return dataclasses.replace(
            self, coords=self.coords.to(device),
            geom_boundary_mask=self.geom_boundary_mask.to(device),
            dirichlet_mask=self.dirichlet_mask.to(device),
            quad_mask=self.quad_mask.to(device),
            neumann_edge_masks={f: m.to(device) for f, m in
                                self.neumann_edge_masks.items()},
            u_dirichlet=(None if self.u_dirichlet is None
                         else self.u_dirichlet.to(device)))


def _dilate_inactive(act: np.ndarray, nx: int, ny: int) -> np.ndarray:
    """Nodes adjacent to at least one INACTIVE quad (hole rims)."""
    inact = ~act
    out = np.zeros((nx, ny), bool)
    for di, dj in ((0, 0), (1, 0), (1, 1), (0, 1)):
        out[di:nx - 1 + di, dj:ny - 1 + dj] |= inact
    return out


def generate_structured_grid(
    length: float = 2.0,
    height: float = 1.0,
    holes: Sequence[Tuple[float, float, float]] = (),
    boundaries: Optional[Dict[str, int]] = None,
    nx: int = 100,
    ny: int = 50,
    split: str = "up",
    u_dirichlet=None,
    device=None,
) -> StructuredGrid:
    """Structured-lattice analog of ``mesh.generate_mesh`` (host numpy, the
    same arrays as the JAX package's).

    Holes deactivate every quad with a corner inside a hole.  ``boundaries``
    maps face -> {0: none, 1: Dirichlet, 2: traction}; traction segments
    next to punched quads are masked out.  ``u_dirichlet`` optionally
    prescribes nodal values (scalar or [nx, ny, 2]) on Dirichlet nodes.
    Tensors go to ``device``, the card unless given.
    """
    device = resolve_device(device)
    if split not in ("up", "down", "zigzag"):
        raise ValueError(f"unknown split {split!r}")
    if boundaries is None:
        boundaries = {"up": 0, "down": 0, "right": 2, "left": 1}
    xs = np.linspace(0.0, length, nx)
    ys = np.linspace(0.0, height, ny)
    xv, yv = np.meshgrid(xs, ys, indexing="ij")
    coords = np.stack([xv, yv], axis=-1)

    inside = np.zeros((nx, ny), bool)
    for cx, cy, r in holes:
        inside |= ((xv - cx) ** 2 + (yv - cy) ** 2) <= r * r
    corner_bad = (inside[:-1, :-1] | inside[1:, :-1]
                  | inside[1:, 1:] | inside[:-1, 1:])
    quad_mask = (~corner_bad).astype(np.float32)

    tol = 1e-6
    face = {
        "left": np.abs(xv - 0.0) < tol,
        "right": np.abs(xv - length) < tol,
        "down": np.abs(yv - 0.0) < tol,
        "up": np.abs(yv - height) < tol,
    }
    geom = face["left"] | face["right"] | face["down"] | face["up"]
    # nodes of punched quads next to active ones stay frozen
    act = quad_mask > 0
    touched = np.zeros((nx, ny), bool)
    for di, dj in ((0, 0), (1, 0), (1, 1), (0, 1)):
        touched[di:nx - 1 + di, dj:ny - 1 + dj] |= act
    geom |= inside | (touched & _dilate_inactive(act, nx, ny))

    bc = np.zeros((nx, ny), bool)
    adj_quad = {
        "right": quad_mask[-1, :], "left": quad_mask[0, :],
        "up": quad_mask[:, -1], "down": quad_mask[:, 0],
    }
    mn_masks = {}
    for f, condition in boundaries.items():
        if condition == 1:
            bc |= face[f]
        elif condition == 2:
            mn_masks[f] = torch.tensor(
                (adj_quad[f] > 0).astype(np.float32), device=device)

    ud = None
    if u_dirichlet is not None:
        ud = torch.tensor(np.broadcast_to(
            np.asarray(u_dirichlet, np.float32), (nx, ny, 2)).copy(),
            device=device)

    return StructuredGrid(
        coords=torch.tensor(coords, dtype=torch.float32, device=device),
        geom_boundary_mask=torch.tensor(geom, device=device),
        dirichlet_mask=torch.tensor(bc, device=device),
        quad_mask=torch.tensor(quad_mask, device=device),
        neumann_edge_masks=mn_masks,
        u_dirichlet=ud,
        split=split,
    )


def _face_active(grid: StructuredGrid, face: str) -> bool:
    m = grid.neumann_edge_masks.get(face)
    return m is not None and bool(m.any())


def pad_lattice_side(grid: StructuredGrid) -> str:
    """Which side ``pad_lattice`` adds dead rows on: "prepend" (keeps a
    right-face traction at lattice index -1) or "append" (when the left
    face carries an active traction, which must stay at index 0)."""
    return "append" if _face_active(grid, "left") else "prepend"


def pad_lattice(grid: StructuredGrid, params: Optional[dict],
                multiple: int) -> Tuple[StructuredGrid, Optional[dict]]:
    """Pad the lattice i-axis to a multiple of ``multiple`` with dead rows
    (quads deactivated, coordinates frozen, values pinned), which add
    nothing to the energy or the gradients.  Rows are prepended unless
    the left face carries the traction; tractions on both x-faces cannot
    survive row padding."""
    nx = grid.nx
    k = (-nx) % multiple
    if k == 0:
        return grid, params

    append = pad_lattice_side(grid) == "append"
    if append and _face_active(grid, "right"):
        raise NotImplementedError(
            "pad_lattice cannot pad the row axis with active tractions "
            "on BOTH x-faces; pad the column axis instead (transpose "
            "the grid)")

    def prep(a, fill=None):
        t = torch.as_tensor(a)
        src = t[-1:] if append else t[0:1]
        row = (src.repeat((k,) + (1,) * (t.dim() - 1)) if fill is None
               else torch.full((k,) + tuple(t.shape[1:]), fill,
                               dtype=t.dtype, device=t.device))
        return torch.cat([t, row] if append else [row, t], dim=0)

    def prep_seg(f, m):
        if f in ("up", "down"):    # [nx-1] segment masks grow with rows
            z = torch.zeros(k, dtype=m.dtype, device=m.device)
            return torch.cat([m, z] if append else [z, m])
        return m

    grid2 = StructuredGrid(
        coords=prep(grid.coords),
        geom_boundary_mask=prep(grid.geom_boundary_mask, True),
        dirichlet_mask=prep(grid.dirichlet_mask, True),
        quad_mask=prep(grid.quad_mask, 0.0),
        neumann_edge_masks={f: prep_seg(f, m)
                            for f, m in grid.neumann_edge_masks.items()},
        u_dirichlet=(None if grid.u_dirichlet is None
                     else prep(grid.u_dirichlet)),
        split=grid.split,
        # appended rows keep the quad parities; k prepended rows shift them
        zigzag_phase=(grid.zigzag_phase + (0 if append else k)) % 2,
    )
    params2 = None
    if params is not None:
        params2 = {"coords": prep(params["coords"]),
                   "u": prep(params["u"], 0.0)}
    return grid2, params2


@dataclasses.dataclass(frozen=True)
class StructuredGridP1:
    """Gather-free structured plate model and its plane-stress energy.

    Same parameter semantics as ``TriangleP1`` (full-size masked params):
    ``params = {"coords": [nx, ny, 2], "u": [nx, ny, 2]}``.  ``tractions``
    optionally maps a face to a constant traction (tx, ty); other faces
    carry (F_total / traction_length, 0).  ``backend``: "auto" runs the
    stencil kernels for a float32 lattice on the card and the plain torch
    stencil otherwise; "kernel" forces the kernels (and raises on a CPU
    or float64 tensor); "plain" forces the plain stencil.
    """

    E: float = 10e9
    nu: float = 0.3
    F_total: float = 100e3
    traction_length: float = 1.0
    u_fixed: float = 0.0
    init_scale: float = 1e-5
    dtype: torch.dtype = torch.float32
    tractions: Optional[Dict[str, Tuple[float, float]]] = None
    backend: str = "auto"

    def __post_init__(self):
        if self.backend not in ("auto", "kernel", "plain"):
            raise ValueError(f"unknown backend {self.backend!r}")

    # ---------------------------------------------------------------- init
    def init(self, generator, grid: StructuredGrid, device=None) -> dict:
        """Initial parameters on ``device`` (the card unless given):
        coords at the grid positions and ``init_scale`` * N(0, 1) nodal
        values drawn from ``generator``, a ``torch.Generator`` or a numpy
        ``Generator``."""
        device = resolve_device(device)
        shape = (grid.nx, grid.ny, 2)
        if isinstance(generator, np.random.Generator):
            u0 = torch.tensor(self.init_scale
                              * generator.standard_normal(shape),
                              dtype=self.dtype)
        else:
            u0 = self.init_scale * torch.randn(
                shape, generator=generator, dtype=self.dtype,
                device=generator.device)
        return {"coords": grid.coords.to(device=device, dtype=self.dtype),
                "u": u0.to(device)}

    # ------------------------------------------------------------- getters
    def coords(self, params, grid: StructuredGrid) -> torch.Tensor:
        return torch.where(grid.geom_boundary_mask[..., None],
                           grid.coords.to(self.dtype), params["coords"])

    def u_full(self, params, grid: StructuredGrid) -> torch.Tensor:
        fixed = (grid.u_dirichlet.to(self.dtype)
                 if grid.u_dirichlet is not None else float(self.u_fixed))
        return torch.where(grid.dirichlet_mask[..., None], fixed,
                           params["u"])

    # -------------------------------------------------------------- energy
    def _node(self, params, grid: StructuredGrid) -> torch.Tensor:
        """Packed nodal lattice [nx, ny, 4] (cx, cy, ux, uy), pins
        applied."""
        return torch.cat([self.coords(params, grid),
                          self.u_full(params, grid)], dim=-1)

    def domain_energy(self, params, grid: StructuredGrid) -> torch.Tensor:
        """Elastic strain energy; exact (constant-strain) integration."""
        return self._domain_from_node(self._node(params, grid), grid)

    def _use_kernel(self, node: torch.Tensor) -> bool:
        on_card = node.is_cuda and node.dtype == torch.float32
        if self.backend == "kernel" and not on_card:
            raise ValueError("backend='kernel' needs float32 tensors on "
                             f"the card, got {node.dtype} on {node.device}")
        return self.backend == "kernel" or (self.backend == "auto"
                                            and on_card)

    def _domain_from_node(self, node, grid: StructuredGrid) -> torch.Tensor:
        if self._use_kernel(node):
            return structured_domain_slab(node, grid.quad_mask, grid.split,
                                          grid.zigzag_phase, self.E,
                                          self.nu)
        # the plain stencil: w_sum = 0.5 (the triangle rule's weight sum)
        # times sum(quad_mask * (E(T1) + E(T2)))
        return lattice_stencil_fwd_plain(
            node.reshape(grid.nx * grid.ny, 4), grid.nx, grid.ny, self.E,
            self.nu, 0.5, **structured_stencil(grid.quad_mask, grid.split,
                                               grid.zigzag_phase,
                                               node.dtype))

    def edge_energy(self, params, grid: StructuredGrid) -> torch.Tensor:
        """Constant-traction work on the active edge segments of any face
        (exact for linear edge elements)."""
        return self._edge_from_node(self._node(params, grid), grid)

    def _edge_from_node(self, node, grid: StructuredGrid) -> torch.Tensor:
        t_default = (self.F_total / self.traction_length, 0.0)
        work = node.new_zeros(())
        for f, mask in grid.neumann_edge_masks.items():
            tx, ty = (self.tractions or {}).get(f, t_default)
            work = face_work(lambda face, k: lattice_face(node, face, k),
                             {f: mask}, tx, ty, work)
        return work

    def total(self, params, grid: StructuredGrid) -> torch.Tensor:
        node = self._node(params, grid)   # shared by both terms
        return self._domain_from_node(node, grid) - self._edge_from_node(
            node, grid)

    __call__ = total

    # --------------------------------------------------------- conversion
    def to_trimesh(self, grid: StructuredGrid, device=None):
        """The equivalent unstructured TriMesh (active triangles only, the
        same nodes flattened i*ny + j), on ``device`` (the card unless
        given)."""
        from ..mesh.types import TriMesh

        nx, ny = grid.nx, grid.ny
        coords = grid.coords.cpu().numpy().reshape(-1, 2)
        i, j = np.meshgrid(np.arange(nx - 1), np.arange(ny - 1),
                           indexing="ij")
        i, j = i.ravel(), j.ravel()
        n00 = i * ny + j
        n10 = (i + 1) * ny + j
        n01 = i * ny + (j + 1)
        n11 = (i + 1) * ny + (j + 1)
        up1 = np.stack([n00, n10, n11], 1)
        up2 = np.stack([n00, n11, n01], 1)
        dn1 = np.stack([n00, n10, n01], 1)
        dn2 = np.stack([n10, n11, n01], 1)
        if grid.split == "up":
            t1, t2 = up1, up2
        elif grid.split == "down":
            t1, t2 = dn1, dn2
        else:
            even = ((i + j + grid.zigzag_phase) % 2 == 0)[:, None]
            t1 = np.where(even, up1, dn1)
            t2 = np.where(even, up2, dn2)
        cells = np.stack([t1, t2], axis=1).reshape(-1, 3)
        active = np.repeat(grid.quad_mask.cpu().numpy().ravel() > 0, 2)
        cells = cells[active]

        face_nodes = {
            "right": (nx - 1) * ny + np.arange(ny),
            "left": np.arange(ny),
            "up": np.arange(nx) * ny + (ny - 1),
            "down": np.arange(nx) * ny,
        }
        mn_mask = np.zeros(nx * ny, bool)
        all_edges = []
        for f, m in grid.neumann_edge_masks.items():
            em = m.cpu().numpy() > 0
            line = face_nodes[f]
            e = np.stack([line[:-1], line[1:]], axis=1)[em]
            all_edges.append(e)
            mn_mask[e.ravel()] = True
        edges = (np.concatenate(all_edges, axis=0) if all_edges
                 else np.zeros((0, 2), np.int64))

        return TriMesh.from_arrays(
            coords=coords,
            connectivity=cells,
            geom_boundary_mask=grid.geom_boundary_mask.cpu().numpy().ravel(),
            dirichlet_mask=grid.dirichlet_mask.cpu().numpy().ravel(),
            neumann_mask=mn_mask,
            neumann_edges=np.sort(edges, axis=1),
            device=device,
        )
