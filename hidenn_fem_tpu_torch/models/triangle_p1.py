"""Unstructured P1-triangle FE interpolant (port of
``hidenn_fem_tpu/models/triangle_p1.py``).

Parameters are a dict ``{"coords": [N, 2], "u": [N, 2]}``: full-size
tensors whose pinned entries (geometric-boundary coordinates, Dirichlet
values) are replaced with ``torch.where`` against the mesh masks, so
pinned entries get exactly zero gradients.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..device import constant, resolve_device
from ..mesh.types import TriMesh
from ..ops.assembly import flat_gather

__all__ = ["TriangleP1"]

_EPS_DET = 1e-12  # detJ division guard; healthy meshes are unaffected


@dataclasses.dataclass(frozen=True)
class TriangleP1:
    """Static config for the P1 triangular model.

    Attributes:
      dim_u: field components (2 for plane elasticity).
      u_fixed: prescribed value on Dirichlet nodes (scalar, [dim_u] or
        [N, dim_u]).
      init_scale: stddev of the random nodal-value init.
      dtype: compute dtype.
      compat: "exact" (dN/dx = J^{-T} D_N) or "reference" (the
        reference's Jacobian-transpose quirk E9, J^{-1} D_N).
    """

    dim_u: int = 2
    u_fixed: float = 0.0
    init_scale: float = 1e-5
    dtype: torch.dtype = torch.float32
    compat: str = "exact"

    # ---------------------------------------------------------------- init
    def init(self, generator: torch.Generator, mesh: TriMesh,
             device=None) -> dict:
        """Initial parameters on ``device`` (the card unless given):
        coords at the mesh positions and ``init_scale`` * N(0, 1) nodal
        values drawn from ``generator``."""
        device = resolve_device(device)
        u0 = self.init_scale * torch.randn(
            (mesh.n_nodes, self.dim_u), generator=generator,
            dtype=self.dtype, device=generator.device)
        return {"coords": mesh.coords.to(device=device, dtype=self.dtype),
                "u": u0.to(device)}

    # ------------------------------------------------------------- getters
    def coords(self, params, mesh: TriMesh) -> torch.Tensor:
        """Node coordinates [N, 2], geometric-boundary nodes pinned."""
        return torch.where(mesh.geom_boundary_mask[:, None],
                           mesh.coords.to(self.dtype), params["coords"])

    def u_full(self, params, mesh: TriMesh) -> torch.Tensor:
        """Nodal field [N, dim_u], Dirichlet nodes pinned to u_fixed."""
        u = params["u"]
        if isinstance(self.u_fixed, (int, float)):
            # a Python scalar reaches the device as a kernel argument,
            # with no host-to-device copy (which would synchronize)
            fixed = float(self.u_fixed)
        elif isinstance(self.u_fixed, torch.Tensor) \
                and self.u_fixed.device == u.device:
            fixed = torch.broadcast_to(self.u_fixed.to(self.dtype),
                                       (mesh.n_nodes, self.dim_u))
        else:
            # host values: copied to the device once (``constant``), not
            # on every call, so a captured step holds no host copy
            host = np.asarray(self.u_fixed.cpu() if isinstance(
                self.u_fixed, torch.Tensor) else self.u_fixed, np.float64)
            fixed = torch.broadcast_to(
                constant(tuple(host.ravel().tolist()), self.dtype,
                         u.device).view(host.shape),
                (mesh.n_nodes, self.dim_u))
        return torch.where(mesh.dirichlet_mask[:, None], fixed, u)

    def packed_nodes(self, params, mesh: TriMesh) -> torch.Tensor:
        """All nodal data as one [N, 4] table (cx, cy, ux, uy) with both
        pins applied: one row read per element corner."""
        return torch.cat([self.coords(params, mesh),
                          self.u_full(params, mesh)], dim=1)

    # ----------------------------------------------------- element algebra
    @staticmethod
    def _jacobian(v0, v1, v2):
        """detJ and row-major J^{-1} entries for J = [v0-v2 | v1-v2]."""
        ax = v0[..., 0] - v2[..., 0]
        ay = v0[..., 1] - v2[..., 1]
        bx = v1[..., 0] - v2[..., 0]
        by = v1[..., 1] - v2[..., 1]
        det = ax * by - bx * ay
        eps = torch.full_like(det, _EPS_DET)
        safe = torch.where(det.abs() < _EPS_DET,
                           torch.where(det < 0, -eps, eps), det)
        inv = 1.0 / safe
        # J^{-1} = [[by, -bx], [-ay, ax]] / det
        return det, (by * inv, -bx * inv, -ay * inv, ax * inv)

    def _dN_dx(self, jinv):
        """Shape-function gradients ((dN/dx), (dN/dy)) for a in {0,1,2};
        ``compat="reference"`` uses the columns of J^{-1} (quirk E9)."""
        i00, i01, i10, i11 = jinv
        if self.compat == "reference":
            dN0x, dN1x = i00, i01
            dN0y, dN1y = i10, i11
        else:
            dN0x, dN1x = i00, i10
            dN0y, dN1y = i01, i11
        return ((dN0x, dN1x, -(dN0x + dN1x)),
                (dN0y, dN1y, -(dN0y + dN1y)))

    def _grad_u(self, v, u_nodes):
        det, jinv = self._jacobian(v[:, 0], v[:, 1], v[:, 2])
        (dN0x, dN1x, dN2x), (dN0y, dN1y, dN2y) = self._dN_dx(jinv)
        gx = (u_nodes[:, 0] * dN0x[:, None] + u_nodes[:, 1] * dN1x[:, None]
              + u_nodes[:, 2] * dN2x[:, None])      # [M, dim_u] = d/dx
        gy = (u_nodes[:, 0] * dN0y[:, None] + u_nodes[:, 1] * dN1y[:, None]
              + u_nodes[:, 2] * dN2y[:, None])      # [M, dim_u] = d/dy
        return det, torch.stack([gx, gy], dim=2)    # [M, dim_u, 2]

    # ------------------------------------------------------------- forward
    def apply_domain(self, params, mesh: TriMesh, x_ref, elem_id
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Evaluate at reference coords x_ref [M, 2] inside elements
        elem_id [M]: (u_h [M, dim_u], detJ [M], grad_u [M, dim_u, 2])."""
        x_ref = torch.as_tensor(x_ref, dtype=self.dtype, device=mesh.device)
        elem_id = torch.as_tensor(elem_id, device=mesh.device).long()
        conn = mesh.connectivity[elem_id]
        v = flat_gather(self.coords(params, mesh), conn)     # [M, 3, 2]
        u_nodes = flat_gather(self.u_full(params, mesh), conn)
        xi = x_ref[:, 0:1]
        eta = x_ref[:, 1:2]
        # barycentric blend with node order (xi, eta, 1-xi-eta)
        u_h = (xi * u_nodes[:, 0] + eta * u_nodes[:, 1]
               + (1.0 - xi - eta) * u_nodes[:, 2])
        det, grad_u = self._grad_u(v, u_nodes)
        return u_h, det, grad_u

    def element_fields(self, params, mesh: TriMesh
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per-element (detJ [Ne], grad_u [Ne, dim_u, 2]); P1 strain is
        constant per element."""
        conn = mesh.connectivity
        v = flat_gather(self.coords(params, mesh), conn)
        u_nodes = flat_gather(self.u_full(params, mesh), conn)
        return self._grad_u(v, u_nodes)

    def interpolate(self, params, mesh: TriMesh, x_ref, elem_id
                    ) -> torch.Tensor:
        """u_h [M, dim_u] at reference coords x_ref [M, 2] inside elements
        elem_id [M] (no Jacobian work)."""
        x_ref = torch.as_tensor(x_ref, dtype=self.dtype, device=mesh.device)
        elem_id = torch.as_tensor(elem_id, device=mesh.device).long()
        u_nodes = self.u_full(params, mesh)[
            mesh.connectivity[elem_id].long()]             # [M, 3, dim_u]
        xi = x_ref[:, 0:1]
        eta = x_ref[:, 1:2]
        return (xi * u_nodes[:, 0] + eta * u_nodes[:, 1]
                + (1.0 - xi - eta) * u_nodes[:, 2])

    def apply_edge(self, params, mesh: TriMesh, xi, edge_id
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Evaluate on Neumann edges at xi in [0, 1]:
        (u_h [M, dim_u], ds [M] edge lengths)."""
        xi = torch.as_tensor(xi, dtype=self.dtype,
                             device=mesh.device).reshape(-1)
        edge_id = torch.as_tensor(edge_id, device=mesh.device).long()
        coords = self.coords(params, mesh)
        edges = mesh.neumann_edges[edge_id]
        u_nodes = flat_gather(self.u_full(params, mesh), edges)
        u_h = ((1.0 - xi)[:, None] * u_nodes[:, 0]
               + xi[:, None] * u_nodes[:, 1])
        d = coords[edges[:, 1].long()] - coords[edges[:, 0].long()]
        ds = torch.sqrt(d[:, 0] ** 2 + d[:, 1] ** 2)
        return u_h, ds

    def edge_points(self, params, mesh: TriMesh, xi, edge_id
                    ) -> torch.Tensor:
        """Physical coordinates of edge reference points."""
        xi = torch.as_tensor(xi, dtype=self.dtype,
                             device=mesh.device).reshape(-1)
        edge_id = torch.as_tensor(edge_id, device=mesh.device).long()
        coords = self.coords(params, mesh)
        edges = mesh.neumann_edges[edge_id].long()
        return ((1.0 - xi)[:, None] * coords[edges[:, 0]]
                + xi[:, None] * coords[edges[:, 1]])

    # --------------------------------------------------------- diagnostics
    def min_abs_detJ(self, params, mesh: TriMesh) -> torch.Tensor:
        """min |detJ| over elements (degeneracy watch)."""
        det, _ = self.element_fields(params, mesh)
        return det.abs().min()
