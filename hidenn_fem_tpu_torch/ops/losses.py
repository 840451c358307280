"""Variational losses (port of ``hidenn_fem_tpu/ops/losses.py``): the L2
projection loss, the 1D bar energy, and the plane-stress total potential
energy with ``mesh_quality_penalty``.

``bar_energy_1d`` takes du/dx as the partial in x of the model's forward
(``autograd.grad`` with ``create_graph``, the JAX package's ``jax.jvp``),
so the outer gradient reaches the params through the quadrature points
as well; ``differentiable_geometry=False`` is the reference's detach of
the quadrature geometry (quirk E5).

``total`` tries the routes in the JAX package's order: the gather-free
lattice route when the mesh carries a ``LatticeRoute``
(``ops/lattice_energy.py``, with the stencil kernels of
``ops/lattice_slab.py`` on the card), then the hybrid lattice + collar
route (``mesh/hybrid.py``), then the fused edges (never on a mesh with
banded tables), then domain - edge.  The domain term of a mesh with banded
tables runs on the banded route (``ops/banded_energy.py``, kernels K3-K5
on the card, the paired tables preferred); other meshes take the gather
route (``ops/element_energy.py``), or the general quadrature path.  The
reference quirks live behind ``compat="reference"`` as in the JAX
package:

E3  the edge rule takes the raw [-1, 1] Gauss points as edge coordinates;
E7  the order-4 triangle rule is double-scaled (weights sum to 0.25);
E8  the body force receives reference-triangle coordinates.
(E9, the Jacobian-transpose quirk, is the model's: ``TriangleP1``.)
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

from ..device import constant, resolve_device
from ..mesh.types import TriMesh
from ..models.linear1d import _value_and_dx
from ..models.triangle_p1 import TriangleP1
from . import quadrature as quad
from . import banded_energy
from .assembly import flat_gather, gather_banded, gather_with_incidence
from .elasticity import energy_density, plane_stress_C, \
    strain_voigt_from_grad
from .element_energy import element_energy, element_energy_plain
from .lattice_energy import (collar_energy, lattice_body_work,
                             lattice_domain_energy, lattice_total)
from .lattice_slab import lattice_total_slab, slab_supported

__all__ = ["l2_loss", "bar_energy_1d", "PlaneStressEnergy", "route_counts",
           "mesh_quality_penalty"]

# energies of the routes that launch no kernel of the port, which no
# launch counter sees: "hybrid" counts each energy ``_hybrid_total``
# returns (a replay of a captured body moves it as the recorded call did,
# ``solve/loop.py``'s ``_counters``)
route_counts = {"hybrid": 0}


def mesh_quality_penalty(model, params, mesh) -> torch.Tensor:
    """Mean element shape-quality penalty: per triangle, the sum of
    squared edge lengths over 4 sqrt(3) area (1 for an equilateral
    triangle, diverging as it degenerates)."""
    v = flat_gather(model.coords(params, mesh), mesh.connectivity)
    e0 = v[:, 1] - v[:, 0]
    e1 = v[:, 2] - v[:, 1]
    e2 = v[:, 0] - v[:, 2]
    l2 = (e0 * e0).sum(1) + (e1 * e1).sum(1) + (e2 * e2).sum(1)
    det, _ = model.element_fields(params, mesh)
    area = 0.5 * det.abs()
    q = l2 / torch.clamp(4.0 * math.sqrt(3.0) * area, min=1e-30)
    return q.mean()


# --------------------------------------------------------------------- L2
def l2_loss(model, params, x, u_true) -> torch.Tensor:
    """Mean-squared collocation loss (the L2-projection objective of
    examples 1 and 2)."""
    pred = model.apply(params, x)
    return torch.mean((pred - u_true) ** 2)


# ----------------------------------------------------------------- 1D bar
def bar_energy_1d(model, params, n_gauss: int, b_force: Callable,
                  E: float, differentiable_geometry: bool = True
                  ) -> torch.Tensor:
    """Total potential energy of a 1D bar, sum_q w_q (0.5 E u'^2 - b u),
    by the [-1, 1] Gauss rule mapped onto each element.

    Args:
      differentiable_geometry: if True (default) r-adaptivity gradients
        flow through the quadrature map; if False, reproduce the
        reference's detach (quirk E5).
    """
    grid = model.grid(params)
    xi, wi = (constant(tuple(a), model.dtype, grid.device)
              for a in quad._leggauss(n_gauss))
    if not differentiable_geometry:
        grid = grid.detach()
    x_i = grid[:-1, None]                    # [n_elem, 1]
    x_ip1 = grid[1:, None]
    xq = 0.5 * (x_ip1 - x_i) * xi + 0.5 * (x_ip1 + x_i)   # [n_elem, ng]
    wq = 0.5 * (x_ip1 - x_i) * wi
    u, du_dx = _value_and_dx(lambda x: model.apply(params, x), xq)
    total = 0.5 * E * du_dx ** 2 - b_force(xq) * u
    return torch.sum(wq * total)


_HOST = torch.device("cpu")


def _on_device(t: torch.Tensor, device=None) -> torch.Tensor:
    """A small host table on ``device`` (the card unless given), copied
    there once (``constant``) and not on every call: a copy from pageable
    host memory synchronizes, which a captured optimizer step may not."""
    return constant(tuple(t.reshape(-1).tolist()), t.dtype,
                    resolve_device(device)).view(t.shape)


@dataclasses.dataclass(frozen=True)
class PlaneStressEnergy:
    """Plane-stress total potential energy for the P1 triangle model:
    ``total = domain - edge`` (+ the optional mesh-quality penalty).

    Args:
      model: the TriangleP1 static config.
      E, nu: Young's modulus / Poisson ratio.
      gauss_order / gauss_order_1d: quadrature orders.
      F_total, traction_length: the default uniform +x traction
        t = (F_total / traction_length, 0).
      body_force / traction: optional callables x [M, 2] -> [M, 2].
      assembly: "fused" (one Jacobian per element, the quadrature
        collapses to the weight sum) or "quadrature" (the model evaluated
        at every quadrature point, like the reference).
      compat: "exact" or "reference" (quirks E3/E7/E8).
      backend: "auto" runs the CUDA kernels for float32 tensors on the
        card and the plain torch version on the CPU or for float64;
        "kernel" forces the kernels (and raises on a CPU tensor, or on a
        lattice route the stencil kernels do not take); "plain" forces
        the plain version.  The lattice route's stencil kernels take
        identity-numbered routes (``lattice_slab.slab_supported``); a
        renumbered route runs the plain lattice route under "auto", and
        so do a body force and a custom traction under any backend, as
        in the JAX package.  On a mesh with banded tables, "auto" and
        "kernel" run the banded route for float32 (its kernels on the
        card, their plain versions on the CPU, as the JAX package's
        interpret mode does); "plain", float64 and a body force take
        the plain banded gather (``gather_banded``), or with a body force
        on the card K1/K2 over ``mesh.connectivity``.
      mesh_penalty_weight: weight of ``mesh_quality_penalty`` (0: off).
      fuse_edges: fold the Neumann traction work into the element energy
        as (n0, n1, n1) pseudo-elements (``mesh.fused_connectivity``).
    """

    model: TriangleP1
    E: float = 10e9
    nu: float = 0.3
    gauss_order: int = 4
    gauss_order_1d: int = 2
    F_total: float = 100e3
    traction_length: float = 1.0
    body_force: Optional[Callable] = None
    traction: Optional[Callable] = None
    assembly: str = "fused"
    compat: str = "exact"
    backend: str = "auto"
    mesh_penalty_weight: float = 0.0
    fuse_edges: bool = False

    def __post_init__(self):
        if self.assembly not in ("fused", "quadrature"):
            raise ValueError(f"unknown assembly mode {self.assembly!r}")
        if self.compat not in ("exact", "reference"):
            raise ValueError(f"unknown compat mode {self.compat!r}")
        if self.backend not in ("auto", "kernel", "plain"):
            raise ValueError(f"unknown backend {self.backend!r}")

    def _resolve_backend(self, node: torch.Tensor) -> str:
        if self.backend == "kernel":
            if not node.is_cuda or node.dtype != torch.float32:
                raise ValueError("backend='kernel' needs float32 tensors "
                                 f"on the card, got {node.dtype} on "
                                 f"{node.device}")
            return "kernel"
        if self.backend == "plain":
            return "plain"
        return ("kernel" if node.is_cuda and node.dtype == torch.float32
                else "plain")

    # ------------------------------------------------------------- tables
    def C(self, device=None) -> torch.Tensor:
        return _on_device(plane_stress_C(self.E, self.nu,
                                         dtype=self.model.dtype,
                                         device=_HOST), device)

    def _domain_rule(self, device=None):
        pts, w = quad.triangle_gauss_points(self.gauss_order,
                                            dtype=self.model.dtype,
                                            device=_HOST)
        if self.compat == "reference" and self.gauss_order == 4:
            w = 0.5 * w  # quirk E7: reference double-scales the 4-pt rule
        return _on_device(pts, device), _on_device(w, device)

    def _edge_rule(self, device=None):
        # quirk E3 (reference): raw [-1,1] points used as edge coordinates
        rule = (quad.interval_gauss_points_m11 if self.compat == "reference"
                else quad.interval_gauss_points)
        return tuple(_on_device(t, device) for t in rule(
            self.gauss_order_1d, dtype=self.model.dtype, device=_HOST))

    def _default_traction(self, x: torch.Tensor) -> torch.Tensor:
        t_x = torch.full((x.shape[0],), self.F_total / self.traction_length,
                         dtype=x.dtype, device=x.device)
        return torch.stack([t_x, torch.zeros_like(t_x)], dim=1)

    def _body_work_gathered(self, g: torch.Tensor, pts: torch.Tensor,
                            w: torch.Tensor) -> torch.Tensor:
        """Body-force work sum_e |detJ_e| sum_q w_q b(x_q).u(x_q) from
        gathered corners g [rows, 3, 4], at physical points."""
        v0, v1, v2 = g[:, 0, :], g[:, 1, :], g[:, 2, :]
        det = ((v0[:, 0] - v2[:, 0]) * (v1[:, 1] - v2[:, 1])
               - (v1[:, 0] - v2[:, 0]) * (v0[:, 1] - v2[:, 1]))
        xi = pts[None, :, 0, None]                     # [1, ng, 1]
        eta = pts[None, :, 1, None]
        lam = 1.0 - xi - eta
        xq = (xi * v0[:, None, 0:2] + eta * v1[:, None, 0:2]
              + lam * v2[:, None, 0:2])               # [rows, ng, 2]
        uq = (xi * v0[:, None, 2:4] + eta * v1[:, None, 2:4]
              + lam * v2[:, None, 2:4])
        b = self.body_force(xq.reshape(-1, 2)).reshape(uq.shape)
        return torch.sum(det.abs()
                         * torch.sum(w[None, :] * torch.sum(b * uq, dim=2),
                                     dim=1))

    # ------------------------------------------------------------- domain
    def domain_energy(self, params, mesh: TriMesh) -> torch.Tensor:
        """Elastic strain energy minus body-force work.

        A mesh with banded tables takes the banded route (paired tables
        preferred; either table set is enough).  With a body force, the
        JAX package gathers through the triangle tables and runs K1 on
        the gathered rows; on the card the port runs K1 over
        ``mesh.connectivity`` instead: the same elements, since the
        tables' padding rows contribute exactly 0."""
        if self.assembly == "fused" and self.compat == "exact" \
                and self.model.dim_u == 2:
            node = self.model.packed_nodes(params, mesh)
            w_sum = quad.triangle_weight_sum(self.gauss_order)
            backend = self._resolve_backend(node)
            ba = (mesh.banded_paired if mesh.banded_paired is not None
                  else mesh.banded)
            if (ba is not None and self.body_force is None
                    and self.backend != "plain"
                    and node.dtype == torch.float32):
                return banded_energy.banded_element_energy(
                    node, ba, self.E, self.nu, w_sum)
            if backend == "kernel":
                elastic = element_energy(node, mesh.connectivity,
                                         mesh.incidence, self.E, self.nu,
                                         w_sum)
                g = None
            else:
                g = (gather_banded(node, mesh.banded)
                     if mesh.banded is not None
                     else self._gather(node, mesh.connectivity,
                                       mesh.incidence))
                elastic = element_energy_plain(g, self.E, self.nu, w_sum)
            if self.body_force is None:
                return elastic
            if g is None:
                g = self._gather(node, mesh.connectivity, mesh.incidence)
            # the quadrature tables go to the device only here: a copy
            # from the host synchronizes
            pts, w = self._domain_rule(node.device)
            return elastic - self._body_work_gathered(g, pts, w)

        # general quadrature path: the reference's hot loop shape (also
        # taken for compat="reference", where the quirks live)
        device = mesh.device
        pts, w = self._domain_rule(device)
        ng = w.shape[0]
        n_elem = mesh.n_elements
        x_ref = pts.repeat(n_elem, 1)                       # [Ne*ng, 2]
        elem_id = torch.arange(n_elem, device=device).repeat_interleave(ng)
        qw = w.repeat(n_elem)
        u_q, det, grad_u = self.model.apply_domain(params, mesh, x_ref,
                                                   elem_id)
        eps = strain_voigt_from_grad(grad_u)
        dens = energy_density(eps, self.C(device))
        qw = qw * det.abs()
        elastic = torch.sum(qw * dens)
        if self.body_force is None:
            return elastic
        b = self.body_force(self._quad_points(params, mesh, x_ref, elem_id))
        return elastic - torch.sum(qw * torch.sum(b * u_q, dim=1))

    @staticmethod
    def _gather(node, conn, incidence):
        if incidence is not None:
            return gather_with_incidence(node, conn, incidence)
        return flat_gather(node, conn)

    def _quad_points(self, params, mesh, x_ref, elem_id) -> torch.Tensor:
        """Physical quadrature points (reference coords under compat,
        quirk E8)."""
        if self.compat == "reference":
            return x_ref
        coords = self.model.coords(params, mesh)
        v = flat_gather(coords, mesh.connectivity[elem_id])   # [M, 3, 2]
        xi = x_ref[:, 0:1]
        eta = x_ref[:, 1:2]
        return xi * v[:, 0] + eta * v[:, 1] + (1.0 - xi - eta) * v[:, 2]

    # --------------------------------------------------------------- edge
    def edge_energy(self, params, mesh: TriMesh) -> torch.Tensor:
        """Neumann traction work (exactly 0 with no Neumann edges)."""
        n_edges = mesh.n_neumann_edges
        if n_edges == 0:
            return torch.zeros((), dtype=self.model.dtype,
                               device=mesh.device)

        if (self.traction is None and self.compat == "exact"
                and self.assembly == "fused"):
            # uniform traction on linear edges, integrated analytically:
            # t_x (u0x + u1x) / 2 ds
            en = flat_gather(self.model.packed_nodes(params, mesh),
                             mesh.neumann_edges)
            dx = en[:, 1, 0] - en[:, 0, 0]
            dy = en[:, 1, 1] - en[:, 0, 1]
            ds = torch.sqrt(dx * dx + dy * dy)
            t_x = self.F_total / self.traction_length
            return t_x * torch.sum(ds * 0.5 * (en[:, 0, 2] + en[:, 1, 2]))

        device = mesh.device
        xi, w = self._edge_rule(device)
        ng = w.shape[0]
        xi_flat = xi.repeat(n_edges)                          # [E*ng]
        edge_id = torch.arange(n_edges, device=device).repeat_interleave(ng)
        wq = w.repeat(n_edges)
        u_edge, ds = self.model.apply_edge(params, mesh, xi_flat, edge_id)
        xq = self.model.edge_points(params, mesh, xi_flat, edge_id)
        t = (self.traction or self._default_traction)(xq)
        return torch.sum(torch.sum(u_edge * t, dim=1) * wq * ds)

    # -------------------------------------------------------------- total
    def _fused_total(self, params, mesh: TriMesh):
        """Domain + edge energy as one element energy over
        ``mesh.fused_connectivity`` (edges as (n0, n1, n1) columns past
        ``n_elements`` with traction weight -t_x), or None when the
        configuration can't use it.  A mesh with banded tables (either
        set) keeps its banded route, as in the JAX package."""
        if (not self.fuse_edges
                or self.assembly != "fused" or self.compat != "exact"
                or self.traction is not None or self.body_force is not None
                or self.model.dim_u != 2
                or mesh.fused_connectivity is None
                or mesh.banded is not None
                or mesh.banded_paired is not None):
            return None
        node = self.model.packed_nodes(params, mesh)
        t_x = self.F_total / self.traction_length
        w_sum = quad.triangle_weight_sum(self.gauss_order)
        # total = domain - traction work, hence the negative edge weight
        if self._resolve_backend(node) == "kernel":
            return element_energy(node, mesh.fused_connectivity,
                                  mesh.fused_incidence, self.E, self.nu,
                                  w_sum, mesh.n_elements, -t_x)
        g = gather_with_incidence(node, mesh.fused_connectivity,
                                  mesh.fused_incidence)
        return element_energy_plain(g, self.E, self.nu, w_sum,
                                    mesh.n_elements, -t_x)

    def _lattice_total(self, params, mesh: TriMesh):
        """Gather-free route for lattice-detected meshes (or None): the
        whole energy from [nx, ny] node-lattice slices.  A body force
        rides the route (``lattice_body_work``); a custom traction keeps
        the domain on it and evaluates the edge term generically."""
        if (mesh.lattice is None or self.assembly != "fused"
                or self.compat != "exact" or self.model.dim_u != 2
                or getattr(self.model, "compat", "exact") != "exact"):
            return None
        node = self.model.packed_nodes(params, mesh)
        if self.traction is None:
            return self._lattice_total_node(node, mesh)
        w_sum = quad.triangle_weight_sum(self.gauss_order)
        e = lattice_domain_energy(node, mesh.lattice, self.E, self.nu,
                                  w_sum)
        if self.body_force is not None:
            pts, w = self._domain_rule(node.device)
            e = e - lattice_body_work(node, mesh.lattice, self.body_force,
                                      pts, w)
        return e - self.edge_energy(params, mesh)

    def total_from_nodes(self, node, mesh: TriMesh) -> torch.Tensor:
        """Energy as a function of the packed [N, 4] node table (pins
        already applied), for lattice-routable configurations only."""
        if self.mesh_penalty_weight:
            raise ValueError("node-space energy does not carry the "
                             "mesh-quality penalty (it needs params)")
        e = self._lattice_total_node(node, mesh)
        if e is None:
            raise ValueError("total_from_nodes requires a lattice-"
                             "routable configuration (lattice mesh, "
                             "fused assembly, exact compat, default "
                             "traction)")
        return e

    def _hybrid_total(self, params, mesh: TriMesh):
        """Slice + gather route for hybrid lattice+collar meshes (or
        None): the node-table-prefix lattice by ``lattice_total`` (the
        plain lattice route: the JAX package runs no stencil kernel
        here either), the collar by ``collar_energy``."""
        if (mesh.hybrid is None or self.assembly != "fused"
                or self.compat != "exact" or self.model.dim_u != 2
                or getattr(self.model, "compat", "exact") != "exact"):
            return None
        hy = mesh.hybrid
        node = self.model.packed_nodes(params, mesh)
        w_sum = quad.triangle_weight_sum(self.gauss_order)
        if self.traction is None:
            t_x = self.F_total / self.traction_length
            e = lattice_total(node, hy.lattice, self.E, self.nu, w_sum, t_x)
        else:
            # custom traction: the domain stays on the route, the
            # O(boundary) edge term evaluates generically
            e = (lattice_domain_energy(node, hy.lattice, self.E, self.nu,
                                       w_sum)
                 - self.edge_energy(params, mesh))
        pts = w = None
        if self.body_force is not None:
            pts, w = self._domain_rule(node.device)
            e = e - lattice_body_work(node, hy.lattice, self.body_force,
                                      pts, w)
        if hy.extra_conn.shape[0]:
            e = e + collar_energy(node, hy, self.E, self.nu, w_sum,
                                  body_force=self.body_force, pts=pts, w=w)
        route_counts["hybrid"] += 1
        return e

    def _lattice_total_node(self, node, mesh: TriMesh):
        if (mesh.lattice is None or self.assembly != "fused"
                or self.compat != "exact" or self.traction is not None
                or self.model.dim_u != 2
                or getattr(self.model, "compat", "exact") != "exact"):
            return None
        route = mesh.lattice
        w_sum = quad.triangle_weight_sum(self.gauss_order)
        t_x = self.F_total / self.traction_length
        backend = self._resolve_backend(node)
        if self.body_force is not None:
            # body-force work from the same lattice slices; the stencil
            # kernels do not carry it
            pts, w = self._domain_rule(node.device)
            return (lattice_total(node, route, self.E, self.nu, w_sum, t_x)
                    - lattice_body_work(node, route, self.body_force,
                                        pts, w))
        if backend == "kernel":
            if slab_supported(route, node.dtype):
                return lattice_total_slab(node, route, self.E, self.nu,
                                          w_sum, t_x)
            if self.backend == "kernel":
                raise ValueError("backend='kernel' needs an identity-"
                                 "numbered lattice route (the stencil "
                                 "kernels take no permutation fill)")
        return lattice_total(node, route, self.E, self.nu, w_sum, t_x)

    def total(self, params, mesh: TriMesh) -> torch.Tensor:
        """Total potential = domain - edge, plus the optional mesh-quality
        regularization."""
        e = self._lattice_total(params, mesh)
        if e is None:
            e = self._hybrid_total(params, mesh)
        if e is None:
            e = self._fused_total(params, mesh)
        if e is None:
            e = self.domain_energy(params, mesh) - self.edge_energy(
                params, mesh)
        if self.mesh_penalty_weight:
            e = e + self.mesh_penalty_weight * mesh_quality_penalty(
                self.model, params, mesh)
        return e

    __call__ = total
