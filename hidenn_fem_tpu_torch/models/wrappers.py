"""Reference-style stateful wrappers (port of
``hidenn_fem_tpu/models/wrappers.py``), the migration surface.

The reference drives ``nn.Module`` objects with properties such as
``.grid``, ``.u_full`` and ``.coords`` and calls them directly.  The
port's core is pure init/apply functions over a params dict; these thin
wrappers hold the ``(model, params)`` pair and expose the reference's
surface.  Solvers take the functional core (``wrapper.model``,
``wrapper.params``).

The reference defines ``PiecewiseLinearShapeNN2D`` twice (structured and
triangular; the second shadows the first, quirk E1).  Here they are
``PiecewiseLinearShapeNN2DStructured`` and ``PiecewiseLinearShapeNN2D``
(the triangular one keeps the name the reference resolves to at run
time).  Where the JAX wrappers take a ``seed``, these take a
``torch.Generator`` (a CPU generator seeded 0 when None).
"""

from __future__ import annotations

import numpy as np
import torch

from ..mesh.types import TriMesh
from .bilinear2d import Bilinear2D
from .linear1d import Linear1D
from .triangle_p1 import TriangleP1

__all__ = [
    "PiecewiseLinearShapeNN",
    "PiecewiseLinearShapeNN2DStructured",
    "PiecewiseLinearShapeNN2D",
    "NeumannEdgesWrapper",
    "ConnectivityWrapper",
]


class PiecewiseLinearShapeNN:
    """1D model wrapper (the reference's ``PiecewiseLinearShapeNN``)."""

    def __init__(self, node_coords, r_adapt=False, u0=None, uN=None,
                 device=None):
        self.model, self.params = Linear1D.from_node_coords(
            np.asarray(node_coords), r_adapt=r_adapt, u0=u0, uN=uN,
            device=device)

    @property
    def grid(self):
        return self.model.grid(self.params)

    @property
    def u_full(self):
        return self.model.u_full(self.params)

    def __call__(self, x_eval):
        return self.model.apply(self.params, x_eval)

    forward = __call__


class PiecewiseLinearShapeNN2DStructured:
    """Structured bilinear wrapper (the reference's first
    ``PiecewiseLinearShapeNN2D``, unreachable there by shadowing)."""

    def __init__(self, grid_x, grid_y, boundary_mask_x=None,
                 boundary_mask_y=None, r_adapt=False, u_fixed=None,
                 generator=None, device=None):
        self.model, self.params = Bilinear2D.create(
            np.asarray(grid_x), np.asarray(grid_y),
            boundary_mask_x=boundary_mask_x,
            boundary_mask_y=boundary_mask_y,
            r_adapt=r_adapt, u_fixed=u_fixed, generator=generator,
            device=device)

    @property
    def grid(self):
        return self.model.grid(self.params)

    @property
    def u_full(self):
        return self.model.u_full(self.params)

    def __call__(self, x_eval):
        return self.model.apply(self.params, x_eval)

    forward = __call__


class NeumannEdgesWrapper:
    """Indexable (x_i, x_ip1) view of the Neumann edges' endpoint
    coordinates."""

    def __init__(self, coords, edges):
        self.coords = torch.as_tensor(coords)
        self.edges = torch.as_tensor(edges, device=self.coords.device)

    def __getitem__(self, idx):
        e = self.edges[idx].long()
        return self.coords[e[..., 0]], self.coords[e[..., 1]]

    def __len__(self):
        return int(self.edges.shape[0])


class ConnectivityWrapper:
    """Indexable [3, 2] triangle-vertex view."""

    def __init__(self, coords, connectivity):
        self.coords = torch.as_tensor(coords)
        self.connectivity = torch.as_tensor(connectivity,
                                            device=self.coords.device)

    def __getitem__(self, idx):
        return self.coords[self.connectivity[idx].long()]

    def __len__(self):
        return int(self.connectivity.shape[0])


class PiecewiseLinearShapeNN2D:
    """Triangular P1 wrapper (the definition the reference resolves to
    at run time)."""

    def __init__(self, node_coords, connectivity, boundary_mask=None,
                 dirichlet_mask=None, u_fixed=None, neumann_edges=None,
                 generator=None, device=None):
        self.mesh = TriMesh.from_arrays(
            coords=np.asarray(node_coords),
            connectivity=np.asarray(connectivity),
            geom_boundary_mask=boundary_mask,
            dirichlet_mask=dirichlet_mask,
            neumann_mask=None,
            neumann_edges=neumann_edges,
            device=device,
        )
        self.model = TriangleP1(
            u_fixed=0.0 if u_fixed is None else float(np.asarray(u_fixed)
                                                      .reshape(-1)[0]))
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.params = self.model.init(generator, self.mesh, device=device)

    # ------------------------------------------------ reference properties
    @property
    def Nnodes(self):
        return self.mesh.n_nodes

    @property
    def Nelems(self):
        return self.mesh.n_elements

    @property
    def N_edges(self):
        return self.mesh.n_neumann_edges

    @property
    def connectivity(self):
        return self.mesh.connectivity

    @property
    def neumann_edges(self):
        return self.mesh.neumann_edges

    @property
    def coords(self):
        return self.model.coords(self.params, self.mesh)

    @property
    def u_full(self):
        return self.model.u_full(self.params, self.mesh)

    @property
    def domain_elements(self):
        return ConnectivityWrapper(self.coords, self.mesh.connectivity)

    @property
    def nm_edges(self):
        return NeumannEdgesWrapper(self.coords, self.mesh.neumann_edges)

    # --------------------------------------------------------- forward
    def __call__(self, x_eval, elem_id, edge=False):
        if edge:
            return self.model.apply_edge(
                self.params, self.mesh,
                torch.as_tensor(x_eval).reshape(-1), elem_id)
        return self.model.apply_domain(self.params, self.mesh, x_eval,
                                       elem_id)

    forward = __call__
