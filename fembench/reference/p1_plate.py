"""Plane-stress total potential energy of linear (P1) triangles, in the
textbook B-matrix form.

For a triangle with corners (x_a, y_a), a = 0, 1, 2, and
det = (x0 - x2)(y1 - y2) - (x1 - x2)(y0 - y2) (twice the signed area),
the shape-function gradients are

    dN/dx = (y1 - y2, y2 - y0, y0 - y1) / det
    dN/dy = (x2 - x1, x0 - x2, x1 - x0) / det,

the strain eps = B u_e (Voigt: eps_xx, eps_yy, gamma_xy) with
u_e = (u0x, u0y, u1x, u1y, u2x, u2y), the plane-stress stiffness
C = E / (1 - nu^2) [[1, nu, 0], [nu, 1, 0], [0, 0, (1 - nu) / 2]], and
the element energy w_e |det| / 2 * eps . C eps / 2 (area times the energy
density, w_e the element's weight, 1 unless given).  A |det| below 1e-12
divides as +-1e-12 (the configuration's guarded determinant), so a
degenerate element gives 0.  The traction t = (t_x, t_y) on the Neumann
edges does the work sum_edges |edge| t . (u_a + u_b) / 2 (exact for
linear edges).  total = strain energy - traction work.

Pinned entries: coordinates of geometric-boundary nodes stay at the
mesh's, and displacements of Dirichlet nodes are 0, whatever the
parameters hold; so their gradients are exactly 0.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from .precision import Precision, round_tf32

_EPS_DET = 1e-12


class P1Plate:
    """The energy of one mesh, on ``device`` in the precision ``prec``."""

    def __init__(self, coords, connectivity, geom_boundary_mask,
                 dirichlet_mask, neumann_edges, E: float, nu: float,
                 traction=(0.0, 0.0), weights=None, prec=None,
                 device="cpu"):
        self.prec = prec or Precision()
        dt, dev = self.prec.dtype, torch.device(device)
        self.coords0 = torch.tensor(np.asarray(coords, np.float64),
                                    dtype=dt, device=dev)
        self.conn = torch.tensor(np.asarray(connectivity, np.int64),
                                 device=dev)
        self.geom = torch.tensor(np.asarray(geom_boundary_mask, bool),
                                 device=dev)[:, None]
        self.dirichlet = torch.tensor(np.asarray(dirichlet_mask, bool),
                                      device=dev)[:, None]
        self.edges = torch.tensor(np.asarray(neumann_edges, np.int64),
                                  device=dev).reshape(-1, 2)
        self.weights = (None if weights is None else torch.tensor(
            np.asarray(weights, np.float64), dtype=dt, device=dev))
        f = E / (1.0 - nu * nu)
        self.C = torch.tensor([[f, f * nu, 0.0], [f * nu, f, 0.0],
                               [0.0, 0.0, f * (1.0 - nu) / 2.0]],
                              dtype=dt, device=dev)
        self.traction = (float(traction[0]), float(traction[1]))

    def pinned(self, coords, u):
        """(coordinates, displacements) with the pins applied."""
        return (torch.where(self.geom, self.coords0, coords),
                torch.where(self.dirichlet, 0.0, u))

    def b_matrices(self, x):
        """(B [Ne, 3, 6], det [Ne]) of the elements' corners x [Ne, 3, 2]."""
        x0, x1, x2 = x[:, 0], x[:, 1], x[:, 2]
        det = ((x0[:, 0] - x2[:, 0]) * (x1[:, 1] - x2[:, 1])
               - (x1[:, 0] - x2[:, 0]) * (x0[:, 1] - x2[:, 1]))
        tiny = det.abs() < _EPS_DET
        safe = torch.where(tiny, torch.where(det < 0, -_EPS_DET, _EPS_DET),
                           det)
        dx = torch.stack([x1[:, 1] - x2[:, 1], x2[:, 1] - x0[:, 1],
                          x0[:, 1] - x1[:, 1]], 1) / safe[:, None]
        dy = torch.stack([x2[:, 0] - x1[:, 0], x0[:, 0] - x2[:, 0],
                          x1[:, 0] - x0[:, 0]], 1) / safe[:, None]
        zero = torch.zeros_like(dx)
        B = torch.stack([
            torch.stack([dx, zero], 2).reshape(-1, 6),      # eps_xx
            torch.stack([zero, dy], 2).reshape(-1, 6),      # eps_yy
            torch.stack([dy, dx], 2).reshape(-1, 6),        # gamma_xy
        ], 1)
        return B, det

    def element_energies(self, x, ue) -> torch.Tensor:
        """[Ne] strain energies of the elements, from their corners'
        coordinates x [Ne, 3, 2] and displacements ue [Ne, 3, 2]."""
        B, det = self.b_matrices(x)
        eps = self.prec.mm(B, ue.reshape(-1, 6, 1))[..., 0]  # [Ne, 3]
        sig = self.prec.mm(eps, self.C)                     # C symmetric
        e = 0.5 * det.abs() * (0.5 * torch.sum(eps * sig, dim=1))
        return e if self.weights is None else self.weights * e

    def strain_energy(self, c, u) -> torch.Tensor:
        return torch.sum(self.element_energies(c[self.conn], u[self.conn]))

    def traction_work(self, c, u) -> torch.Tensor:
        if not self.edges.numel():
            return c.new_zeros(())
        a, b = self.edges[:, 0], self.edges[:, 1]
        ds = torch.linalg.vector_norm(c[b] - c[a], dim=1)
        tx, ty = self.traction
        return torch.sum(ds * 0.5 * (tx * (u[a, 0] + u[b, 0])
                                     + ty * (u[a, 1] + u[b, 1])))

    def energy(self, coords, u) -> torch.Tensor:
        c, uu = self.pinned(coords, u)
        return self.strain_energy(c, uu) - self.traction_work(c, uu)

    def value_and_grads(self, coords, u):
        """(energy, d/d coords, d/d u) at the given parameters."""
        cl = coords.detach().to(self.prec.dtype).requires_grad_(True)
        ul = u.detach().to(self.prec.dtype).requires_grad_(True)
        e = self.energy(cl, ul)
        gc, gu = torch.autograd.grad(e, [cl, ul])
        return e.detach(), gc, gu

    def stiffness(self):
        """(K, f, free): the stiffness matrix over the free displacement
        entries (a sparse CSR tensor, entries in ``prec``'s dtype, TF32
        values under "tf32"), the load vector there, and the free entries'
        mask [2N], at the mesh's coordinates.  K is the strain energy's
        Hessian, assembled from the element matrices w_e |det| / 2 B^T C B;
        f the traction work's gradient."""
        c = self.coords0
        B, det = self.b_matrices(c[self.conn])
        w = 0.5 * det.abs()
        if self.weights is not None:
            w = self.weights * w
        ke = w[:, None, None] * self.prec.mm(
            self.prec.mm(B.transpose(1, 2), self.C), B)     # [Ne, 6, 6]
        dof = torch.stack([2 * self.conn, 2 * self.conn + 1], 2).reshape(-1,
                                                                         6)
        free = ~torch.stack([self.dirichlet[:, 0]] * 2, 1).reshape(-1)
        new = torch.cumsum(free.long(), 0) - 1
        rows = dof[:, :, None].expand(-1, 6, 6).reshape(-1)
        cols = dof[:, None, :].expand(-1, 6, 6).reshape(-1)
        keep = free[rows] & free[cols]
        n = int(free.sum())
        with warnings.catch_warnings():     # sparse tensors are "beta"
            warnings.simplefilter("ignore", UserWarning)
            K = torch.sparse_coo_tensor(
                torch.stack([new[rows[keep]], new[cols[keep]]]),
                ke.reshape(-1)[keep], (n, n)).coalesce()
            vals = K.values()
            if self.prec.name == "tf32":
                vals = round_tf32(vals)
            K = torch.sparse_coo_tensor(K.indices(), vals,
                                        (n, n)).to_sparse_csr()
        ul = torch.zeros_like(c, requires_grad=True)
        (f,) = torch.autograd.grad(self.traction_work(c, ul), ul)
        return K, f.reshape(-1)[free], free

    def gradient_scales(self, coords, u):
        """Per node, the sums of the absolute values of the terms that make
        up each gradient group (every element's and edge's contribution):
        the scale of the rounding error of any floating-point sum of them,
        and so the yardstick of a gradient near equilibrium, where the
        terms cancel.  Returns (coords scale, u scale) [N, 2], 0 at
        pinned entries."""
        c, uu = self.pinned(coords.detach().to(self.prec.dtype),
                            u.detach().to(self.prec.dtype))
        x = c[self.conn].requires_grad_(True)
        ue = uu[self.conn].requires_grad_(True)
        gx, gue = torch.autograd.grad(
            self.element_energies(x, ue).sum(), [x, ue])
        idx = self.conn.reshape(-1)
        sc = torch.zeros_like(c).index_add_(0, idx, gx.abs().reshape(-1, 2))
        su = torch.zeros_like(c).index_add_(0, idx, gue.abs().reshape(-1, 2))
        if self.edges.numel():
            ce = c[self.edges].requires_grad_(True)
            ee = uu[self.edges].requires_grad_(True)
            ds = torch.linalg.vector_norm(ce[:, 1] - ce[:, 0], dim=1)
            tx, ty = self.traction
            w = ds * 0.5 * (tx * ee[..., 0].sum(1) + ty * ee[..., 1].sum(1))
            gce, gee = torch.autograd.grad(w.sum(), [ce, ee])
            idx = self.edges.reshape(-1)
            sc.index_add_(0, idx, gce.abs().reshape(-1, 2))
            su.index_add_(0, idx, gee.abs().reshape(-1, 2))
        return (torch.where(self.geom, 0.0, sc),
                torch.where(self.dirichlet, 0.0, su))
