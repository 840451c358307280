"""2D structured (tensor-product) bilinear FE interpolant (port of
``hidenn_fem_tpu/models/bilinear2d.py``).

* separable grids grid_x [Nx], grid_y [Ny], each with the positive-increment
  r-adaptivity reparameterization of ``Linear1D``;
* per-axis boundary masks pin boundary coordinates to their initial values;
  the 2D node mask is the row-OR-column union;
* nodal values ``u`` [Nx, Ny] (N(0, 1) init from a ``torch.Generator``),
  with an optional scalar ``u_fixed`` on the node mask;
* forward: per-axis searchsorted locate, 4-corner gather, bilinear blend.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..device import constant, resolve_device
from .linear1d import (_EPS_INC, _EPS_SEG, _clip_min, _inv_softplus,
                       _softplus, _value_and_dx)

__all__ = ["Bilinear2D"]


@dataclasses.dataclass(frozen=True)
class Bilinear2D:
    """Static config for the structured bilinear interpolant."""

    nx: int
    ny: int
    x0: float
    xN: float
    y0: float
    yN: float
    r_adapt: bool = False
    u_fixed: Optional[float] = None
    # the initial grids, to which boundary coordinates stay pinned
    initial_grid_x: tuple = ()
    initial_grid_y: tuple = ()
    # per-axis boundary masks as tuples of bool
    boundary_mask_x: tuple = ()
    boundary_mask_y: tuple = ()
    dtype: torch.dtype = torch.float32

    # ---------------------------------------------------------------- init
    @classmethod
    def create(cls, grid_x, grid_y, boundary_mask_x=None,
               boundary_mask_y=None, r_adapt=False, u_fixed=None,
               dtype=torch.float32, generator=None, device=None):
        """(model, params), params on ``device`` (the card unless given)
        with ``u`` drawn from ``generator`` (a CPU generator seeded 0 when
        None)."""
        gx = np.asarray(grid_x, dtype=np.float64).reshape(-1)
        gy = np.asarray(grid_y, dtype=np.float64).reshape(-1)
        nx, ny = gx.shape[0], gy.shape[0]
        if boundary_mask_x is None:
            boundary_mask_x = np.zeros(nx, bool)
            boundary_mask_x[[0, -1]] = True
        if boundary_mask_y is None:
            boundary_mask_y = np.zeros(ny, bool)
            boundary_mask_y[[0, -1]] = True
        model = cls(
            nx=nx, ny=ny,
            x0=float(gx[0]), xN=float(gx[-1]),
            y0=float(gy[0]), yN=float(gy[-1]),
            r_adapt=r_adapt, u_fixed=u_fixed,
            initial_grid_x=tuple(map(float, gx)),
            initial_grid_y=tuple(map(float, gy)),
            boundary_mask_x=tuple(map(bool, boundary_mask_x)),
            boundary_mask_y=tuple(map(bool, boundary_mask_y)),
            dtype=dtype,
        )
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        return model, model.init(generator, device=device)

    @property
    def adaptive(self) -> bool:
        return self.r_adapt and max(self.nx, self.ny) > 2

    def init(self, generator: torch.Generator, device=None) -> dict:
        """N(0, 1) nodal values from ``generator`` and the increment
        params: uniform axes take the raw-diff init (the reference's),
        non-uniform axes the inverse-softplus init (exact geometry)."""
        device = resolve_device(device)
        u = torch.randn((self.nx, self.ny), generator=generator,
                        dtype=self.dtype, device=generator.device)
        params = {"u": u.to(device)}
        if self.adaptive:
            for axis, grid in (("x", self.initial_grid_x),
                               ("y", self.initial_grid_y)):
                g = np.asarray(grid)
                diffs = np.maximum(np.diff(g), 2 * _EPS_INC)
                uniform = np.allclose(g, np.linspace(g[0], g[-1], g.size))
                raw = diffs if uniform else _inv_softplus(diffs)
                params[f"increments_{axis}"] = torch.tensor(
                    raw, dtype=self.dtype, device=device)
        return params

    # ------------------------------------------------------------- getters
    def _axis_grid(self, incr, g0, gN, initial, bmask):
        dev = incr.device
        g0, gN = constant((g0, gN), self.dtype, dev)
        inc = _clip_min(_softplus(incr), _EPS_INC)
        cum = torch.cumsum(inc, dim=0)
        full = torch.cat([g0[None], g0 + (gN - g0) * cum / cum[-1]])
        # pin the boundary-mask coordinates to their initial positions
        return torch.where(constant(bmask, torch.bool, dev),
                           constant(initial, self.dtype, dev), full)

    def grid(self, params):
        """Current (grid_x [Nx], grid_y [Ny])."""
        if self.adaptive:
            gx = self._axis_grid(params["increments_x"], self.x0, self.xN,
                                 self.initial_grid_x, self.boundary_mask_x)
            gy = self._axis_grid(params["increments_y"], self.y0, self.yN,
                                 self.initial_grid_y, self.boundary_mask_y)
            return gx, gy
        dev = params["u"].device
        return (constant(self.initial_grid_x, self.dtype, dev),
                constant(self.initial_grid_y, self.dtype, dev))

    def node_mask(self, device=None):
        """2D boundary-node mask [Nx, Ny] = row OR column boundary (on
        ``device``, the card unless given)."""
        device = resolve_device(device)
        bx = constant(self.boundary_mask_x, torch.bool, device)
        by = constant(self.boundary_mask_y, torch.bool, device)
        return bx[:, None] | by[None, :]

    def u_full(self, params):
        """Nodal values [Nx, Ny] with the fixed boundary value applied."""
        u = params["u"]
        if self.u_fixed is not None:
            return torch.where(self.node_mask(u.device),
                               torch.full_like(u, self.u_fixed), u)
        return u

    # ------------------------------------------------------------- forward
    def apply(self, params, x_eval):
        """u_h at points x_eval [M, 2] -> [M]."""
        x_eval = torch.as_tensor(x_eval, dtype=self.dtype,
                                 device=params["u"].device)
        grid_x, grid_y = self.grid(params)
        px, py = x_eval[:, 0], x_eval[:, 1]
        ix = (torch.searchsorted(grid_x.detach().contiguous(),
                                 px.detach().contiguous(), side="left")
              - 1).clamp(0, self.nx - 2)
        iy = (torch.searchsorted(grid_y.detach().contiguous(),
                                 py.detach().contiguous(), side="left")
              - 1).clamp(0, self.ny - 2)

        x_i, x_ip1 = grid_x[ix], grid_x[ix + 1]
        y_i, y_ip1 = grid_y[iy], grid_y[iy + 1]

        u = self.u_full(params)
        u00 = u[ix, iy]
        u10 = u[ix + 1, iy]
        u01 = u[ix, iy + 1]
        u11 = u[ix + 1, iy + 1]

        hx = _clip_min(x_ip1 - x_i, _EPS_SEG)
        hy = _clip_min(y_ip1 - y_i, _EPS_SEG)
        n1x = (x_ip1 - px) / hx
        n2x = (px - x_i) / hx
        n1y = (y_ip1 - py) / hy
        n2y = (py - y_i) / hy
        return n1x * n1y * u00 + n2x * n1y * u10 + n1x * n2y * u01 \
            + n2x * n2y * u11

    __call__ = apply

    def grad_u(self, params, x_eval):
        """(du/dx, du/dy) at x_eval [M, 2] -> [M, 2], the partials in the
        point (an outer gradient flows through the params)."""
        x = torch.as_tensor(x_eval, dtype=self.dtype,
                            device=params["u"].device)
        return _value_and_dx(lambda xx: self.apply(params, xx), x)[1]
