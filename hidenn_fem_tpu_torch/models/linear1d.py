"""1D piecewise-linear FE interpolant (port of
``hidenn_fem_tpu/models/linear1d.py``).

* parameters: a dict with the free nodal values ``u`` and, with
  ``r_adapt``, the positive inter-node increments ``x_increments`` that
  reparameterize the grid (softplus -> clip(1e-6) -> cumsum -> rescale to
  [x0, xN]), so the grid stays monotone;
* Dirichlet values u0/uN live in the static config and are concatenated
  into ``u_full``;
* forward: ``searchsorted`` element locate on the detached grid and hat
  functions with an epsilon guard on the element length.

Autograd gives both gradient groups (d/du, d/d increments) of any loss of
``apply``; ``du_dx`` is the partial derivative in x by
``torch.autograd.grad`` with ``create_graph``, so an outer gradient still
flows through the points and the params.

The JAX conventions kept, so that gradients agree with the JAX package's
(``jax.nn.softplus`` is ``logaddexp(x, 0)``, and ``jnp.clip`` splits the
gradient 1/2-1/2 at a tie, where ``torch.clamp`` passes it whole):
``_softplus`` and ``_clip_min``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..device import constant, resolve_device

__all__ = ["Linear1D"]

_EPS_SEG = 1e-10  # element-length division guard
_EPS_INC = 1e-6   # increment positivity floor


def _inv_softplus(y: np.ndarray) -> np.ndarray:
    """Inverse of softplus, stable for small and large y (host init)."""
    y = np.asarray(y, dtype=np.float64)
    return y + np.log(-np.expm1(-y))


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0) (torch's ``softplus`` turns
    into x above its threshold of 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _clip_min(x: torch.Tensor, m: float) -> torch.Tensor:
    """``jnp.clip(x, min=m)``: max(x, m), whose gradient is 1 above m, 0
    below and 1/2 at a tie (x + m = 2x exactly, so the value is x)."""
    m = torch.full_like(x, m)
    return torch.where(x > m, x, torch.where(x == m, 0.5 * (x + m), m))


def _value_and_dx(f, x: torch.Tensor):
    """(f(x), df/dx) for an elementwise f, the partial in x only: an
    outer gradient flows through ``x`` and f's other inputs (the JAX
    package's ``jax.jvp`` with ones)."""
    outer = torch.is_grad_enabled()
    with torch.enable_grad():
        xg = x if x.requires_grad else x.detach().requires_grad_(True)
        u = f(xg)
        (d,) = torch.autograd.grad(u, xg, torch.ones_like(u),
                                   create_graph=outer)
    if not outer:
        return u.detach(), d
    return u, d


@dataclasses.dataclass(frozen=True)
class Linear1D:
    """Static configuration of a 1D piecewise-linear interpolant.

    Attributes:
      n_nodes: number of grid nodes N.
      x0, xN: fixed endpoint coordinates.
      r_adapt: if True, interior node positions are trainable through the
        positive-increment reparameterization.
      u0, uN: fixed Dirichlet values at the endpoints; None leaves the
        nodal value trainable.
      dtype: compute dtype.
      x_inner: fixed interior coordinates of a non-adaptive, non-uniform
        grid; None means uniform linspace(x0, xN, n_nodes).
    """

    n_nodes: int
    x0: float
    xN: float
    r_adapt: bool = False
    u0: Optional[float] = None
    uN: Optional[float] = None
    dtype: torch.dtype = torch.float32
    x_inner: Optional[tuple] = None

    # ---------------------------------------------------------------- init
    @classmethod
    def from_node_coords(cls, node_coords, r_adapt=False, u0=None, uN=None,
                         dtype=torch.float32, device=None):
        """(model, params) from explicit node coordinates, params on
        ``device`` (the card unless given).

        Uniform grids take the raw-diff increment init
        (``init_reference_compat``): the reference's choice, which keeps
        example 1's optimization trajectory; other grids the
        inverse-softplus init, which keeps the initial geometry exactly.
        """
        node_coords = np.asarray(node_coords, dtype=np.float64)
        adaptive = r_adapt and node_coords.shape[0] > 2
        uniform = np.allclose(
            node_coords,
            np.linspace(node_coords[0], node_coords[-1], node_coords.shape[0]),
        )
        model = cls(
            n_nodes=int(node_coords.shape[0]),
            x0=float(node_coords[0]),
            xN=float(node_coords[-1]),
            r_adapt=r_adapt,
            u0=u0,
            uN=uN,
            dtype=dtype,
            x_inner=None if (adaptive or uniform)
            else tuple(float(v) for v in node_coords[1:-1]),
        )
        if uniform:
            return model, model.init_reference_compat(node_coords,
                                                      device=device)
        return model, model.init(node_coords, device=device)

    @property
    def n_free_u(self) -> int:
        n = self.n_nodes
        if self.u0 is not None:
            n -= 1
        if self.uN is not None:
            n -= 1
        return n

    @property
    def adaptive(self) -> bool:
        return self.r_adapt and self.n_nodes > 2

    def _init(self, node_coords, increments, device) -> dict:
        if node_coords is None:
            node_coords = np.linspace(self.x0, self.xN, self.n_nodes)
        node_coords = np.asarray(node_coords, dtype=np.float64)
        device = resolve_device(device)
        params = {"u": torch.zeros((self.n_free_u,), dtype=self.dtype,
                                   device=device)}
        if self.adaptive:
            params["x_increments"] = torch.tensor(
                increments(np.diff(node_coords)), dtype=self.dtype,
                device=device)
        return params

    def init(self, node_coords=None, device=None) -> dict:
        """Initial params: ``u`` zero and, with r-adaptivity, increments
        that reproduce ``node_coords`` exactly (inverse softplus of the
        spacing)."""
        return self._init(
            node_coords,
            lambda d: _inv_softplus(np.maximum(d, 2 * _EPS_INC)), device)

    def init_reference_compat(self, node_coords=None, device=None) -> dict:
        """The reference's init: raw increments = the spacing, so the
        initial grid is the softplus-warped one."""
        return self._init(node_coords, lambda d: d, device)

    # ------------------------------------------------------------- getters
    def grid(self, params) -> torch.Tensor:
        """Current node coordinates [N], monotone by construction."""
        dev = params["u"].device
        if self.adaptive:
            x0, xN = constant((self.x0, self.xN), self.dtype, dev)
            inc = _clip_min(_softplus(params["x_increments"]), _EPS_INC)
            cum = torch.cumsum(inc, dim=0)
            return torch.cat([x0[None], x0 + (xN - x0) * cum / cum[-1]])
        if self.x_inner is not None:
            return constant((self.x0,) + self.x_inner + (self.xN,),
                            self.dtype, dev)
        return torch.linspace(self.x0, self.xN, self.n_nodes,
                              dtype=self.dtype, device=dev)

    def u_full(self, params) -> torch.Tensor:
        """All nodal values [N] with the Dirichlet ends baked in."""
        u = params["u"].reshape(-1)
        parts = []
        if self.u0 is not None:
            parts.append(torch.full((1,), self.u0, dtype=self.dtype,
                                    device=u.device))
        parts.append(u)
        if self.uN is not None:
            parts.append(torch.full((1,), self.uN, dtype=self.dtype,
                                    device=u.device))
        return torch.cat(parts) if len(parts) > 1 else u

    # ------------------------------------------------------------- forward
    def apply(self, params, x_eval) -> torch.Tensor:
        """u_h at ``x_eval`` (any shape); returns the same shape.

        The element index comes from the detached grid (``side="left"``,
        minus 1, clipped to [0, N-2]); values and derivatives flow through
        the gathered endpoints, so d/dx, d/du and d/d increments are
        exact."""
        x = torch.as_tensor(x_eval, dtype=self.dtype,
                            device=params["u"].device)
        shape = x.shape
        x = x.reshape(-1)
        grid = self.grid(params)
        idx = torch.searchsorted(grid.detach().contiguous(),
                                 x.detach().contiguous(), side="left") - 1
        idx = idx.clamp(0, self.n_nodes - 2)

        x_i = grid[idx]
        x_ip1 = grid[idx + 1]
        u_full = self.u_full(params)
        u_i = u_full[idx]
        u_ip1 = u_full[idx + 1]

        seg = _clip_min(x_ip1 - x_i, _EPS_SEG)
        n1 = (x_ip1 - x) / seg
        n2 = (x - x_i) / seg
        return (u_i * n1 + u_ip1 * n2).reshape(shape)

    __call__ = apply

    def du_dx(self, params, x_eval) -> torch.Tensor:
        """du_h/dx at ``x_eval`` (piecewise constant), the partial in x."""
        x = torch.as_tensor(x_eval, dtype=self.dtype,
                            device=params["u"].device)
        return _value_and_dx(lambda xx: self.apply(params, xx), x)[1]
