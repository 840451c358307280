"""Node-space solves: iterate on the packed [N, 4] node table directly
(port of ``hidenn_fem_tpu/solve/nodespace.py``).

The params-space energy rebuilds the node table every step: two
Dirichlet selects and the coords/u concatenation of ``packed_nodes``,
and their transposes in the backward.  For a solve those passes do
nothing, since the fixed entries never change.  This module bakes the
boundary conditions into the node table once, masks their gradients
with an identity-forward ``grad_gate`` (so the optimizer never moves
them), and runs the drivers on the node table itself.

The params-space gradient is the masked node gradient (the chain rule
through ``where(mask, fixed, free)`` is the mask multiply), so node-space
L-BFGS follows the params-space trajectory up to float reassociation.
Lattice-routable energies only (``PlaneStressEnergy.total_from_nodes``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .drivers import run_lbfgs

__all__ = ["grad_gate", "node_free_mask", "lbfgs_node_space"]


class _GradGate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mask):
        ctx.save_for_backward(mask)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        (mask,) = ctx.saved_tensors
        return ct * mask, None


def grad_gate(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Identity forward; the backward multiplies the cotangent by
    ``mask`` (and gives ``mask`` no gradient)."""
    return _GradGate.apply(x, mask)


def node_free_mask(model, mesh) -> torch.Tensor:
    """[N, 4] 0/1 mask of the free node-table entries: coords columns
    free off the geometric boundary, u columns off the Dirichlet set."""
    cfree = ~mesh.geom_boundary_mask
    ufree = ~mesh.dirichlet_mask
    return torch.stack([cfree, cfree, ufree, ufree],
                       dim=1).to(model.dtype)


def lbfgs_node_space(energy, params, mesh, num_steps: int = 600,
                     tol: Optional[float] = None, **kwargs
                     ) -> Tuple[dict, torch.Tensor]:
    """L-BFGS on the node table; returns (params-shaped solution,
    losses) like ``minimize(method="lbfgs")``.

    The returned ``coords``/``u`` carry the pinned values at fixed
    entries (params space leaves whatever the initial params held there;
    both evaluate identically through the model's selects).
    """
    with torch.no_grad():
        node0 = energy.model.packed_nodes(params, mesh).contiguous()
    mask = node_free_mask(energy.model, mesh)

    def loss(node, mask, mesh):
        return energy.total_from_nodes(grad_gate(node, mask), mesh)

    node_sol, losses = run_lbfgs(loss, node0, num_steps=num_steps, tol=tol,
                                 loss_args=(mask, mesh), **kwargs)
    return ({"coords": node_sol[:, :2], "u": node_sol[:, 2:]}, losses)
