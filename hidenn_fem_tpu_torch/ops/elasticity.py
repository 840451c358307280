"""Plane-stress constitutive algebra (port of
``hidenn_fem_tpu/ops/elasticity.py``)."""

from __future__ import annotations

import torch

__all__ = [
    "plane_stress_C",
    "strain_voigt_from_grad",
    "stress_from_strain",
    "energy_density",
    "von_mises_plane_stress",
]


def plane_stress_C(E: float, nu: float, dtype=torch.float32,
                   device=None) -> torch.Tensor:
    """Plane-stress constitutive matrix C [3, 3]."""
    f = E / (1.0 - nu ** 2)
    return torch.tensor([[f, f * nu, 0.0],
                         [f * nu, f, 0.0],
                         [0.0, 0.0, f * (1.0 - nu) / 2.0]],
                        dtype=dtype, device=device)


def strain_voigt_from_grad(grad_u: torch.Tensor) -> torch.Tensor:
    """Voigt strain [eps_xx, eps_yy, 2 eps_xy] [.., 3] from grad_u
    [.., 2, 2], with grad_u[i, j] = d u_i / d x_j."""
    return torch.stack([grad_u[..., 0, 0], grad_u[..., 1, 1],
                        grad_u[..., 0, 1] + grad_u[..., 1, 0]], dim=-1)


def stress_from_strain(eps_voigt: torch.Tensor,
                       C: torch.Tensor) -> torch.Tensor:
    """sigma = eps @ C^T, in full precision (TF32 is off package-wide)."""
    return eps_voigt @ C.T


def energy_density(eps_voigt: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """Elastic energy density 0.5 * eps : sigma."""
    return 0.5 * torch.sum(eps_voigt * stress_from_strain(eps_voigt, C),
                           dim=-1)


def von_mises_plane_stress(grad_u: torch.Tensor, E: float,
                           nu: float) -> torch.Tensor:
    """sigma_vm = sqrt(sxx^2 - sxx syy + syy^2 + 3 sxy^2) from grad_u."""
    eps_xx = grad_u[..., 0, 0]
    eps_yy = grad_u[..., 1, 1]
    eps_xy = 0.5 * (grad_u[..., 0, 1] + grad_u[..., 1, 0])
    f = E / (1.0 - nu ** 2)
    sxx = f * (eps_xx + nu * eps_yy)
    syy = f * (eps_yy + nu * eps_xx)
    sxy = E / (1.0 + nu) * eps_xy
    return torch.sqrt(sxx ** 2 - sxx * syy + syy ** 2 + 3.0 * sxy ** 2)
