"""Post-processing / field recovery (port of ``element_centroid_gradients``,
``von_mises_per_element`` and ``displacement_magnitude`` from
``hidenn_fem_tpu/postproc.py``)."""

from __future__ import annotations

import torch

from .mesh.types import TriMesh
from .models.triangle_p1 import TriangleP1
from .ops.elasticity import von_mises_plane_stress

__all__ = ["element_centroid_gradients", "von_mises_per_element",
           "displacement_magnitude"]


def element_centroid_gradients(model: TriangleP1, params,
                               mesh: TriMesh) -> torch.Tensor:
    """grad_u at every element centroid [Ne, 2, 2] (constant per P1
    element)."""
    _, grad_u = model.element_fields(params, mesh)
    return grad_u


def von_mises_per_element(model: TriangleP1, params, mesh: TriMesh,
                          E: float, nu: float) -> torch.Tensor:
    """Per-element plane-stress von Mises stress [Ne]."""
    return von_mises_plane_stress(
        element_centroid_gradients(model, params, mesh), E, nu)


def displacement_magnitude(model: TriangleP1, params, mesh: TriMesh):
    """(per-node ||u|| [N], per-element mean [Ne])."""
    u = model.u_full(params, mesh)
    u_mag = torch.sqrt(torch.sum(u * u, dim=1))
    tri_mean = u_mag[mesh.connectivity.long()].mean(dim=1)
    return u_mag, tri_mean
