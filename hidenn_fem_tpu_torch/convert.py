"""Inputs of the JAX package, as numpy arrays, turned into the port's.

The port never imports JAX; these take anything ``np.asarray`` reads
(numpy arrays, or the JAX package's arrays), so one numpy mesh and one set
of numpy params can feed both packages.
"""

from __future__ import annotations

import numpy as np
import torch

from .mesh.types import TriMesh

__all__ = ["params_from_numpy", "mesh_from_numpy"]


def params_from_numpy(params_np: dict, device=None,
                      dtype=torch.float32) -> dict:
    """{"coords": [N, 2], "u": [N, 2], ...} as tensors on ``device``."""
    return {k: torch.tensor(np.asarray(v), dtype=dtype, device=device)
            for k, v in params_np.items()}


def mesh_from_numpy(mesh, device=None, dtype=torch.float32) -> TriMesh:
    """``TriMesh.from_arrays`` on the six arrays of a mesh object (for
    example the JAX package's ``TriMesh``)."""
    return TriMesh.from_arrays(
        np.asarray(mesh.coords), np.asarray(mesh.connectivity),
        np.asarray(mesh.geom_boundary_mask), np.asarray(mesh.dirichlet_mask),
        np.asarray(mesh.neumann_mask), np.asarray(mesh.neumann_edges),
        dtype=dtype, device=device)
