"""Post-processing and field recovery (port of
``hidenn_fem_tpu/postproc.py``): per-element gradients, von Mises stress,
displacement magnitudes, the 1D per-element derivative, and point
location and evaluation on the triangular model.

``locate_points`` finds the triangle that holds each physical point.  The
JAX package asks matplotlib's trapezoid-map finder; the port needs no
matplotlib (the card's machine has none): it buckets the elements'
bounding boxes on a uniform grid and tests each point against the
triangles of its bucket with the barycentric formula, in torch on the
device of the coordinates.  The contract is the JAX package's.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .device import resolve_device
from .mesh.types import TriMesh
from .models.triangle_p1 import TriangleP1
from .ops.elasticity import von_mises_plane_stress

__all__ = ["element_centroid_gradients", "von_mises_per_element",
           "displacement_magnitude", "derivative_1d_per_element",
           "locate_points", "evaluate_at_points"]

# barycentric slack of the inside test: points on an edge or a vertex
# belong to a triangle that holds them, whatever the rounding
_BARY_SLACK = 1e-12


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


def _barycentric(v: torch.Tensor, pts: torch.Tensor):
    """(xi, eta) of points [M, 2] in triangles v [M, 3, 2]:
    x = v2 + J [xi, eta]^T with J = [v0 - v2 | v1 - v2] (the model's
    convention: vertex 0 -> xi, vertex 1 -> eta)."""
    d = pts - v[:, 2]
    ax = v[:, 0, 0] - v[:, 2, 0]
    ay = v[:, 0, 1] - v[:, 2, 1]
    bx = v[:, 1, 0] - v[:, 2, 0]
    by = v[:, 1, 1] - v[:, 2, 1]
    det = ax * by - bx * ay
    det = torch.where(det.abs() < 1e-300, torch.full_like(det, 1e-300), det)
    xi = (by * d[:, 0] - bx * d[:, 1]) / det
    eta = (-ay * d[:, 0] + ax * d[:, 1]) / det
    return xi, eta


def locate_points(coords, connectivity, points, device=None):
    """Physical points [M, 2] -> (elem_id [M] int64, ref [M, 2] float64):
    the triangle that holds each point and its (xi, eta) there, in the
    model's shape-function convention.  Points outside the mesh (and in
    its holes) get elem_id -1; their ``ref`` is taken in element 0, as
    the JAX package's.

    The triangles' bounding boxes are binned on a uniform grid of about
    one cell per element; each point is tested against the triangles of
    its cell, and of those that hold it the one where it lies deepest
    (the largest smallest barycentric coordinate) is taken.  Runs in
    float64 on ``device``; left out, on the device of ``coords`` when it
    is a tensor, else on the card; returns tensors on that device.
    """
    if device is None and isinstance(coords, torch.Tensor):
        dev = coords.device
    else:
        dev = resolve_device(device)

    def tensor(a, dtype):
        if isinstance(a, torch.Tensor):
            return a.detach().to(device=dev, dtype=dtype)
        return torch.tensor(np.asarray(a), dtype=dtype, device=dev)

    xy = tensor(coords, torch.float64)
    conn = tensor(connectivity, torch.long)
    pts = tensor(points, torch.float64).reshape(-1, 2)
    ne, m = conn.shape[0], pts.shape[0]

    v = xy[conn]                                          # [Ne, 3, 2]
    lo = v.min(dim=1).values
    hi = v.max(dim=1).values
    box_lo = lo.min(dim=0).values
    span = (hi.max(dim=0).values - box_lo).clamp_min(1e-300)
    h = (math.sqrt(float(span[0] * span[1]) / max(ne, 1))
         or float(span.max()))
    shape = [max(1, min(int(math.ceil(float(span[a]) / h)), 1 << 15))
             for a in (0, 1)]
    cells = torch.tensor(shape, device=dev)

    def cell(p):
        c = torch.floor((p - box_lo) / span * cells).long()
        return torch.minimum(c.clamp_min(0), cells - 1)

    # element -> every cell its bounding box touches, as (cell, element)
    # pairs sorted by cell (a CSR table of the grid)
    c0, c1 = cell(lo), cell(hi)
    nc = c1 - c0 + 1                                       # [Ne, 2]
    per = nc[:, 0] * nc[:, 1]
    elem = torch.repeat_interleave(torch.arange(ne, device=dev), per)
    first = torch.cumsum(per, 0) - per
    k = torch.arange(elem.shape[0], device=dev) - first[elem]
    cx = c0[elem, 0] + k // nc[elem, 1]
    cy = c0[elem, 1] + k % nc[elem, 1]
    key = cx * shape[1] + cy
    key, order = torch.sort(key, stable=True)
    elem = elem[order]
    counts = torch.bincount(key, minlength=shape[0] * shape[1])
    start = torch.cumsum(counts, 0) - counts

    pc = cell(pts)
    pkey = pc[:, 0] * shape[1] + pc[:, 1]
    n_cand = counts[pkey]
    p_start = start[pkey]
    elem_id = torch.full((m,), -1, dtype=torch.long, device=dev)
    best = torch.full((m,), -_BARY_SLACK, dtype=torch.float64, device=dev)
    for j in range(int(n_cand.max()) if m else 0):
        act = torch.nonzero(n_cand > j).squeeze(1)
        e = elem[p_start[act] + j]
        xi, eta = _barycentric(v[e], pts[act])
        score = torch.minimum(torch.minimum(xi, eta), 1.0 - xi - eta)
        take = score > best[act]
        best[act] = torch.where(take, score, best[act])
        elem_id[act] = torch.where(take, e, elem_id[act])

    xi, eta = _barycentric(v[elem_id.clamp_min(0)], pts)
    return elem_id, torch.stack([xi, eta], dim=1)


def evaluate_at_points(model: TriangleP1, params, mesh: TriMesh, points):
    """Field values u_h at physical points [M, 2] -> [M, dim_u], NaN
    outside the mesh: ``locate_points`` on the current coordinates, then
    the model's reference-coordinate interpolation."""
    coords = model.coords(params, mesh)
    elem_id, ref = locate_points(coords, mesh.connectivity, points)
    inside = elem_id >= 0
    u = model.interpolate(params, mesh, ref.to(model.dtype),
                          elem_id.clamp_min(0))
    return torch.where(inside[:, None], u, torch.full_like(u, math.nan))


def derivative_1d_per_element(model, params) -> torch.Tensor:
    """Per-element du/dx of a 1D model [n_elem], in one batched
    derivative at the element midpoints."""
    grid = model.grid(params)
    mid = 0.5 * (grid[:-1] + grid[1:])
    return model.du_dx(params, mid)
