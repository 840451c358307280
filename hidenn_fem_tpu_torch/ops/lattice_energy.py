"""Gather-free energy of lattice-detected TriMeshes (port of
``hidenn_fem_tpu/ops/lattice_energy.py``), in plain torch.

When ``mesh.lattice`` is present (``mesh/lattice.py``) the energy is
computed from slices of the [nx, ny, 4] node lattice instead of a
connectivity gather:

* identity numbering (hole-free meshes, or ``keep_dead_nodes=True``): the
  lattice is a reshape of the node table;
* renumbered meshes (holes delete nodes): one N-row permutation gather
  fills the lattice (``_perm_fill``), whose backward is also a gather;
* prefix-identity numbering (the hybrid meshes): a slice.

The numerics are the P1 constant-strain element energy of the gather
route up to reassociation.  On a CUDA float32 identity route the energy
runs the stencil kernels of ``ops/lattice_slab.py`` instead.  The hybrid
meshes' collar of irregular triangles (``mesh/hybrid.py``) adds
``collar_energy`` (``extra_elements_energy`` is its generic reference).
"""

from __future__ import annotations

import torch

from .assembly import flat_gather, gather_with_incidence
from .element_energy import _abs_jax

__all__ = ["lattice_total", "lattice_domain_energy", "lattice_body_work",
           "body_work_from_lat", "extra_elements_energy", "collar_energy"]


class _PermFill(torch.autograd.Function):
    """[N, 4] node table -> [nx*ny, 4] lattice rows through the injective
    position maps; deleted positions read an appended zeros row."""

    @staticmethod
    def forward(ctx, node, inv_map, fwd_map):
        ctx.save_for_backward(fwd_map)
        pad = torch.cat([node, node.new_zeros((1, node.shape[1]))], dim=0)
        return pad.index_select(0, inv_map.long())

    @staticmethod
    def backward(ctx, ct):
        # every node occupies exactly one lattice position, so the fill's
        # transpose is itself a gather (no scatter-add, no atomics)
        (fwd_map,) = ctx.saved_tensors
        return ct.index_select(0, fwd_map.long()), None, None


def _perm_fill(node, inv_map, fwd_map):
    return _PermFill.apply(node, inv_map, fwd_map)


def _tri_energy(v0, v1, v2, f, nu):
    """|detJ| x the P1 plane-stress energy density of one triangle family,
    from corner slices [..., 4] = (cx, cy, ux, uy)."""
    ax = v0[..., 0] - v2[..., 0]
    ay = v0[..., 1] - v2[..., 1]
    bx = v1[..., 0] - v2[..., 0]
    by = v1[..., 1] - v2[..., 1]
    d0x = v0[..., 2] - v2[..., 2]
    d0y = v0[..., 3] - v2[..., 3]
    d1x = v1[..., 2] - v2[..., 2]
    d1y = v1[..., 3] - v2[..., 3]
    det = ax * by - bx * ay
    eps = torch.full_like(det, 1e-12)
    safe = torch.where(det.abs() < 1e-12, torch.where(det < 0, -eps, eps),
                       det)
    inv = 1.0 / safe
    exx = (by * d0x - ay * d1x) * inv
    eyy = (-bx * d0y + ax * d1y) * inv
    gxy = ((by * d0y - ay * d1y) + (-bx * d0x + ax * d1x)) * inv
    dens = 0.5 * (f * (exx * exx + eyy * eyy + 2 * nu * exx * eyy)
                  + f * (1 - nu) / 2 * gxy * gxy)
    return _abs_jax(det) * dens


def _lat(node: torch.Tensor, route) -> torch.Tensor:
    """Node table [N, 4] -> [nx, ny, 4] lattice."""
    if route.identity:
        full = node
    elif route.prefix_identity:
        full = node[:route.nx * route.ny]
    else:
        full = _perm_fill(node, route.inv_map, route.fwd_map)
    return full.reshape(route.nx, route.ny, 4)


def _corners(lat):
    """(n00, n10, n11, n01) quad-corner slices [nx-1, ny-1, 4]."""
    return lat[:-1, :-1], lat[1:, :-1], lat[1:, 1:], lat[:-1, 1:]


def _families(fn, lat, uniform_sel: str, up=None):
    """fn on the slot-1 and slot-2 triangles of every quad.

    Slot 1: up = (n00, n10, n11), down = (n00, n10, n01); slot 2: up =
    (n00, n11, n01), down = (n10, n11, n01).  A uniform diagonal
    (``uniform_sel`` "up"/"down") picks the family once; otherwise the
    [nx-1, ny-1] bool ``up`` selects per quad (the branch not taken gets
    a zero cotangent, as under ``jnp.where``)."""
    n00, n10, n11, n01 = _corners(lat)
    if uniform_sel == "up":
        return fn(n00, n10, n11), fn(n00, n11, n01)
    if uniform_sel == "down":
        return fn(n00, n10, n01), fn(n10, n11, n01)
    return (torch.where(up, fn(n00, n10, n11), fn(n00, n10, n01)),
            torch.where(up, fn(n00, n11, n01), fn(n10, n11, n01)))


def _route_families(fn, lat, route):
    up = None if route.uniform_sel else route.sel > 0
    return _families(fn, lat, route.uniform_sel, up)


def _domain_from_lat(lat, route, E: float, nu: float,
                     w_sum: float) -> torch.Tensor:
    f = E / (1.0 - nu ** 2)
    e1, e2 = _route_families(lambda a, b, c: _tri_energy(a, b, c, f, nu),
                             lat, route)
    if route.all_present:
        return w_sum * (torch.sum(e1) + torch.sum(e2))
    return w_sum * torch.sum(route.t1 * e1 + route.t2 * e2)


def lattice_domain_energy(node: torch.Tensor, route, E: float, nu: float,
                          w_sum: float) -> torch.Tensor:
    """Elastic strain energy from the lattice route."""
    return _domain_from_lat(_lat(node, route), route, E, nu, w_sum)


def _tri_body_work(a, b, c, pts, w, body_force):
    """|detJ| sum_q w_q b(x_q).u(x_q) per triangle from corner stacks
    [..., 4]; lam = 1 - xi - eta weights the third corner, as on the
    gather route."""
    det = ((a[..., 0] - c[..., 0]) * (b[..., 1] - c[..., 1])
           - (b[..., 0] - c[..., 0]) * (a[..., 1] - c[..., 1]))
    sh = (1,) * (a.dim() - 1)
    xi = pts[:, 0].reshape(sh + (-1, 1))
    eta = pts[:, 1].reshape(sh + (-1, 1))
    lam = 1.0 - xi - eta
    xq = (xi * a[..., None, 0:2] + eta * b[..., None, 0:2]
          + lam * c[..., None, 0:2])               # [..., ng, 2]
    uq = (xi * a[..., None, 2:4] + eta * b[..., None, 2:4]
          + lam * c[..., None, 2:4])
    bf = body_force(xq.reshape(-1, 2)).reshape(uq.shape)
    return _abs_jax(det) * torch.sum(w.reshape(sh + (-1,))
                                     * torch.sum(bf * uq, dim=-1), dim=-1)


def lattice_body_work(node: torch.Tensor, route, body_force, pts, w
                      ) -> torch.Tensor:
    """Body-force work over the lattice route, from node-lattice slices."""
    return body_work_from_lat(_lat(node, route), route, body_force, pts, w)


def body_work_from_lat(lat: torch.Tensor, route, body_force, pts, w
                       ) -> torch.Tensor:
    """Body-force work from an already-built [nx, ny, 4] lattice.
    Hole-dropped triangles are masked by t1/t2 (their corners keep
    coordinates, so detJ alone would not exclude them)."""
    w1, w2 = _route_families(
        lambda a, b, c: _tri_body_work(a, b, c, pts, w, body_force), lat,
        route)
    if route.all_present:
        return torch.sum(w1) + torch.sum(w2)
    return torch.sum(route.t1 * w1 + route.t2 * w2)


def extra_elements_energy(node: torch.Tensor, conn: torch.Tensor,
                          E: float, nu: float, w_sum: float) -> torch.Tensor:
    """Elastic strain energy of a small irregular element set gathered
    from the [N, 4] node table: the generic collar term of hybrid meshes,
    the reference that ``collar_energy`` is held to."""
    f = E / (1.0 - nu ** 2)
    g = flat_gather(node, conn)                  # [K, 3, 4]
    return w_sum * torch.sum(_tri_energy(g[:, 0], g[:, 1], g[:, 2], f, nu))


class _TakeSortedRows(torch.autograd.Function):
    """node[ids] for sorted unique ids; the backward adds the rows back at
    ``ids`` (``index_add_`` of unique indices: no two rows meet, so the
    result does not depend on the order)."""

    @staticmethod
    def forward(ctx, node, ids):
        ctx.save_for_backward(ids)
        ctx.n_rows = node.shape[0]
        return node.index_select(0, ids.long())

    @staticmethod
    def backward(ctx, ct):
        (ids,) = ctx.saved_tensors
        out = ct.new_zeros((ctx.n_rows, ct.shape[1]))
        return out.index_add_(0, ids.long(), ct), None


def _take_sorted_rows(node, ids):
    return _TakeSortedRows.apply(node, ids)


def collar_energy(node: torch.Tensor, hy, E: float, nu: float, w_sum: float,
                  body_force=None, pts=None, w=None) -> torch.Tensor:
    """Collar term of hybrid meshes in the compact ``[stair | rim]`` node
    space: the staircase lattice rows (``hy.stair_ids``) taken by one
    sorted-unique gather, the rim rows as the node-table suffix (a
    slice), then the element energy (and body-force work) by the
    incidence-gather assembly over ``hy.extra_conn_rel``.  Equal to
    ``extra_elements_energy`` up to reassociation."""
    n_lat = hy.lattice.nx * hy.lattice.ny
    f = E / (1.0 - nu ** 2)
    compact = torch.cat([_take_sorted_rows(node, hy.stair_ids),
                         node[n_lat:]], dim=0)
    g = gather_with_incidence(compact, hy.extra_conn_rel, hy.extra_incidence)
    e = w_sum * torch.sum(_tri_energy(g[:, 0], g[:, 1], g[:, 2], f, nu))
    if body_force is not None:
        e = e - torch.sum(_tri_body_work(g[:, 0], g[:, 1], g[:, 2], pts, w,
                                         body_force))
    return e


def lattice_total(node: torch.Tensor, route, E: float, nu: float,
                  w_sum: float, t_x: float, t_y: float = 0.0
                  ) -> torch.Tensor:
    """domain - traction work, all from lattice slices.  The uniform
    traction on linear edges integrates exactly:
    t . integral u ds = ds (t_x (u0x + u1x) + t_y (u0y + u1y)) / 2."""
    lat = _lat(node, route)       # built once, shared by both terms
    dom = _domain_from_lat(lat, route, E, nu, w_sum)
    return dom - _edge_work(lat, route, t_x, t_y)


def face_work(face_slice, edge_masks, t_x: float, t_y: float,
              init: torch.Tensor) -> torch.Tensor:
    """``init`` + the uniform-traction work over the masked segments of
    each face; ``face_slice(face, k)`` gives channel k (cx, cy, ux, uy)
    of the face's node line."""
    work = init
    for face, mask in edge_masks.items():
        cx = face_slice(face, 0)
        cy = face_slice(face, 1)
        ds = torch.sqrt((cx[1:] - cx[:-1]) ** 2 + (cy[1:] - cy[:-1]) ** 2)
        if t_x:
            ux = face_slice(face, 2)
            work = work + t_x * torch.sum(mask * ds * 0.5
                                          * (ux[1:] + ux[:-1]))
        if t_y:
            uy = face_slice(face, 3)
            work = work + t_y * torch.sum(mask * ds * 0.5
                                          * (uy[1:] + uy[:-1]))
    return work


def lattice_face(lat, face: str, k: int) -> torch.Tensor:
    """Channel k of a face's node line of an [nx, ny, 4] lattice."""
    if face == "right":
        return lat[-1, :, k]
    if face == "left":
        return lat[0, :, k]
    if face == "up":
        return lat[:, -1, k]
    return lat[:, 0, k]        # "down"


def _edge_work(lat, route, t_x: float, t_y: float = 0.0) -> torch.Tensor:
    """Traction work from the lattice face slices (see lattice_total)."""
    return face_work(lambda face, k: lattice_face(lat, face, k),
                     route.edge_masks, t_x, t_y, lat.new_zeros(()))
