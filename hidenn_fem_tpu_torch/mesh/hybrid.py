"""Hybrid lattice+collar meshes (port of ``hidenn_fem_tpu/mesh/hybrid.py``).

A structured triangular lattice everywhere the geometry is rectangular,
and a small Delaunay "collar" of irregular triangles tying each circular
hole rim to the lattice: the reference's plate-with-holes domains with
exact circle rims, whose energy evaluates almost entirely from
node-lattice slices.

Construction (host numpy/scipy, the JAX package's steps and arrays):

1. lay an (nx, ny) node lattice over the rectangle (spacing ``lc``); mark
   nodes within ``clear*lc`` of a hole *bad* and every quad with a bad
   corner *dead*;
2. triangulate live quads with the diagonal ``variant`` (up/down/zigzag);
3. sample each hole rim at spacing ``lc`` and Delaunay-triangulate the
   staircase nodes of the dead region with the rim points; keep triangles
   whose centroid is inside a dead quad and outside every hole;
4. certify the collar: the kept triangles are disjoint, so they tile the
   dead region minus the rim polygons iff their total area matches it; a
   mismatch raises.

The node table is [lattice nodes (lexicographic, dead kept, pinned) | rim
points], so the lattice fill is a slice of the node-table prefix
(``LatticeRoute.prefix_identity``).  The result is a plain
:class:`TriMesh` with a :class:`HybridRoute` attached, which
``PlaneStressEnergy`` takes (``ops/losses.py:_hybrid_total``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..device import resolve_device
from .delaunay import _lc_fn, _walk_circle
from .lattice import LatticeRoute
from .types import TriMesh, build_incidence_table

__all__ = ["HybridRoute", "generate_mesh_hybrid",
           "hybrid_mesh_from_arrays"]


@dataclasses.dataclass(frozen=True)
class HybridRoute:
    """Fast-path structure of a hybrid mesh (module doc).

    Attributes:
      lattice: route over the node-table prefix (``prefix_identity``),
        with the live-quad masks, the diagonal selection and the Neumann
        face masks.
      extra_conn: [K, 3] int32 collar triangles (global node ids).
      stair_ids: [S] int32 sorted unique lattice node ids the collar
        touches (the staircase ring around each hole).
      extra_conn_rel: [K, 3] int32 ``extra_conn`` in the compact
        ``[stair | rim]`` node space.
      extra_incidence: [S + rim, D] int32 incidence table of
        ``extra_conn_rel`` (for the gather-based backward).
    """

    lattice: LatticeRoute
    extra_conn: torch.Tensor
    stair_ids: torch.Tensor
    extra_conn_rel: torch.Tensor
    extra_incidence: torch.Tensor

    def to(self, device) -> "HybridRoute":
        """A copy with every tensor on ``device``."""
        return HybridRoute(
            lattice=self.lattice.to(device),
            extra_conn=self.extra_conn.to(device),
            stair_ids=self.stair_ids.to(device),
            extra_conn_rel=self.extra_conn_rel.to(device),
            extra_incidence=self.extra_incidence.to(device))


def _shoelace(pts: np.ndarray) -> float:
    x, y = pts[:, 0], pts[:, 1]
    return 0.5 * float(np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y))


def generate_mesh_hybrid(
    length: float = 2.0,
    height: float = 1.0,
    holes: List[Tuple[float, float, float]] = (
        (0.5, 0.7, 0.12), (1.0, 0.3, 0.15), (1.4, 0.6, 0.1)),
    boundaries: Dict[str, int] = None,
    lc: float = 1e-1,
    variant: str = "up",
    clear: float = 0.6,
    dtype=torch.float32,
    device=None,
) -> TriMesh:
    """Rectangle-with-circular-holes mesh with a hybrid route (tensors on
    ``device``, the card unless given).

    The arguments of :func:`generate_mesh_delaunay` (the reference's
    geometry and BC conventions); ``variant`` picks the lattice diagonal
    as in the structured generator; ``clear`` is the hole clearance in
    units of ``lc`` (0.6 makes every staircase edge a Gabriel edge of the
    collar points).  Raises if an inflated hole reaches the boundary quad
    ring (use :func:`generate_mesh_delaunay` for such geometry), and
    where two loaded faces meet at a corner quad whose diagonal joins
    them (a Neumann edge the route cannot load;
    :func:`hybrid_mesh_from_arrays`).
    """
    device = resolve_device(device)
    if boundaries is None:
        boundaries = {"up": 0, "down": 0, "right": 2, "left": 1}
    if variant not in ("up", "down", "zigzag"):
        raise ValueError(f"unknown variant {variant!r}")

    nx = max(2, int(round(length / lc)) + 1)
    ny = max(2, int(round(height / lc)) + 1)
    hx = length / (nx - 1)
    hy = height / (ny - 1)
    h = max(hx, hy)
    xs = np.linspace(0.0, length, nx)
    ys = np.linspace(0.0, height, ny)
    gx, gy = np.meshgrid(xs, ys, indexing="ij")          # [nx, ny]
    lat_pts = np.stack([gx.ravel(), gy.ravel()], axis=1)  # pos = i*ny+j

    bad = np.zeros(nx * ny, dtype=bool)
    for cx, cy, r in holes:
        bad |= np.hypot(lat_pts[:, 0] - cx,
                        lat_pts[:, 1] - cy) < r + clear * h
    badg = bad.reshape(nx, ny)
    dead = (badg[:-1, :-1] | badg[1:, :-1]
            | badg[:-1, 1:] | badg[1:, 1:])              # [nx-1, ny-1]
    if dead.size and (dead[0, :].any() or dead[-1, :].any()
                      or dead[:, 0].any() or dead[:, -1].any()):
        raise ValueError(
            "a hole (inflated by the clearance) reaches the boundary "
            "quad ring; hybrid meshes need lattice faces intact — use "
            "generate_mesh_delaunay for this geometry")
    live = ~dead

    # ---- lattice triangles over live quads
    lat_cells = _lattice_triangles(live, _diagonals(variant, nx, ny), ny)

    # ---- collar points: staircase lattice nodes + exact rim samples
    lcf = _lc_fn(lc)
    rims = [_walk_circle(cx, cy, r, lcf) for cx, cy, r in holes]
    rim_area = sum(_shoelace(rp) for rp in rims)
    rim_pts = (np.concatenate(rims, axis=0) if rims
               else np.zeros((0, 2)))
    n_lat = nx * ny
    n = n_lat + len(rim_pts)

    extra = np.zeros((0, 3), dtype=np.int64)
    if dead.any():
        inc_dead = np.zeros((nx, ny), dtype=bool)
        inc_dead[:-1, :-1] |= dead
        inc_dead[1:, :-1] |= dead
        inc_dead[:-1, 1:] |= dead
        inc_dead[1:, 1:] |= dead
        stair_ids = np.nonzero((~badg & inc_dead).ravel())[0]
        collar_pts = np.concatenate([lat_pts[stair_ids], rim_pts], axis=0)
        gids = np.concatenate([stair_ids,
                               n_lat + np.arange(len(rim_pts))])

        from scipy.spatial import Delaunay
        cells = Delaunay(collar_pts).simplices.astype(np.int64)
        cen = collar_pts[cells].mean(axis=1)
        keep = np.ones(len(cells), dtype=bool)
        for cx, cy, r in holes:
            keep &= np.hypot(cen[:, 0] - cx, cen[:, 1] - cy) >= r
        ci = np.clip((cen[:, 0] / hx).astype(np.int64), 0, nx - 2)
        cj = np.clip((cen[:, 1] / hy).astype(np.int64), 0, ny - 2)
        keep &= dead[ci, cj]
        cells = cells[keep]
        v = collar_pts[cells]
        area2 = ((v[:, 1, 0] - v[:, 0, 0]) * (v[:, 2, 1] - v[:, 0, 1])
                 - (v[:, 2, 0] - v[:, 0, 0]) * (v[:, 1, 1] - v[:, 0, 1]))
        # Exactly-collinear staircase triples (e.g. (i, j), (i+3, j-1),
        # (i+6, j-2) across a notch) can reach qhull as zero-area
        # slivers; real collar triangles are >~0.5 lattice cells, so a
        # relative floor separates them cleanly.  Dropping a sliver
        # removes ~0 area (the conservation check below still certifies
        # coverage); keeping it would put a ~0 detJ into the element
        # set, which the 1/detJ strain algebra cannot tolerate.  The
        # zero-width seam left behind is a hanging-node T-junction:
        # linear fields remain exactly conforming across it (the middle
        # node lies on the chord), so the patch test is unaffected.
        sliver = np.abs(area2) < 1e-6 * hx * hy
        cells, area2 = cells[~sliver], area2[~sliver]
        flip = area2 < 0
        cells[flip] = cells[flip][:, [0, 2, 1]]

        # conformity certificate: kept triangles are mutually disjoint
        # (subset of one Delaunay triangulation), so exact area equality
        # with the dead region minus the rim polygons proves they tile
        # it — no staircase-crossing overlap, no gap.
        got = 0.5 * float(np.abs(area2).sum())
        want = float(dead.sum()) * hx * hy - abs(rim_area)
        if not np.isclose(got, want, rtol=1e-8, atol=1e-12):
            raise ValueError(
                f"collar triangulation does not tile the dead region "
                f"(area {got:.12g} vs {want:.12g}); the lattice/rim "
                f"spacing ratio is too coarse near a hole — refine lc "
                f"or raise clear")
        extra = gids[cells]

    coords = np.concatenate([lat_pts, rim_pts], axis=0)
    connectivity = np.concatenate([lat_cells, extra], axis=0)

    # ---- masks (conventions of mesh/structured.py / the reference)
    def _face(pts, face):
        tol = 1e-9 * max(length, height)
        if face == "left":
            return np.abs(pts[:, 0]) < tol
        if face == "right":
            return np.abs(pts[:, 0] - length) < tol
        if face == "down":
            return np.abs(pts[:, 1]) < tol
        return np.abs(pts[:, 1] - height) < tol

    geom = np.zeros(n, dtype=bool)
    for face in ("up", "down", "left", "right"):
        geom |= _face(coords, face)
    geom[n_lat:] = True                     # rim points: frozen geometry
    used = np.zeros(n, dtype=bool)
    used[connectivity] = True
    pinned = ~used                          # dead/clearance lattice nodes
    geom |= pinned

    bc = np.zeros(n, dtype=bool)
    mn = np.zeros(n, dtype=bool)
    for face, condition in boundaries.items():
        if condition == 1:
            bc |= _face(coords, face)
        elif condition == 2:
            mn |= _face(coords, face)
    bc |= pinned
    mn &= ~pinned

    # ---- Neumann edges (candidate filter as in mesh/structured.py)
    mn_elem = mn[connectivity]
    cand = []
    for a, b in ((0, 1), (1, 2), (2, 0)):
        sel = mn_elem[:, a] & mn_elem[:, b]
        if sel.any():
            cand.append(connectivity[sel][:, [a, b]])
    if cand:
        pairs = np.concatenate(cand, axis=0)
        lo = pairs.min(axis=1)
        hi = pairs.max(axis=1)
        keys = np.unique((lo << 32) | hi)
        neumann_edges = np.stack([keys >> 32, keys & 0xFFFFFFFF], axis=1)
    else:
        neumann_edges = np.zeros((0, 2), dtype=np.int64)

    return hybrid_mesh_from_arrays(
        coords.astype(np.float32), connectivity, geom, bc, mn,
        neumann_edges, nx=nx, ny=ny, variant=variant, dtype=dtype,
        device=device)


def _lattice_triangles(live: np.ndarray, selg: np.ndarray,
                       ny: int) -> np.ndarray:
    """[2 L, 3] the two triangles of each live quad, in the generator's
    order: the first of every quad (``np.nonzero(live)``'s order), then
    the second of every quad.  Families as in mesh/lattice.py: up
    T1=(n00,n10,n11) T2=(n00,n11,n01); down T1=(n00,n10,n01)
    T2=(n10,n11,n01), all counter-clockwise."""
    qi, qj = np.nonzero(live)
    up = selg[qi, qj] > 0
    n00 = qi * ny + qj
    n10 = (qi + 1) * ny + qj
    n01 = qi * ny + (qj + 1)
    n11 = (qi + 1) * ny + (qj + 1)
    t1 = np.where(up[:, None], np.stack([n00, n10, n11], 1),
                  np.stack([n00, n10, n01], 1))
    t2 = np.where(up[:, None], np.stack([n00, n11, n01], 1),
                  np.stack([n10, n11, n01], 1))
    return np.concatenate([t1, t2], axis=0).astype(np.int64)


def _diagonals(variant: str, nx: int, ny: int) -> np.ndarray:
    """[nx-1, ny-1] f32 quad diagonals: 1 along n00-n11, 0 along
    n10-n01."""
    selg = np.zeros((nx - 1, ny - 1), dtype=np.float32)
    if variant == "up":
        selg[:] = 1.0
    elif variant == "zigzag":
        par = (np.add.outer(np.arange(nx - 1), np.arange(ny - 1)) % 2)
        selg[par == 0] = 1.0
    return selg


def hybrid_mesh_from_arrays(
    coords, connectivity, geom_boundary_mask, dirichlet_mask,
    neumann_mask, neumann_edges, *, nx: int, ny: int, variant: str,
    dtype=torch.float32, device=None,
) -> TriMesh:
    """A hybrid mesh, its route included, from the six arrays of
    :func:`generate_mesh_hybrid`'s layout (tensors on ``device``, the card
    unless given).

    The layout: the ``nx * ny`` lattice nodes first, lexicographic
    (node ``i * ny + j`` at column i, row j; the dead nodes kept, used by
    no element), then the rim points; the lattice triangles first, the
    two of each live quad in the order of :func:`_lattice_triangles`
    (``variant`` names the diagonals: "up", "down" or "zigzag"), then
    the collar's.  A quad is live where all four of its corners are used:
    a dead quad has a corner inside a hole's clearance, which no triangle
    uses.  Every Neumann edge must be a segment of the lattice's outer
    faces, which the route's face masks load (a segment is loaded exactly
    when it is a Neumann edge).  Everything else is derived: the live
    quads, the route's diagonal and presence masks and Neumann face
    masks, the staircase ids and the compact collar tables.  No banded or
    fused tables are built (the route owns the fast path).  Raises
    ``ValueError`` where the arrays do not have this layout.
    """
    device = resolve_device(device)
    if variant not in ("up", "down", "zigzag"):
        raise ValueError(f"unknown variant {variant!r}")
    nx, ny = int(nx), int(ny)
    coords = np.asarray(coords)
    conn = np.asarray(connectivity).astype(np.int64).reshape(-1, 3)
    edges = np.asarray(neumann_edges).astype(np.int64).reshape(-1, 2)
    n_lat = nx * ny
    n = coords.shape[0]
    if nx < 2 or ny < 2 or n < n_lat:
        raise ValueError(f"a {nx}x{ny} lattice needs at least {n_lat} "
                         f"nodes first; the arrays have {n}")
    lat = coords[:n_lat].reshape(nx, ny, 2)
    xs, ys = lat[:, 0, 0], lat[0, :, 1]
    if not ((lat[..., 0] == xs[:, None]).all()
            and (lat[..., 1] == ys[None, :]).all()
            and (np.diff(xs) > 0).all() and (np.diff(ys) > 0).all()):
        raise ValueError(f"the first {n_lat} nodes are not a {nx}x{ny} "
                         "lattice in lexicographic order (x by column, "
                         "y by row)")
    if conn.size and (conn.min() < 0 or conn.max() >= n):
        raise ValueError(f"connectivity indexes nodes outside [0, {n})")

    used = np.zeros(n, dtype=bool)
    used[conn.reshape(-1)] = True
    usedg = used[:n_lat].reshape(nx, ny)
    live = (usedg[:-1, :-1] & usedg[1:, :-1]
            & usedg[:-1, 1:] & usedg[1:, 1:])
    if not (live[0, :].all() and live[-1, :].all()
            and live[:, 0].all() and live[:, -1].all()):
        raise ValueError("a quad of the boundary ring is dead; hybrid "
                         "meshes need lattice faces intact")
    selg = _diagonals(variant, nx, ny)
    lat_cells = _lattice_triangles(live, selg, ny)
    n_lc = lat_cells.shape[0]
    if conn.shape[0] < n_lc or not np.array_equal(conn[:n_lc], lat_cells):
        raise ValueError(
            f"the first {n_lc} triangles are not the {variant!r} "
            f"triangles of the {n_lc // 2} live quads in the generator's "
            "order")
    extra = conn[n_lc:]

    # Neumann edges -> face segment masks (as mesh/lattice.py): both
    # ends on one outer face, one lattice step apart
    edge_masks = {}
    if edges.size:
        if edges.max() >= n_lat:
            raise ValueError("a Neumann edge ends at a rim point; the "
                             "route loads lattice face segments only")
        ia, ja = edges[:, 0] // ny, edges[:, 0] % ny
        ib, jb = edges[:, 1] // ny, edges[:, 1] % ny
        vert = (ia == ib) & (np.abs(ja - jb) == 1)
        horz = (ja == jb) & (np.abs(ia - ib) == 1)
        sj, si = np.minimum(ja, jb), np.minimum(ia, ib)
        faces = (("left", vert & (ia == 0), sj, ny - 1),
                 ("right", vert & (ia == nx - 1), sj, ny - 1),
                 ("down", horz & (ja == 0), si, nx - 1),
                 ("up", horz & (ja == ny - 1), si, nx - 1))
        on_face = np.zeros(edges.shape[0], dtype=bool)
        for _, m, _, _ in faces:
            on_face |= m
        if not on_face.all():
            a, b = edges[~on_face][0]
            raise ValueError(
                f"the Neumann edge ({a}, {b}) is no segment of the "
                "lattice's outer faces, which the route's face masks "
                "would not load (where two loaded faces meet, a corner "
                "quad's diagonal joins their nodes)")
        for face, m, segment, size in faces:
            if m.any():
                mask = np.zeros(size, dtype=np.float32)
                mask[segment[m]] = 1.0
                edge_masks[face] = torch.tensor(mask, device=device)

    def t(a):
        return torch.tensor(a, device=device)

    route = LatticeRoute(
        sel=t(selg),
        t1=t(live.astype(np.float32)),
        t2=t(live.astype(np.float32)),
        inv_map=t(np.arange(n_lat, dtype=np.int32)),
        fwd_map=t(np.concatenate([
            np.arange(n_lat, dtype=np.int32),
            np.full((n - n_lat,), n_lat, dtype=np.int32)])),
        edge_masks=edge_masks,
        nx=nx, ny=ny, identity=False, prefix_identity=True,
        uniform_sel=variant if variant in ("up", "down") else "",
        all_present=bool(live.all()))

    mesh = TriMesh.from_arrays(
        coords=coords,
        connectivity=conn,
        geom_boundary_mask=geom_boundary_mask,
        dirichlet_mask=dirichlet_mask,
        neumann_mask=neumann_mask,
        neumann_edges=edges,
        dtype=dtype, device=device,
        # the hybrid route owns the fast path; banded and fused tables
        # would only serve an A/B with the route stripped (rebuild with
        # from_arrays for that), and lattice detection rejects rim nodes
        build_banded=False, build_lattice=False, build_fused=False)
    # compact collar tables (ops/lattice_energy.collar_energy): sorted
    # unique staircase ids + conn remapped into [stair | rim] space
    flat = extra.reshape(-1)
    stair = np.unique(flat[flat < n_lat])
    abs2comp = np.full(n, -1, dtype=np.int64)
    abs2comp[stair] = np.arange(stair.size)
    abs2comp[n_lat:] = stair.size + np.arange(n - n_lat)
    conn_rel = abs2comp[extra]
    incidence = build_incidence_table(conn_rel.astype(np.int64),
                                      stair.size + (n - n_lat))
    return dataclasses.replace(
        mesh, hybrid=HybridRoute(
            lattice=route,
            extra_conn=t(extra.astype(np.int32)).reshape(-1, 3),
            stair_ids=t(stair.astype(np.int32)),
            extra_conn_rel=t(conn_rel.astype(np.int32)).reshape(-1, 3),
            extra_incidence=t(np.asarray(incidence, dtype=np.int32))))
