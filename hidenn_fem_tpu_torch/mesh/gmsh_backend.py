"""gmsh-based unstructured mesh generation (port of
``hidenn_fem_tpu/mesh/gmsh_backend.py``; gmsh is optional and gated).

OCC rectangle minus circular holes, 2D triangular meshing at size ``lc``,
geometric-boundary detection from boundary curves plus a radial hole test,
coordinate-tolerance BC masks, and Neumann-edge extraction, as in the
reference's ``generate_mesh_gmsh``.  gmsh runs on the host as
preprocessing; the import is gated so that nothing else of the package
needs it.  ``assemble_gmsh_mesh`` is the same numpy as the JAX package's,
so the same gmsh output gives the same arrays.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

import torch

from .banded import rcm_node_order
from .structured import _face_mask, unique_edges
from .types import TriMesh

__all__ = ["generate_mesh_gmsh", "have_gmsh", "assemble_gmsh_mesh"]


def have_gmsh() -> bool:
    try:
        import gmsh  # noqa: F401
        return True
    except ImportError:
        return False


def assemble_gmsh_mesh(node_tags, points, tri_tags, boundary_node_tags,
                       holes, boundaries, length, height,
                       reorder: bool = False, dtype=torch.float32,
                       device=None) -> TriMesh:
    """Post-gmsh assembly (no gmsh API): tag remap, geometric boundary +
    radial hole safety net, coordinate-tolerance BC masks, Neumann-edge
    extraction; the TriMesh's tensors go to ``device`` (the card unless
    given).  Testable without gmsh (a fake gmsh module drives the API
    shell).

    Args:
      node_tags: [N] gmsh node tags (arbitrary positive ints, any order).
      points: [N, 2] node coordinates in tag order.
      tri_tags: [Ne, 3] triangle connectivity IN TAGS.
      boundary_node_tags: set/array of tags on boundary curves/points.
      holes / boundaries / length / height: the generator's arguments.
      reorder: apply the bandwidth-reducing RCM node permutation +
        min-node element sort before the tables are built.  The
        generators default it on: raw mesher node order scatters each
        element block's node window across the whole table, and the
        banded tables then do not fit their window limit.  Default False
        here so the assembly keeps tag order.
    """
    node_tags = np.asarray(node_tags)
    points = np.asarray(points, dtype=np.float64)
    tri_tags = np.asarray(tri_tags, dtype=np.int64)
    if np.array_equal(node_tags, np.arange(len(node_tags))):
        # identity tags (e.g. the Delaunay backend): skip the dict remap
        cells = tri_tags
    elif tri_tags.size:
        tag_to_idx = {int(t): i for i, t in enumerate(node_tags)}
        remap = np.vectorize(tag_to_idx.__getitem__, otypes=[np.int64])
        cells = remap(tri_tags)
    else:
        cells = tri_tags.astype(np.int64)

    bset = set(int(t) for t in boundary_node_tags)
    geom_boundary = np.array([int(t) in bset for t in node_tags])
    # radial hole test as a safety net (src/mesh.py:90-95)
    for cx, cy, r in holes:
        dist = np.hypot(points[:, 0] - cx, points[:, 1] - cy)
        geom_boundary |= np.abs(dist - r) < 1e-6

    bc_mask = np.zeros(points.shape[0], dtype=bool)
    mn_mask = np.zeros(points.shape[0], dtype=bool)
    for face, condition in boundaries.items():
        if condition == 0:
            continue
        m = _face_mask(points, face, length, height)
        if condition == 1:
            bc_mask |= m
        elif condition == 2:
            mn_mask |= m

    if reorder and cells.size:
        perm = rcm_node_order(cells, len(points))
        inv = np.empty(len(points), dtype=np.int64)
        inv[perm] = np.arange(len(points))
        points = points[perm]
        geom_boundary = geom_boundary[perm]
        bc_mask = bc_mask[perm]
        mn_mask = mn_mask[perm]
        cells = inv[cells]
        cells = cells[np.argsort(cells.min(axis=1), kind="stable")]

    uedges = unique_edges(cells)
    neumann_edges = uedges[np.all(mn_mask[uedges], axis=1)]

    return TriMesh.from_arrays(
        coords=points.astype(np.float32),
        connectivity=cells,
        geom_boundary_mask=geom_boundary,
        dirichlet_mask=bc_mask,
        neumann_mask=mn_mask,
        neumann_edges=neumann_edges,
        dtype=dtype,
        device=device,
    )


def generate_mesh_gmsh(
    length: float = 2.0,
    height: float = 1.0,
    holes: List[Tuple[float, float, float]] = (
        (0.5, 0.7, 0.12), (1.0, 0.3, 0.15), (1.4, 0.6, 0.1)),
    boundaries: Dict[str, int] = None,
    lc: float = 1e-1,
    reorder: bool = True,
    dtype=torch.float32,
    device=None,
) -> TriMesh:
    """Rectangle-with-holes unstructured mesh via gmsh's OCC boolean cut
    (the reference's arguments and defaults).  Raises ImportError, with a
    pointer to the structured generator, when gmsh is not installed.

    ``reorder`` (default True) applies the RCM node permutation before the
    tables are built (see ``assemble_gmsh_mesh``); node and element
    indexing then differ from raw gmsh output.  The tensors go to
    ``device``, the card unless given.
    """
    try:
        import gmsh
    except ImportError as e:
        raise ImportError(
            "gmsh is not installed; use hidenn_fem_tpu_torch.generate_mesh "
            "(structured triangulation, no external deps) instead"
        ) from e

    if boundaries is None:
        boundaries = {"up": 0, "down": 0, "right": 2, "left": 1}

    gmsh.initialize()
    try:
        gmsh.model.add("plate_with_holes")
        rect = gmsh.model.occ.addRectangle(0, 0, 0, length, height)
        hole_tags = [(2, gmsh.model.occ.addDisk(cx, cy, 0, r, r))
                     for cx, cy, r in holes]
        if hole_tags:
            out = gmsh.model.occ.cut([(2, rect)], hole_tags)
            domain = out[0][0][1]
        else:
            domain = rect
        gmsh.model.occ.synchronize()
        gmsh.model.mesh.setSize(gmsh.model.getEntities(0), lc)
        gmsh.model.mesh.generate(2)

        node_tags, node_xyz, _ = gmsh.model.mesh.getNodes()
        points = np.asarray(node_xyz).reshape(-1, 3)[:, :2]

        elem_types, _, elem_node_tags = gmsh.model.mesh.getElements(2)
        tris = [np.asarray(nodes).reshape(-1, 3)
                for etype, nodes in zip(elem_types, elem_node_tags)
                if etype == 2]
        tri_tags = (np.vstack(tris) if tris
                    else np.zeros((0, 3), dtype=np.int64))

        # geometric boundary: nodes on all boundary curves and their points
        boundary_node_tags = set()
        for dim, tag in gmsh.model.getBoundary([(2, domain)], oriented=False,
                                               recursive=False):
            boundary_node_tags.update(gmsh.model.mesh.getNodes(dim, tag)[0])
            for pdim, ptag in gmsh.model.getBoundary([(dim, tag)],
                                                     oriented=False,
                                                     recursive=False):
                boundary_node_tags.update(
                    gmsh.model.mesh.getNodes(pdim, ptag)[0])
    finally:
        gmsh.finalize()

    return assemble_gmsh_mesh(node_tags, points, tri_tags,
                              boundary_node_tags, holes, boundaries,
                              length, height, reorder=reorder, dtype=dtype,
                              device=device)
