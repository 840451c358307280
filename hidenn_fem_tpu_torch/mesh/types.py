"""Mesh container (port of ``hidenn_fem_tpu/mesh/types.py``).

Tables are built as numpy on the host, exactly as in the JAX package, and
held as torch tensors; ``TriMesh.to(device)`` moves them, and those of the
lattice, banded and hybrid routes, to the card.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from .banded import (build_banded_assembly, build_paired_assembly,
                     build_striped_assembly)
from .lattice import detect_lattice

__all__ = ["TriMesh", "build_incidence_table"]


def build_incidence_table(connectivity: np.ndarray,
                          n_nodes: int) -> np.ndarray:
    """Node -> flat-connectivity-row incidence table [N, max_degree].

    Entry [n, k] is the k-th index into the flattened [Ne*3] connectivity
    that references node n; -1 pads nodes of lower degree.  Lets the
    energy backward gather per-corner cotangents into node gradients in a
    fixed order instead of scatter-adding them.  The native library builds
    the same table when it is built (``mesh/native.py``).
    """
    from . import native
    if native.available():
        return native.build_incidence_table(connectivity, n_nodes)
    flat = np.asarray(connectivity, dtype=np.int64).reshape(-1)
    order = np.argsort(flat, kind="stable")
    sorted_nodes = flat[order]
    counts = np.bincount(sorted_nodes, minlength=n_nodes)
    maxdeg = int(counts.max()) if counts.size else 0
    table = np.full((n_nodes, maxdeg), -1, dtype=np.int32)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    # rank of each sorted entry within its node's group
    ranks = np.arange(flat.size) - starts[sorted_nodes]
    table[sorted_nodes, ranks] = order.astype(np.int32)
    return table


@dataclasses.dataclass(frozen=True)
class TriMesh:
    """An unstructured triangular mesh with BC tags.

    Attributes:
      coords: [N, 2] float, initial node coordinates.
      connectivity: [Ne, 3] int32, P1 triangle node indices.
      geom_boundary_mask: [N] bool, nodes whose coordinates stay frozen.
      dirichlet_mask: [N] bool, nodes with prescribed displacement.
      neumann_mask: [N] bool, nodes on the traction boundary.
      neumann_edges: [E, 2] int32, edges whose both nodes are Neumann.
      incidence: [N, max_degree] int32 from ``build_incidence_table``, or
        None (the energy backward then scatter-adds).
      fused_connectivity / fused_incidence: connectivity with the Neumann
        edges appended as (n0, n1, n1) pseudo-elements, and its incidence
        table; they let the traction work ride the element kernel.
      lattice: the recovered ``LatticeRoute`` (``mesh/lattice.py``) of a
        lattice-topology mesh, or None.  ``from_arrays`` detects it where
        the JAX package does, and the energy then takes the gather-free
        lattice route first, as the JAX package's does.
      banded: the triangle ``BandedAssembly`` (``mesh/banded.py``), built
        by ``from_arrays`` for large meshes, as in the JAX package.
      banded_paired: the quad-paired (or, under ``HDNN_STRIPS``, striped)
        tables; the banded energy prefers them.
      hybrid: the ``HybridRoute`` of a ``generate_mesh_hybrid`` mesh
        (``mesh/hybrid.py``), or None.
    """

    coords: torch.Tensor
    connectivity: torch.Tensor
    geom_boundary_mask: torch.Tensor
    dirichlet_mask: torch.Tensor
    neumann_mask: torch.Tensor
    neumann_edges: torch.Tensor
    incidence: Optional[torch.Tensor] = None
    banded: Optional[object] = None
    banded_paired: Optional[object] = None
    fused_connectivity: Optional[torch.Tensor] = None
    fused_incidence: Optional[torch.Tensor] = None
    lattice: Optional[object] = None
    hybrid: Optional[object] = None

    @property
    def n_nodes(self) -> int:
        return self.coords.shape[0]

    @property
    def n_elements(self) -> int:
        return self.connectivity.shape[0]

    @property
    def n_neumann_edges(self) -> int:
        return self.neumann_edges.shape[0]

    @property
    def device(self) -> torch.device:
        return self.coords.device

    def to(self, device) -> "TriMesh":
        """A copy with every tensor field, and the tensors of the lattice,
        banded and hybrid routes, on ``device``."""
        moved = {f.name: getattr(self, f.name).to(device)
                 for f in dataclasses.fields(self)
                 if isinstance(getattr(self, f.name), torch.Tensor)}
        for name in ("lattice", "banded", "banded_paired", "hybrid"):
            if getattr(self, name) is not None:
                moved[name] = getattr(self, name).to(device)
        return dataclasses.replace(self, **moved)

    @classmethod
    def from_arrays(cls, coords, connectivity, geom_boundary_mask=None,
                    dirichlet_mask=None, neumann_mask=None,
                    neumann_edges=None, dtype=torch.float32,
                    device=None, build_incidence=True, build_banded="auto",
                    build_lattice=True, build_fused=True) -> "TriMesh":
        """Normalize host arrays into a TriMesh on ``device`` (the card
        unless given), building the incidence and fused edge tables.

        build_incidence: False leaves ``incidence`` None, so that the
        energy backward scatter-adds (element-sharded meshes need it), and
        then builds neither the banded nor the fused tables, as in the JAX
        package.

        build_banded: "auto" builds the banded tables when a gather table
        would pass 250,000 rows (``max(N, 3 Ne)``, the JAX package's
        threshold), True forces them, False skips them, "nopair" builds
        the triangle tables only.  The paired tables follow the triangle
        tables unless ``HDNN_NO_PAIR`` is set; ``HDNN_STRIPS`` asks for
        the k=6 strip tables instead (pairs if the mesh does not strip),
        as in the JAX package.
        build_lattice: run ``detect_lattice`` (on the coordinates as cast
        to ``dtype``, as the JAX package does), so that lattice-topology
        meshes take the gather-free energy route.
        build_fused: build the fused domain + edge tables."""
        device = resolve_device(device)
        coords_t = torch.tensor(np.asarray(coords), dtype=dtype)
        n = coords_t.shape[0]

        def _mask(m):
            if m is None:
                return torch.zeros((n,), dtype=torch.bool, device=device)
            return torch.tensor(np.asarray(m, dtype=bool), device=device)

        def _int(a):
            return torch.tensor(np.asarray(a, dtype=np.int32), device=device)

        if neumann_edges is None:
            neumann_edges = np.zeros((0, 2), dtype=np.int32)
        conn_np = np.asarray(connectivity)
        edges_np = np.asarray(neumann_edges)
        # the CUDA kernels index the node table with these unchecked
        for name, table in (("connectivity", conn_np),
                            ("neumann_edges", edges_np)):
            if table.size and (table.min() < 0 or table.max() >= n):
                raise ValueError(f"{name} indexes nodes outside [0, {n})")
        inc_np = (build_incidence_table(conn_np, n)
                  if build_incidence and conn_np.size else None)

        banded = banded_paired = None
        want_banded = (build_banded in (True, "nopair") or (
            build_banded == "auto" and conn_np.size
            and max(n, 3 * conn_np.shape[0]) > 250_000))
        if want_banded and inc_np is not None:
            banded = build_banded_assembly(conn_np, n, inc_np, device=device)
            if (banded is not None and build_banded != "nopair"
                    and not os.environ.get("HDNN_NO_PAIR")):
                if os.environ.get("HDNN_STRIPS"):
                    banded_paired = build_striped_assembly(conn_np, n,
                                                           device=device)
                if banded_paired is None:
                    banded_paired = build_paired_assembly(conn_np, n,
                                                          device=device)

        lattice = None
        if build_lattice and conn_np.size:
            lattice = detect_lattice(coords_t.numpy(), conn_np, edges_np,
                                     device=device)

        fused_conn = fused_inc = None
        if build_fused and build_incidence and conn_np.size \
                and edges_np.size:
            edge_tri = np.concatenate(
                [edges_np, edges_np[:, 1:2]], axis=1)     # (n0, n1, n1)
            fused_conn = np.concatenate(
                [conn_np, edge_tri]).astype(np.int32)
            fused_inc = build_incidence_table(fused_conn, n)

        return cls(
            coords=coords_t.to(device),
            connectivity=_int(conn_np),
            geom_boundary_mask=_mask(geom_boundary_mask),
            dirichlet_mask=_mask(dirichlet_mask),
            neumann_mask=_mask(neumann_mask),
            neumann_edges=_int(edges_np).reshape(-1, 2),
            incidence=_int(inc_np) if inc_np is not None else None,
            banded=banded,
            banded_paired=banded_paired,
            fused_connectivity=(_int(fused_conn)
                                if fused_conn is not None else None),
            fused_incidence=(_int(fused_inc)
                             if fused_inc is not None else None),
            lattice=lattice,
        )

    def astuple(self):
        """The reference's 6-tuple contract: (coords, connectivity,
        geom_boundary_mask, dirichlet_mask, neumann_mask, neumann_edges)."""
        return (self.coords, self.connectivity, self.geom_boundary_mask,
                self.dirichlet_mask, self.neumann_mask, self.neumann_edges)
