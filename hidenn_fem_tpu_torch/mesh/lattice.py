"""Lattice detection (port of ``hidenn_fem_tpu/mesh/lattice.py``): route
lattice-topology TriMeshes through the gather-free energy.

The meshes that ``generate_mesh`` produces are lattice triangulations:
node (i, j) of an nx-by-ny grid, one diagonal per quad, holes punched by
deleting nodes (or, with ``keep_dead_nodes=True``, by dropping only the
triangles).  For those, each element's corners are slices of the
[nx, ny, 4] node lattice, so the energy needs no connectivity gather
(``ops/lattice_energy.py``, and the stencil kernels of
``ops/lattice_slab.py``).

``detect_lattice`` recovers the lattice from a (coords, connectivity,
neumann_edges) triple with host numpy, once at mesh build, and returns
None for a mesh that is not one.  It gives the same arrays and the same
static flags as the JAX package's, and rejects the same meshes.  The JAX
package's windowed and chunked fill tables (``_window_maps``,
``_chunk_maps``, opt-in TPU layout experiments that its detection does not
build by default) are not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["LatticeRoute", "detect_lattice"]


@dataclasses.dataclass(frozen=True)
class LatticeRoute:
    """Recovered lattice structure of a TriMesh.

    Attributes:
      sel: [nx-1, ny-1] float32, 1 where the quad splits along the n00-n11
        ("up") diagonal, 0 for n10-n01 ("down"); 1 for empty quads.
      t1 / t2: [nx-1, ny-1] float32 presence masks of the first / second
        triangle of each quad's split (holes drop triangles).
      inv_map: [nx*ny] int32, lattice position -> mesh node id, with
        n_nodes as the sentinel for deleted (hole) positions.
      fwd_map: [N] int32, mesh node id -> lattice position (every node has
        exactly one position, so the fill's backward is a gather).
      edge_masks: face -> float32 segment mask ("left"/"right": [ny-1],
        "up"/"down": [nx-1]) carrying the Neumann edges.
      nx / ny: lattice shape.
      identity: the node numbering IS the lattice numbering (the fill is a
        reshape).
      prefix_identity: the first nx*ny nodes are the lattice in order and
        other nodes follow (the hybrid meshes; the fill is a slice).
        Detection never sets it.
      uniform_sel: "up" / "down" when every quad splits along that
        diagonal, else "".
      all_present: t1 == t2 == 1 everywhere.
    """

    sel: torch.Tensor
    t1: torch.Tensor
    t2: torch.Tensor
    inv_map: torch.Tensor
    fwd_map: torch.Tensor
    edge_masks: Dict[str, torch.Tensor]
    nx: int = 0
    ny: int = 0
    identity: bool = False
    prefix_identity: bool = False
    uniform_sel: str = ""
    all_present: bool = False

    def to(self, device) -> "LatticeRoute":
        """A copy with every tensor (the edge masks too) on ``device``."""
        return dataclasses.replace(
            self, sel=self.sel.to(device), t1=self.t1.to(device),
            t2=self.t2.to(device), inv_map=self.inv_map.to(device),
            fwd_map=self.fwd_map.to(device),
            edge_masks={k: v.to(device) for k, v in self.edge_masks.items()})


def detect_lattice(coords: np.ndarray, connectivity: np.ndarray,
                   neumann_edges: np.ndarray, device=None
                   ) -> Optional[LatticeRoute]:
    """Recover the lattice structure (tensors on ``device``, the card
    unless given), or None if the mesh isn't one."""
    device = resolve_device(device)
    coords = np.asarray(coords)
    conn = np.asarray(connectivity, dtype=np.int64)
    edges = np.asarray(neumann_edges, dtype=np.int64)
    n = coords.shape[0]
    if n < 4 or conn.shape[0] < 2:
        return None

    # node -> (i, j): exact match against the unique coordinate levels.  A
    # true lattice has nx*ny ~ N; irregular meshes explode the product,
    # which is the cheap rejection.
    xs = np.unique(coords[:, 0])
    ys = np.unique(coords[:, 1])
    nx, ny = xs.size, ys.size
    if nx < 2 or ny < 2 or nx * ny > 4 * n or nx * ny < n:
        return None
    i = np.searchsorted(xs, coords[:, 0])
    j = np.searchsorted(ys, coords[:, 1])
    pos = i * ny + j
    if np.unique(pos).size != n:     # two nodes on one lattice site
        return None

    # classify every triangle into (quad, diagonal, slot)
    pi = pos[conn] // ny             # [Ne, 3] lattice i per vertex
    pj = pos[conn] % ny
    qi = pi.min(axis=1)
    qj = pj.min(axis=1)
    di = pi - qi[:, None]
    dj = pj - qj[:, None]
    if (di > 1).any() or (dj > 1).any() or (qi >= nx - 1).any() \
            or (qj >= ny - 1).any():
        return None
    # corner codes 0:n00 1:n01 2:n10 3:n11; the four 3-subsets of a quad's
    # corners are its four possible triangles, keyed by their code sum:
    # 5 = up-T1 (n00,n10,n11), 4 = up-T2 (n00,n11,n01),
    # 3 = down-T1 (n00,n10,n01), 6 = down-T2 (n10,n11,n01).
    code = di * 2 + dj
    srt = np.sort(code, axis=1)
    if (srt[:, :-1] == srt[:, 1:]).any():   # repeated vertex
        return None
    s = code.sum(axis=1)
    quad = qi * (ny - 1) + qj
    is_up = (s == 5) | (s == 4)
    slot1 = (s == 5) | (s == 3)

    nq = (nx - 1) * (ny - 1)
    up_cnt = np.zeros(nq, np.int64)
    dn_cnt = np.zeros(nq, np.int64)
    np.add.at(up_cnt, quad[is_up], 1)
    np.add.at(dn_cnt, quad[~is_up], 1)
    if ((up_cnt > 0) & (dn_cnt > 0)).any():   # mixed diagonals in a quad
        return None
    t1 = np.zeros(nq, np.float32)
    t2 = np.zeros(nq, np.float32)
    # duplicate triangles (same quad, same slot) are not a lattice
    slot = (~slot1).astype(np.int64)
    if np.unique(quad * 2 + slot).size != conn.shape[0]:
        return None
    t1[quad[slot1]] = 1.0
    t2[quad[~slot1]] = 1.0
    sel = (up_cnt > 0).astype(np.float32)
    sel[(up_cnt == 0) & (dn_cnt == 0)] = 1.0   # empty quads: any

    # Neumann edges must be face segments
    edge_masks = {}
    if edges.size:
        ea, eb = pos[edges[:, 0]], pos[edges[:, 1]]
        ia, ja = ea // ny, ea % ny
        ib, jb = eb // ny, eb % ny
        vert = (ia == ib) & (np.abs(ja - jb) == 1)
        horz = (ja == jb) & (np.abs(ia - ib) == 1)
        left = vert & (ia == 0)
        right = vert & (ia == nx - 1)
        down = horz & (ja == 0)
        up = horz & (ja == ny - 1)
        if not (left | right | down | up).all():
            return None
        for name, m, seg, size in (
                ("left", left, np.minimum(ja, jb), ny - 1),
                ("right", right, np.minimum(ja, jb), ny - 1),
                ("down", down, np.minimum(ia, ib), nx - 1),
                ("up", up, np.minimum(ia, ib), nx - 1)):
            if m.any():
                mask = np.zeros(size, np.float32)
                mask[seg[m]] = 1.0
                edge_masks[name] = torch.tensor(mask, device=device)

    identity = bool(n == nx * ny and (pos == np.arange(n)).all())
    inv_map = np.full(nx * ny, n, np.int32)
    inv_map[pos] = np.arange(n, dtype=np.int32)

    def tensor(a):
        return torch.tensor(a, device=device)

    return LatticeRoute(
        sel=tensor(sel.reshape(nx - 1, ny - 1)),
        t1=tensor(t1.reshape(nx - 1, ny - 1)),
        t2=tensor(t2.reshape(nx - 1, ny - 1)),
        inv_map=tensor(inv_map),
        fwd_map=tensor(pos.astype(np.int32)),
        edge_masks=edge_masks,
        nx=int(nx), ny=int(ny), identity=identity,
        uniform_sel=("up" if (sel == 1.0).all()
                     else "down" if (sel == 0.0).all() else ""),
        all_present=bool((t1 == 1.0).all() and (t2 == 1.0).all()))
