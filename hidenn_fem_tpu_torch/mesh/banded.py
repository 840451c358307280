"""Banded (blocked-window) assembly tables (port of
``hidenn_fem_tpu/mesh/banded.py``).

After a locality-preserving node order (``rcm_node_order``; structured
meshes are banded already), consecutive elements reference nodes in a
narrow window.  The tables cut the elements into a few blocks, each with
its node window and window-relative connectivity, and the nodes into
blocks over windows of the element cotangents.  The JAX package built them
to keep every TPU gather below its ~256K-row table cliff; on the card they
are what the banded kernels K3-K5 (``ops/banded_energy.py``) walk.

Everything here is host numpy, built once, with the JAX package's numpy
algorithms, or its native library's (``mesh/native.py``, when built): the
tables are array-equal to the JAX package's either way.
``BandedAssembly`` holds them as int32 tensors; ``.to(device)`` moves
them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["BandedAssembly", "build_banded_assembly",
           "build_paired_assembly", "build_striped_assembly",
           "pair_connectivity", "strip_connectivity", "rcm_node_order",
           "reorder_mesh"]

# the JAX package's window bound (its TPU gather cliff), kept so that the
# tables, and the route a mesh takes, are the same in both packages
WINDOW_LIMIT = 196_608
_BLOCK_CANDIDATES = (4, 8, 16, 32, 64, 128)

_TABLES = ("starts", "conn_rel", "ct_starts", "inc_rel", "re_nstarts",
           "re_estarts", "re_conn_rel", "re_inc_rel", "re_own_lo",
           "re_own_hi")


@dataclasses.dataclass(frozen=True)
class BandedAssembly:
    """Blocked-window assembly tables (int32 tensors).

    Forward (element blocks over node windows):
      starts:   [B] node-window start row per element block.
      conn_rel: [B, EB, k] window-relative connectivity; padding rows
        repeat the last element's first node (exactly zero energy and
        cotangent).

    Backward (node blocks over windows of the flat [B*EB*k] cotangent
    rows):
      ct_starts: [Bn] cotangent-window start row per node block.
      inc_rel:   [Bn, NB, maxdeg] window-relative incidence; unused slots
        hold ``wct`` (the sentinel, a zero row).

    Recompute backward (node blocks over element windows):
      re_nstarts:  [Br] node-window start per node block.
      re_estarts:  [Br] element-window start per node block.
      re_conn_rel: [Br, EW, k] element-window connectivity relative to
        ``re_nstarts``.
      re_inc_rel:  [Br, NBr, maxdeg] flat (e_rel*k + slot) indices into
        the block's [EW*k] cotangent rows; unused slots hold k*EW.
      re_own_lo/re_own_hi: [Br] window-relative ownership intervals whose
        half-open ranges partition [0, Ne), so that a value-and-grad over
        the node blocks counts each element once; None when the windows do
        not tile [0, Ne) in order.

    ``k`` is the vertex slots per row: 3 triangles, 4 edge-paired
    triangle pairs ((0,1,2) and (0,1,3); unmatched triangles repeat slot 0
    in slot 3), 6 four-triangle strips (triangle i is slots i..i+2).
    """

    starts: torch.Tensor
    conn_rel: torch.Tensor
    ct_starts: torch.Tensor
    inc_rel: torch.Tensor
    re_nstarts: Optional[torch.Tensor] = None
    re_estarts: Optional[torch.Tensor] = None
    re_conn_rel: Optional[torch.Tensor] = None
    re_inc_rel: Optional[torch.Tensor] = None
    re_own_lo: Optional[torch.Tensor] = None
    re_own_hi: Optional[torch.Tensor] = None
    wnode: int = 0
    wct: int = 0
    re_wnode: int = 0
    re_ew: int = 0
    k: int = 3

    @property
    def n_element_blocks(self) -> int:
        return self.conn_rel.shape[0]

    @property
    def elements_per_block(self) -> int:
        return self.conn_rel.shape[1]

    def to(self, device) -> "BandedAssembly":
        """A copy with every table on ``device``."""
        return dataclasses.replace(self, **{
            name: getattr(self, name).to(device) for name in _TABLES
            if getattr(self, name) is not None})


def build_banded_assembly(connectivity: np.ndarray, n_nodes: int,
                          incidence: np.ndarray,
                          window_limit: int = WINDOW_LIMIT,
                          block_multiple: int = 1, device=None
                          ) -> Optional[BandedAssembly]:
    """A BandedAssembly (tensors on ``device``, the card unless given), or
    None if no candidate block count keeps every node window under
    ``window_limit``.

    ``block_multiple``: every block count is a multiple of it (the rank
    count of an element-sharded run, where each rank walks a contiguous
    slice of the blocks: ``parallel/sharding.py``)."""
    device = resolve_device(device)
    conn = np.asarray(connectivity, dtype=np.int64)
    ne = conn.shape[0]
    k = conn.shape[1] if conn.ndim == 2 else 3
    if ne == 0:
        return None

    def t(a):
        return torch.tensor(np.asarray(a, dtype=np.int32), device=device)

    from . import native
    if k == 3 and native.available():
        tb = native.banded_tables(connectivity, n_nodes, incidence,
                                  window_limit, block_multiple)
        if tb is None:
            return None
        if "re_estarts" in tb:
            own = _ownership_intervals(tb["re_estarts"], tb["re_ew"], ne)
            if own is not None:
                tb["re_own_lo"], tb["re_own_hi"] = own
        return BandedAssembly(**{name: v if isinstance(v, int) else t(v)
                                 for name, v in tb.items()})

    # ---- forward tables: element blocks -> node windows
    fwd = None
    for b in _BLOCK_CANDIDATES:
        if b % block_multiple:
            continue
        eb = -(-ne // b)
        pad = b * eb - ne
        # pad with a degenerate row of the last element's first node: zero
        # contribution, and it stays inside the last block's band
        pad_row = np.full((pad, k), conn[-1, 0], np.int64)
        conn_p = np.concatenate([conn, pad_row]) if pad else conn
        blocks = conn_p.reshape(b, eb, k)
        wmin = blocks.reshape(b, -1).min(axis=1)
        wmax = blocks.reshape(b, -1).max(axis=1)
        wsize = int((wmax - wmin + 1).max())
        if wsize <= window_limit:
            wnode = min(wsize, n_nodes)
            starts = np.minimum(wmin, n_nodes - wnode).astype(np.int32)
            conn_rel = (blocks - starts[:, None, None]).astype(np.int32)
            fwd = (starts, conn_rel, wnode)
            break
    if fwd is None:
        return None

    # ---- backward tables: node blocks -> cotangent windows
    inc = np.asarray(incidence, dtype=np.int64)      # [N, maxdeg], -1 pad
    n, maxdeg = inc.shape
    n_ct_rows = ne * k
    bwd = None
    for bn in _BLOCK_CANDIDATES:
        if bn % block_multiple:
            continue
        nb = -(-n // bn)
        pad = bn * nb - n
        inc_p = np.concatenate(
            [inc, np.full((pad, maxdeg), -1, np.int64)]) if pad else inc
        blocks = inc_p.reshape(bn, nb, maxdeg)
        valid = blocks >= 0
        big = np.where(valid, blocks, np.int64(n_ct_rows))
        small = np.where(valid, blocks, np.int64(-1))
        wmin = big.reshape(bn, -1).min(axis=1)
        wmax = small.reshape(bn, -1).max(axis=1)
        empty = wmax < 0
        wmin = np.where(empty, 0, wmin)
        wmax = np.where(empty, 0, wmax)
        wsize = int((wmax - wmin + 1).max())
        if wsize <= window_limit:
            wct = min(wsize, n_ct_rows)
            ct_starts = np.minimum(wmin, n_ct_rows - wct).astype(np.int32)
            rel = blocks - ct_starts[:, None, None]
            rel = np.where(valid, rel, np.int64(wct)).astype(np.int32)
            bwd = (ct_starts, rel, wct)
            break
    if bwd is None:
        return None

    starts, conn_rel, wnode = fwd
    ct_starts, inc_rel, wct = bwd
    re = _build_recompute_tables(conn, inc, n_nodes, ne, window_limit,
                                 block_multiple)
    re_kwargs = {}
    if re is not None:
        nstarts, estarts, re_conn_rel, re_inc_rel, re_wnode, re_ew = re
        re_kwargs = dict(re_nstarts=t(nstarts), re_estarts=t(estarts),
                         re_conn_rel=t(re_conn_rel), re_inc_rel=t(re_inc_rel),
                         re_wnode=re_wnode, re_ew=re_ew)
        own = _ownership_intervals(estarts, re_ew, ne)
        if own is not None:
            re_kwargs["re_own_lo"] = t(own[0])
            re_kwargs["re_own_hi"] = t(own[1])
    return BandedAssembly(starts=t(starts), conn_rel=t(conn_rel),
                          ct_starts=t(ct_starts), inc_rel=t(inc_rel),
                          wnode=wnode, wct=wct, k=k, **re_kwargs)


def _build_recompute_tables(conn, inc, n_nodes, ne, window_limit,
                            block_multiple=1):
    """Tables of the recompute backward (see the class docstring): the
    smallest node-block count (a multiple of ``block_multiple``) whose
    element windows keep both k*EW and the node window under
    ``window_limit``, or None."""
    n = inc.shape[0]
    maxdeg = inc.shape[1]
    k = conn.shape[1]
    rmin = conn.min(axis=1)
    rmax = conn.max(axis=1)
    for br in _BLOCK_CANDIDATES:
        if br % block_multiple:
            continue
        nb = -(-n // br)
        pad = br * nb - n
        inc_p = np.concatenate(
            [inc, np.full((pad, maxdeg), -1, np.int64)]) if pad else inc
        blocks = inc_p.reshape(br, nb, maxdeg)
        valid = blocks >= 0
        e_of = np.where(valid, blocks // k, np.int64(-1))
        emin = np.where(valid, e_of, np.int64(ne)).reshape(br, -1).min(1)
        emax = e_of.reshape(br, -1).max(1)
        empty = emax < 0
        emin = np.where(empty, 0, emin)
        emax = np.where(empty, 0, emax)
        ew = int((emax - emin + 1).max())
        if k * ew > window_limit:
            continue
        ew = min(ew, ne)
        estarts = np.minimum(emin, ne - ew).astype(np.int64)
        nmin = np.array([rmin[s:s + ew].min() for s in estarts])
        nmax = np.array([rmax[s:s + ew].max() for s in estarts])
        wn = int((nmax - nmin + 1).max())
        if wn > window_limit:
            continue
        wn = min(wn, n_nodes)
        nstarts = np.minimum(nmin, n_nodes - wn).astype(np.int64)
        conn_win = np.stack([conn[s:s + ew] for s in estarts])
        conn_rel = (conn_win - nstarts[:, None, None]).astype(np.int32)
        rel3 = blocks - k * estarts[:, None, None]
        rel3 = np.where(valid, rel3, np.int64(k * ew)).astype(np.int32)
        return (nstarts.astype(np.int32), estarts.astype(np.int32),
                conn_rel, rel3, wn, ew)
    return None


def _ownership_intervals(estarts, ew, ne):
    """Window-relative ownership intervals (lo, hi) int32 of the recompute
    node blocks, assigned greedily left to right so that the owned ranges
    partition [0, ne); None when the windows leave a gap."""
    s = np.asarray(estarts, dtype=np.int64)
    lo = np.empty(s.shape[0], np.int64)
    hi = np.empty(s.shape[0], np.int64)
    cur = 0
    for i, si in enumerate(s):
        if cur < si:       # gap: elements [cur, si) not in this window
            return None
        lo[i] = cur
        cur = max(cur, min(si + ew, ne))
        hi[i] = cur
    if cur != ne:
        return None
    return ((lo - s).astype(np.int32), (hi - s).astype(np.int32))


def pair_connectivity(connectivity: np.ndarray) -> Optional[np.ndarray]:
    """Edge-pair triangles into 4-slot rows (greedy maximal matching).

    Slots (0, 1) are the shared edge, (0, 1, 2) and (0, 1, 3) the two
    triangles.  Unmatched triangles become degenerate pairs with slot 3
    repeating slot 0 (exactly zero energy and cotangent).  Rows are sorted
    by min node to keep the windows' locality.  None when fewer than half
    the triangles pair."""
    conn = np.asarray(connectivity, dtype=np.int64)
    ne = conn.shape[0]
    if ne < 2 or conn.shape[1] != 3:
        return None
    edges = np.concatenate(
        [conn[:, [0, 1]], conn[:, [1, 2]], conn[:, [2, 0]]], axis=0)
    opp = np.concatenate([conn[:, 2], conn[:, 0], conn[:, 1]])
    tri = np.tile(np.arange(ne), 3)
    edges = np.sort(edges, axis=1)
    order = np.lexsort((edges[:, 1], edges[:, 0]))
    es, ts, os_ = edges[order], tri[order], opp[order]
    shared = np.where((es[1:] == es[:-1]).all(axis=1))[0]
    accept, matched = _greedy_match(ts[shared], ts[shared + 1], ne)
    if 2 * int(accept.sum()) < ne // 2:
        return None
    i = shared[accept]
    paired = np.stack([es[i, 0], es[i, 1], os_[i], os_[i + 1]], axis=1)
    rest = conn[~matched]
    if rest.size:
        filler = np.concatenate([rest, rest[:, :1]], axis=1)
        paired = np.concatenate([paired, filler], axis=0)
    return paired[np.argsort(paired.min(axis=1), kind="stable")]


def _greedy_match(a_all: np.ndarray, b_all: np.ndarray, ne: int):
    """Sequential first-come greedy matching over ordered candidate pairs:
    accept candidate i iff neither endpoint was claimed by an earlier
    accepted candidate.  The candidates' order is the quality lever (edge
    lexsort order pairs nearly every triangle).  The native library's loop
    (``mesh/native.py``) runs when it is built; else the loop runs on
    Python lists and bytearrays, which index far faster than numpy
    scalars.  Both give the same result.

    Returns (accept [n_cand] bool, matched [ne] bool)."""
    from . import native
    if native.available():
        return native.greedy_match(a_all, b_all, ne)
    a_list = np.asarray(a_all, dtype=np.int64).tolist()
    b_list = np.asarray(b_all, dtype=np.int64).tolist()
    accept = bytearray(len(a_list))
    matched = bytearray(ne)
    for i, (a, b) in enumerate(zip(a_list, b_list)):
        if matched[a] or matched[b]:
            continue
        matched[a] = matched[b] = 1
        accept[i] = 1
    return (np.frombuffer(bytes(accept), dtype=np.uint8).astype(bool),
            np.frombuffer(bytes(matched), dtype=np.uint8).astype(bool))


def strip_connectivity(connectivity: np.ndarray):
    """Merge edge-paired triangle pairs into 6-node 4-triangle strips.

    Triangle ``i`` of a row is slots ``(i, i+1, i+2)``.  A pair P extends
    a pair Q across a shared outer edge iff they interlock (the
    end-opposite vertex of each lies on the other's internal edge);
    greedy matching over interlocking joins; leftovers ride as strips
    whose trailing triangles are degenerate (exactly zero energy and
    cotangent).

    Returns ``(strips [S, 6] int64, keep [S, 6] bool)`` (``keep`` flags
    the slots with a live cotangent), or None when the mesh does not
    pair."""
    paired = pair_connectivity(connectivity)
    if paired is None:
        return None
    real = paired[:, 3] != paired[:, 0]
    rows = paired[real]
    fillers = paired[~real]
    r = rows.shape[0]

    # candidate joins: the 4 outer edges per pair row (2 per end tri),
    # with (row, p = the internal vertex on the edge, o = end opposite)
    edges, meta = [], []
    for k in (2, 3):
        o = rows[:, k]
        for j in (0, 1):
            p = rows[:, j]
            edges.append(np.stack([np.minimum(p, o),
                                   np.maximum(p, o)], axis=1))
            meta.append(np.stack([np.arange(r), p, o], axis=1))
    e = np.concatenate(edges) if r else np.empty((0, 2), np.int64)
    m = np.concatenate(meta) if r else np.empty((0, 3), np.int64)
    nmax = int(connectivity.max()) + 1 if connectivity.size else 1
    key = e[:, 0] * nmax + e[:, 1]
    order = np.argsort(key, kind="stable")
    ks, ms = key[order], m[order]
    same = np.nonzero(ks[1:] == ks[:-1])[0]
    a_m, b_m = ms[same], ms[same + 1]
    valid = ((a_m[:, 0] != b_m[:, 0])
             & (a_m[:, 2] == b_m[:, 1]) & (b_m[:, 2] == a_m[:, 1]))
    a_m, b_m = a_m[valid], b_m[valid]
    accept, matched = _greedy_match(a_m[:, 0], b_m[:, 0], r)

    out, keep = [], []
    ja, jb = a_m[accept], b_m[accept]
    if ja.shape[0]:
        ra, pa, oa = ja[:, 0], ja[:, 1], ja[:, 2]
        rb, pb, ob = jb[:, 0], jb[:, 1], jb[:, 2]
        # T1 = A's non-join tri, T2 = A's join tri, T3 = B's join tri,
        # T4 = B's non-join tri
        v0 = np.where(rows[ra, 3] == oa, rows[ra, 2], rows[ra, 3])
        v2 = pa
        v1 = np.where(rows[ra, 0] == pa, rows[ra, 1], rows[ra, 0])
        v3 = oa                                   # == pb, on B.internal
        v4 = np.where(rows[rb, 0] == v3, rows[rb, 1], rows[rb, 0])
        v5 = np.where(rows[rb, 3] == ob, rows[rb, 2], rows[rb, 3])
        strips = np.stack([v0, v1, v2, v3, v4, v5], axis=1)
        out.append(strips)
        keep.append(np.ones(strips.shape, bool))
    rest = rows[~matched]
    if rest.shape[0]:
        # leftover pair (a, b | c, d): strip (c, a, b, d, b, d), T3/T4
        # degenerate, slots 4/5 dead
        lp = np.stack([rest[:, 2], rest[:, 0], rest[:, 1], rest[:, 3],
                       rest[:, 1], rest[:, 3]], axis=1)
        out.append(lp)
        km = np.ones(lp.shape, bool)
        km[:, 4:] = False
        keep.append(km)
    if fillers.shape[0]:
        # lone triangle (a, b, c): strip (a, b, c, b, c, b), T2..T4
        # degenerate, slots 3/4/5 dead
        ft = np.stack([fillers[:, 0], fillers[:, 1], fillers[:, 2],
                       fillers[:, 1], fillers[:, 2], fillers[:, 1]],
                      axis=1)
        out.append(ft)
        km = np.ones(ft.shape, bool)
        km[:, 3:] = False
        keep.append(km)
    if not out:
        return None
    strips = np.concatenate(out)
    keep = np.concatenate(keep)
    perm = np.argsort(strips.min(axis=1), kind="stable")
    return strips[perm], keep[perm]


def build_striped_assembly(connectivity: np.ndarray, n_nodes: int,
                           window_limit: int = WINDOW_LIMIT,
                           block_multiple: int = 1, device=None
                           ) -> Optional[BandedAssembly]:
    """Strip-merged BandedAssembly (``k=6``), or None when the mesh does
    not strip or band; ``block_multiple`` as in
    ``build_banded_assembly``."""
    sk = strip_connectivity(connectivity)
    if sk is None:
        return None
    strips, keep = sk
    inc = _incidence_k(strips, n_nodes, keep=keep)
    return build_banded_assembly(strips, n_nodes, inc,
                                 window_limit=window_limit,
                                 block_multiple=block_multiple, device=device)


def _incidence_k(conn: np.ndarray, n_nodes: int,
                 keep: Optional[np.ndarray] = None) -> np.ndarray:
    """[N, maxdeg] incidence into the flat [Nq*k] cotangent rows, -1
    padded.  Dead slots (``keep`` False, or a pair's filler slot 3) are
    left out: their cotangent is exactly zero."""
    nq, k = conn.shape
    nodes = conn.reshape(-1)
    rows = np.arange(nodes.size, dtype=np.int64)
    if keep is not None:                   # explicit dead-slot mask
        keep = np.asarray(keep, bool).reshape(-1)
    else:
        keep = np.ones(nodes.size, bool)
        if k == 4:
            keep[3::4] = conn[:, 3] != conn[:, 0]
    nodes, rows = nodes[keep], rows[keep]
    counts = np.bincount(nodes, minlength=n_nodes)
    maxdeg = max(int(counts.max()), 1)
    starts = np.zeros(n_nodes + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    order = np.argsort(nodes, kind="stable")
    fn, rr = nodes[order], rows[order]
    rank = np.arange(fn.size) - starts[fn]
    inc = np.full((n_nodes, maxdeg), -1, np.int64)
    inc[fn, rank] = rr
    return inc


def build_paired_assembly(connectivity: np.ndarray, n_nodes: int,
                          window_limit: int = WINDOW_LIMIT,
                          block_multiple: int = 1, device=None
                          ) -> Optional[BandedAssembly]:
    """Quad-paired BandedAssembly (``k=4``), or None when the mesh does
    not pair or band; ``block_multiple`` as in
    ``build_banded_assembly``."""
    paired = pair_connectivity(connectivity)
    if paired is None:
        return None
    inc = _incidence_k(paired, n_nodes)
    return build_banded_assembly(paired, n_nodes, inc,
                                 window_limit=window_limit,
                                 block_multiple=block_multiple, device=device)


def reorder_mesh(mesh, build_banded="auto"):
    """Bandwidth-reducing reorder of a TriMesh: RCM node permutation,
    connectivity renumbered, elements sorted by smallest node, every
    table rebuilt (on the mesh's device).  Params built for the old order
    do not transfer."""
    from .types import TriMesh

    conn = mesh.connectivity.cpu().numpy()
    n = mesh.n_nodes
    perm = rcm_node_order(conn, n)                 # new_pos -> old_index
    inv = np.empty(n, dtype=np.int64)
    inv[perm] = np.arange(n)
    new_conn = inv[conn]
    order = np.argsort(new_conn.min(axis=1), kind="stable")
    new_conn = new_conn[order]

    def _p(x):
        return x.cpu().numpy()[perm]

    ne = mesh.neumann_edges.cpu().numpy()
    return TriMesh.from_arrays(
        coords=_p(mesh.coords),
        connectivity=new_conn,
        geom_boundary_mask=_p(mesh.geom_boundary_mask),
        dirichlet_mask=_p(mesh.dirichlet_mask),
        neumann_mask=_p(mesh.neumann_mask),
        neumann_edges=inv[ne] if ne.size else ne,
        dtype=mesh.coords.dtype, device=mesh.device,
        build_banded=build_banded)


def rcm_node_order(connectivity: np.ndarray, n_nodes: int) -> np.ndarray:
    """Reverse-Cuthill-McKee node permutation ``perm`` (new position ->
    old index) for general unstructured meshes."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    conn = np.asarray(connectivity, dtype=np.int64)
    rows = np.concatenate([conn[:, 0], conn[:, 1], conn[:, 2]])
    cols = np.concatenate([conn[:, 1], conn[:, 2], conn[:, 0]])
    data = np.ones(rows.size, dtype=np.int8)
    adj = sp.coo_matrix((data, (rows, cols)), shape=(n_nodes, n_nodes))
    adj = (adj + adj.T).tocsr()
    return np.asarray(reverse_cuthill_mckee(adj, symmetric_mode=True))
