"""Greedy node coloring of the mesh adjacency graph (port of
``hidenn_fem_tpu/mesh/coloring.py``; host numpy, no torch).

Two nodes are adjacent iff they share an element edge, which is exactly
the sparsity pattern of the P1 stiffness matrix, so a proper coloring
lets the stiffness diagonal be extracted exactly, matrix-free, with one
probe matvec per (color, displacement component): for probe ``z_c``
(ones on color-c nodes), ``(K z_c)_i = K_ii`` for every color-c node i
(no two same-color nodes couple).  ``solve/linear.py:jacobi_diagonal``
probes that way.

``color_nodes`` colors with the native library (``mesh/native.py``, a
sequential greedy pass in node order) when that is built, and with the
vectorized Jones–Plassmann rounds below otherwise, as the JAX package
does; either path's colors are the JAX package's same path's array for
array (the rounds take the same ``default_rng(0)`` priorities).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["color_nodes", "check_coloring"]


def _numpy(a) -> np.ndarray:
    """A host numpy array of a tensor (any device) or an array-like."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _adjacency(connectivity: np.ndarray, n_nodes: int):
    """CSR adjacency (offsets, neighbors) from unique undirected edges."""
    c = np.asarray(connectivity, dtype=np.int64)
    pairs = np.concatenate([c[:, [0, 1]], c[:, [1, 2]], c[:, [0, 2]]])
    pairs.sort(axis=1)
    keys = np.unique(pairs[:, 0] * np.int64(n_nodes) + pairs[:, 1])
    u, v = keys // n_nodes, keys % n_nodes
    src = np.concatenate([u, v])
    dst = np.concatenate([v, u])
    order = np.argsort(src, kind="stable")
    src, dst = src[order], dst[order]
    offsets = np.zeros(n_nodes + 1, dtype=np.int64)
    np.add.at(offsets, src + 1, 1)
    np.cumsum(offsets, out=offsets)
    return offsets, dst


def _greedy_color_numpy(connectivity: np.ndarray, n_nodes: int
                        ) -> np.ndarray:
    """Vectorized Jones–Plassmann greedy coloring.

    Each round colors every uncolored node whose random priority beats
    all its uncolored neighbours, with the smallest color absent from its
    colored neighbourhood, computed for all nodes at once with a uint64
    forbidden-color bitmask (meshes color in 4-8, so 64 bits is plenty;
    more than 63 colors raise).  Expected O(log n) rounds, each O(E)
    numpy work.
    """
    offsets, adj = _adjacency(connectivity, n_nodes)
    deg = np.diff(offsets)
    nonempty = deg > 0          # reduceat misreads empty segments
    starts = offsets[:-1]
    colors = np.full(n_nodes, -1, dtype=np.int32)
    rng = np.random.default_rng(0)
    prio = rng.permutation(n_nodes).astype(np.int64)
    uncolored = colors < 0
    while uncolored.any():
        # forbidden colors from already-colored neighbours
        nb_col = colors[adj]
        bits = np.where(nb_col >= 0,
                        np.uint64(1) << nb_col.astype(np.uint64),
                        np.uint64(0))
        forbid = np.zeros(n_nodes, np.uint64)
        forbid[nonempty] = np.bitwise_or.reduceat(
            bits, starts[nonempty])
        # local priority maxima among uncolored nodes get colored
        nb_prio = np.where(uncolored[adj], prio[adj], np.int64(-1))
        best = np.full(n_nodes, -1, dtype=np.int64)
        best[nonempty] = np.maximum.reduceat(nb_prio, starts[nonempty])
        win = uncolored & (prio > best)
        # smallest free color = index of the lowest zero bit of forbid
        low = ~forbid & (forbid + np.uint64(1))
        if np.any(win & (low == 0)):
            raise ValueError("coloring needs more than 63 colors")
        c = np.zeros(n_nodes, np.int32)
        lw = low[win]
        for shift in (32, 16, 8, 4, 2, 1):
            hi = lw >= (np.uint64(1) << np.uint64(shift))
            c[win] += np.where(hi, shift, 0).astype(np.int32)
            lw = np.where(hi, lw >> np.uint64(shift), lw)
        colors[win] = c[win]
        uncolored = colors < 0
    return colors


def color_nodes(connectivity, n_nodes: int) -> np.ndarray:
    """Proper coloring [n_nodes] int32 of the element-edge adjacency
    graph (host; native when built, the numpy rounds otherwise;
    ``connectivity`` a tensor on any device or an array)."""
    from . import native
    if native.available():
        return native.greedy_color(_numpy(connectivity), int(n_nodes))
    return _greedy_color_numpy(_numpy(connectivity), int(n_nodes))


def check_coloring(connectivity, colors) -> bool:
    """True iff no element edge connects same-color nodes."""
    c = _numpy(connectivity).astype(np.int64)
    col = _numpy(colors)
    for a, b in ((0, 1), (1, 2), (0, 2)):
        if np.any(col[c[:, a]] == col[c[:, b]]):
            return False
    return True
