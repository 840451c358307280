"""ctypes loader of the native mesh-preprocessing library (port of
``hidenn_fem_tpu/mesh/native.py``).

The numpy paths of ``structured.py``, ``types.py``, ``banded.py`` and
``coloring.py`` always work; this module compiles the repository's
``csrc/mesh_kernels.cpp`` (plain C++, no framework) with ``g++`` into
``hidenn_fem_tpu_torch/csrc/build/`` and exposes its functions with the
numpy paths' contracts.  The mesh modules use it when the library of the
current source is built and ``HDNN_NO_NATIVE`` is unset; the variable is
read at every call, so setting it turns the library off at once.

Importing never builds.  Build once (a few seconds):

    python -m hidenn_fem_tpu_torch.mesh.native --build

The library's name carries a hash of the source, the flags and the
instruction sets that ``-march=native`` selects on this host (the
compiler's predefined macros), so an edited source, or a checkout moved to
a host with other instruction sets, builds its own library.  Concurrent builds (test workers) take a file lock, compile to
a temporary name and move the library into place.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

__all__ = ["available", "build", "unique_edges", "build_incidence_table",
           "outside_holes", "structured_cells", "banded_tables",
           "greedy_color", "greedy_match"]

_SRC = Path(__file__).resolve().parents[2] / "csrc" / "mesh_kernels.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[1] / "csrc" / "build"

_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_F64P = ctypes.POINTER(ctypes.c_double)
_I64 = ctypes.c_int64
_SIGNATURES = {
    "hdnn_unique_edges": [_I32P, _I64, _I32P, _I64P],
    "hdnn_node_degrees": [_I32P, _I64, _I64, _I32P],
    "hdnn_incidence": [_I32P, _I64, _I64, _I64, _I32P],
    "hdnn_outside_holes": [_F64P, _I64, _F64P, _I64, _U8P],
    "hdnn_structured_cells": [_I64, _I64, ctypes.c_int, _I32P],
    "hdnn_greedy_color": [_I32P, _I64, _I64, _I32P, _I32P],
    "hdnn_greedy_match": [_I64P, _I64P, _I64, _I64, _U8P, _U8P],
    "hdnn_banded_plan": [_I32P, _I64, _I32P, _I64, _I64, _I64, _I64,
                         _I64P],
    "hdnn_banded_fill": [_I32P, _I64, _I32P, _I64, _I64, _I64P] + [_I32P] * 8,
}


_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]


def _target() -> bytes:
    """g++'s predefined macros under ``-march=native``: the instruction
    sets a library built here may use (empty without g++)."""
    try:
        return subprocess.run(
            ["g++", "-march=native", "-dM", "-E", "-x", "c++", "-"],
            input=b"", capture_output=True, check=True).stdout
    except (OSError, subprocess.CalledProcessError):
        return b""


@functools.lru_cache(maxsize=None)
def _lib_path() -> Path:
    """The library of the current source, flags and host target (the
    name carries their hash)."""
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(_FLAGS).encode())
    h.update(_target())
    return _BUILD_DIR / f"libhdnn_mesh_{h.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=None)
def _open(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _load():
    """The loaded library, or None when it is not built or
    ``HDNN_NO_NATIVE`` is set."""
    if os.environ.get("HDNN_NO_NATIVE") or not _SRC.exists():
        return None
    path = _lib_path()
    return _open(str(path)) if path.exists() else None


def available() -> bool:
    return _load() is not None


def build(verbose: bool = True) -> str:
    """Compile the library with g++ unless the current source's library
    exists; returns its path.  Safe to call from several processes at
    once: one compiles under a file lock, the others wait and find it."""
    out = _lib_path()
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(_BUILD_DIR / "libhdnn_mesh.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not out.exists():
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = ["g++", *_FLAGS, "-o", str(tmp), str(_SRC)]
            if verbose:
                print(" ".join(cmd))
            try:
                subprocess.run(cmd, check=True)
                os.replace(tmp, out)
            finally:
                if tmp.exists():
                    tmp.unlink()
    if os.environ.get("HDNN_NO_NATIVE"):
        return str(out)
    if not available():
        raise RuntimeError(f"native library built but not loaded: {out}")
    return str(out)


def _lib():
    lib = _load()
    if lib is None:
        raise RuntimeError("the native mesh library is not available "
                           "(python -m hidenn_fem_tpu_torch.mesh.native "
                           "--build; HDNN_NO_NATIVE unset)")
    return lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _cells(cells, n_nodes=None) -> np.ndarray:
    """[Ne, 3] connectivity as contiguous int32, checked in range."""
    conn = np.ascontiguousarray(cells, dtype=np.int32)
    if conn.ndim != 2 or conn.shape[1] != 3:
        raise ValueError(f"expected [Ne, 3] triangles, got {conn.shape}")
    if conn.size and (conn.min() < 0 or (n_nodes is not None
                                         and conn.max() >= n_nodes)):
        raise ValueError("node index out of range")
    return conn


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed with code {rc}")


def unique_edges(cells: np.ndarray) -> np.ndarray:
    """Unique undirected edges [E, 2] (int64, sorted like the numpy
    path's)."""
    lib = _lib()
    conn = _cells(cells)
    ne = conn.shape[0]
    out = np.empty((ne * 3, 2), dtype=np.int32)
    count = np.zeros(1, dtype=np.int64)
    _check(lib.hdnn_unique_edges(_ptr(conn, ctypes.c_int32), ne,
                                 _ptr(out, ctypes.c_int32),
                                 _ptr(count, ctypes.c_int64)),
           "hdnn_unique_edges")
    return out[: int(count[0])].astype(np.int64)


def build_incidence_table(connectivity: np.ndarray, n_nodes: int
                          ) -> np.ndarray:
    """Node -> flat-connectivity-row incidence table (-1 padded); the
    contract of ``mesh.types.build_incidence_table``."""
    lib = _lib()
    conn = _cells(connectivity, n_nodes)
    ne = conn.shape[0]
    degrees = np.empty(n_nodes, dtype=np.int32)
    _check(lib.hdnn_node_degrees(_ptr(conn, ctypes.c_int32), ne, n_nodes,
                                 _ptr(degrees, ctypes.c_int32)),
           "hdnn_node_degrees")
    maxdeg = int(degrees.max()) if n_nodes else 0
    table = np.empty((n_nodes, maxdeg), dtype=np.int32)
    _check(lib.hdnn_incidence(_ptr(conn, ctypes.c_int32), ne, n_nodes,
                              maxdeg, _ptr(table, ctypes.c_int32)),
           "hdnn_incidence")
    return table


def outside_holes(points: np.ndarray, holes) -> np.ndarray:
    """keep mask: True where the point lies outside every hole disk."""
    lib = _lib()
    pts = np.ascontiguousarray(points, dtype=np.float64).reshape(-1, 2)
    hl = np.ascontiguousarray(np.asarray(holes, dtype=np.float64)
                              .reshape(-1, 3))
    keep = np.empty(pts.shape[0], dtype=np.uint8)
    _check(lib.hdnn_outside_holes(_ptr(pts, ctypes.c_double), pts.shape[0],
                                  _ptr(hl, ctypes.c_double), hl.shape[0],
                                  _ptr(keep, ctypes.c_uint8)),
           "hdnn_outside_holes")
    return keep.astype(bool)


def greedy_color(connectivity: np.ndarray, n_nodes: int) -> np.ndarray:
    """Sequential greedy node coloring of the element-edge adjacency
    graph in node order (the JAX package's native colors; a proper
    coloring, not the numpy rounds' colors)."""
    lib = _lib()
    conn = _cells(connectivity, n_nodes)
    colors = np.empty(n_nodes, dtype=np.int32)
    n_colors = np.zeros(1, dtype=np.int32)
    _check(lib.hdnn_greedy_color(_ptr(conn, ctypes.c_int32), conn.shape[0],
                                 n_nodes, _ptr(colors, ctypes.c_int32),
                                 _ptr(n_colors, ctypes.c_int32)),
           "hdnn_greedy_color")
    return colors


def greedy_match(a: np.ndarray, b: np.ndarray, ne: int):
    """Sequential first-come greedy matching (the loop of
    ``banded._greedy_match``); returns (accept [n_cand] bool,
    matched [ne] bool)."""
    lib = _lib()
    a = np.ascontiguousarray(a, dtype=np.int64).reshape(-1)
    b = np.ascontiguousarray(b, dtype=np.int64).reshape(-1)
    if a.shape != b.shape:
        raise ValueError("candidate endpoint arrays differ in length")
    if a.size and (min(a.min(), b.min()) < 0 or max(a.max(), b.max()) >= ne):
        raise ValueError("candidate endpoint out of range")
    accept = np.zeros(a.shape[0], dtype=np.uint8)
    matched = np.zeros(ne, dtype=np.uint8)
    _check(lib.hdnn_greedy_match(_ptr(a, ctypes.c_int64),
                                 _ptr(b, ctypes.c_int64), a.shape[0], ne,
                                 _ptr(accept, ctypes.c_uint8),
                                 _ptr(matched, ctypes.c_uint8)),
           "hdnn_greedy_match")
    return accept.astype(bool), matched.astype(bool)


def structured_cells(nx: int, ny: int, variant: str = "zigzag"
                     ) -> np.ndarray:
    """Structured triangulation in ``structured.rectangle_tri_zigzag``'s
    interleaved order (int32 cells)."""
    lib = _lib()
    v = {"up": 0, "down": 1, "zigzag": 2}[variant]
    cells = np.empty((2 * (nx - 1) * (ny - 1), 3), dtype=np.int32)
    _check(lib.hdnn_structured_cells(nx, ny, v, _ptr(cells, ctypes.c_int32)),
           "hdnn_structured_cells")
    return cells


def banded_tables(connectivity: np.ndarray, n_nodes: int,
                  incidence: np.ndarray, window_limit: int,
                  block_multiple: int = 1):
    """The plan and tables of ``banded.build_banded_assembly`` for
    triangles: None if not bandable, else a dict of the forward, backward
    and (when they fit the window limit) recompute arrays and sizes."""
    lib = _lib()
    conn = _cells(connectivity, n_nodes)
    inc = np.ascontiguousarray(incidence, dtype=np.int32)
    if inc.ndim != 2 or inc.shape[0] != n_nodes:
        raise ValueError(f"incidence {inc.shape} for {n_nodes} nodes")
    ne = conn.shape[0]
    maxdeg = inc.shape[1]
    plan = np.zeros(12, dtype=np.int64)
    i32 = lambda a: _ptr(a, ctypes.c_int32)  # noqa: E731
    rc = lib.hdnn_banded_plan(i32(conn), ne, i32(inc), n_nodes, maxdeg,
                              window_limit, block_multiple,
                              _ptr(plan, ctypes.c_int64))
    if rc != 0:
        return None
    b, eb, wnode, bn, nb, wct, br, nbr, ew, wn, has_re, _ = (
        int(x) for x in plan)
    starts = np.empty(b, np.int32)
    conn_rel = np.empty((b, eb, 3), np.int32)
    ct_starts = np.empty(bn, np.int32)
    inc_rel = np.empty((bn, nb, maxdeg), np.int32)
    if has_re:
        re_nstarts = np.empty(br, np.int32)
        re_estarts = np.empty(br, np.int32)
        re_conn_rel = np.empty((br, ew, 3), np.int32)
        re_inc_rel = np.empty((br, nbr, maxdeg), np.int32)
    else:
        re_nstarts = re_estarts = np.empty(0, np.int32)
        re_conn_rel = np.empty((0, 1, 3), np.int32)
        re_inc_rel = np.empty((0, 1, maxdeg), np.int32)
    _check(lib.hdnn_banded_fill(
        i32(conn), ne, i32(inc), n_nodes, maxdeg,
        _ptr(plan, ctypes.c_int64), i32(starts), i32(conn_rel),
        i32(ct_starts), i32(inc_rel), i32(re_nstarts), i32(re_estarts),
        i32(re_conn_rel), i32(re_inc_rel)), "hdnn_banded_fill")
    out = dict(starts=starts, conn_rel=conn_rel, ct_starts=ct_starts,
               inc_rel=inc_rel, wnode=wnode, wct=wct)
    if has_re:
        out.update(re_nstarts=re_nstarts, re_estarts=re_estarts,
                   re_conn_rel=re_conn_rel, re_inc_rel=re_inc_rel,
                   re_wnode=wn, re_ew=ew)
    return out


if __name__ == "__main__":
    if "--build" in sys.argv:
        print("built:", build())
    else:
        print("available:", available())
