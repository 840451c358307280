"""The port's loader of the native mesh library (``mesh/native.py``)
against the numpy paths and against the JAX package's loader of the same
source (``csrc/mesh_kernels.cpp``).

Mirrors ``tests/test_native.py``: every native function's output is
array-equal to the numpy path's (``HDNN_NO_NATIVE=1`` selects the numpy
paths) and to the JAX package's native output (built by
``tests/conftest.py``).  The module fixture builds the port's library
(a g++ compile of a few seconds; concurrent test workers share one
build under its file lock), and a stress case starts three builds at
once into a scratch directory.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import hidenn_fem_tpu_torch as pt
from hidenn_fem_tpu.mesh import native as jnative
from hidenn_fem_tpu.mesh.delaunay import generate_mesh_delaunay
from hidenn_fem_tpu_torch.mesh import banded, coloring, native, structured
from hidenn_fem_tpu_torch.mesh import types

from torch_port_common import CPU

HOLES = [(0.5, 0.7, 0.12), (1.0, 0.3, 0.15)]


@pytest.fixture(scope="module", autouse=True)
def built():
    native.build(verbose=False)
    assert native.available()
    assert jnative.available(), "tests/conftest.py builds the JAX library"


@pytest.fixture
def numpy_paths(monkeypatch):
    """A context in which the port's native library is off."""
    def off():
        monkeypatch.setenv("HDNN_NO_NATIVE", "1")
        assert not native.available()
    return off


def _numpy_unique_edges(cells):
    cells = np.ascontiguousarray(cells, dtype=np.int64)
    e = np.concatenate(
        [cells[:, [0, 1]], cells[:, [1, 2]], cells[:, [2, 0]]], axis=0)
    lo, hi = e.min(axis=1), e.max(axis=1)
    keys = np.unique((lo << 32) | hi)
    return np.stack([keys >> 32, keys & 0xFFFFFFFF], axis=1)


def test_unique_edges_parity(monkeypatch, numpy_paths):
    _, cells = structured.rectangle_tri_zigzag(40, 25, 2.0, 1.0)
    got = native.unique_edges(cells)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, _numpy_unique_edges(cells))
    np.testing.assert_array_equal(got, jnative.unique_edges(cells))
    np.testing.assert_array_equal(structured.unique_edges(cells), got)
    numpy_paths()
    np.testing.assert_array_equal(structured.unique_edges(cells), got)


def test_incidence_parity(numpy_paths):
    """Native == numpy incidence row for row, not only as sets: both list
    a node's corners in flat-connectivity order."""
    delaunay = generate_mesh_delaunay(holes=HOLES, lc=0.09)
    cases = ((structured.rectangle_tri_zigzag(23, 17, 1.0, 1.0)[1], 23 * 17),
             (np.asarray(delaunay.connectivity), delaunay.n_nodes))
    tables = []
    for cells, n in cases:
        t_native = native.build_incidence_table(cells, n)
        np.testing.assert_array_equal(
            t_native, jnative.build_incidence_table(cells, n))
        np.testing.assert_array_equal(types.build_incidence_table(cells, n),
                                      t_native)
        tables.append(t_native)
    numpy_paths()
    for (cells, n), t_native in zip(cases, tables):
        np.testing.assert_array_equal(types.build_incidence_table(cells, n),
                                      t_native)


def test_outside_holes_parity():
    pts, _ = structured.rectangle_tri_zigzag(50, 30, 2.0, 1.0)
    keep_native = native.outside_holes(pts, HOLES)
    keep_np = np.ones(pts.shape[0], bool)
    for cx, cy, r in HOLES:
        keep_np &= ((pts[:, 0] - cx) ** 2 + (pts[:, 1] - cy) ** 2) > r * r
    np.testing.assert_array_equal(keep_native, keep_np)
    np.testing.assert_array_equal(keep_native,
                                  jnative.outside_holes(pts, HOLES))


@pytest.mark.parametrize("variant", ["up", "down", "zigzag"])
def test_structured_cells_parity(variant, numpy_paths):
    """Native triangulation == the numpy one, in the same interleaved
    element order, and == JAX's native one."""
    cells = native.structured_cells(31, 17, variant)
    assert cells.dtype == np.int32
    np.testing.assert_array_equal(cells, jnative.structured_cells(31, 17,
                                                                  variant))
    pts_n, cells_n = structured.rectangle_tri_zigzag(31, 17, 2.0, 1.0,
                                                     variant)
    np.testing.assert_array_equal(cells_n, cells)
    numpy_paths()
    pts, want = structured.rectangle_tri_zigzag(31, 17, 2.0, 1.0, variant)
    assert want.dtype == np.int64
    np.testing.assert_array_equal(cells, want)
    np.testing.assert_array_equal(pts_n, pts)


def test_banded_tables_parity(numpy_paths):
    """Native banded plan and tables == the numpy builder's, recompute
    tables and ownership intervals included, across window limits and
    block multiples; and == the JAX package's native tables."""
    _, cells = structured.rectangle_tri_zigzag(33, 17, 2.0, 1.0,
                                               variant="up")
    n = 33 * 17
    inc = types.build_incidence_table(cells, n)
    cases = ((300, 1), (800, 8), (150, 1))
    nat = {c: banded.build_banded_assembly(cells, n, inc, window_limit=c[0],
                                           block_multiple=c[1], device=CPU)
           for c in cases}
    for wl, bm in cases:
        t = native.banded_tables(cells, n, inc, wl, bm)
        tj = jnative.banded_tables(cells, n, inc, wl, bm)
        assert (t is None) == (tj is None) == (nat[wl, bm] is None)
        if t is not None:
            assert sorted(t) == sorted(tj)
            for k in t:
                np.testing.assert_array_equal(t[k], tj[k], err_msg=k)
    numpy_paths()
    for wl, bm in cases:
        want = banded.build_banded_assembly(cells, n, inc, window_limit=wl,
                                            block_multiple=bm, device=CPU)
        got = nat[wl, bm]
        if want is None:
            assert got is None, (wl, bm)
            continue
        for f in ("wnode", "wct", "re_wnode", "re_ew", "k"):
            assert getattr(got, f) == getattr(want, f), f
        for f in banded._TABLES:
            a, b = getattr(got, f), getattr(want, f)
            assert (a is None) == (b is None), f
            if a is not None:
                np.testing.assert_array_equal(a.numpy(), b.numpy(),
                                              err_msg=f)


def test_greedy_match_and_color_parity(numpy_paths):
    """The matching loop equals the Python loop; the coloring equals the
    JAX package's native coloring (a proper one), and ``color_nodes``
    takes it when the library is built, the numpy rounds otherwise."""
    mesh = generate_mesh_delaunay(holes=HOLES, lc=0.09)
    conn = np.asarray(mesh.connectivity)
    rng = np.random.default_rng(0)
    a = rng.integers(0, mesh.n_elements, 3000)
    b = rng.integers(0, mesh.n_elements, 3000)
    acc, mat = native.greedy_match(a, b, mesh.n_elements)
    jacc, jmat = jnative.greedy_match(a, b, mesh.n_elements)
    np.testing.assert_array_equal(acc, jacc)
    np.testing.assert_array_equal(mat, jmat)
    for x, y in zip(banded._greedy_match(a, b, mesh.n_elements),
                    (acc, mat)):
        np.testing.assert_array_equal(x, y)
    colors = native.greedy_color(conn, mesh.n_nodes)
    np.testing.assert_array_equal(colors,
                                  jnative.greedy_color(conn, mesh.n_nodes))
    np.testing.assert_array_equal(coloring.color_nodes(conn, mesh.n_nodes),
                                  colors)
    assert coloring.check_coloring(conn, colors)
    numpy_paths()
    for x, y in zip(banded._greedy_match(a, b, mesh.n_elements),
                    (acc, mat)):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(
        coloring.color_nodes(conn, mesh.n_nodes),
        coloring._greedy_color_numpy(conn, mesh.n_nodes))


def test_meshes_are_equal_both_ways(numpy_paths):
    """The port's mesh builders give the same tables with the library
    and without it: a holed Delaunay plate with banded (triangle and
    paired) tables, and a generator plate."""
    def build():
        d = pt.generate_mesh_delaunay(holes=HOLES, lc=0.09, device=CPU)
        d = pt.TriMesh.from_arrays(*[t.numpy() for t in d.astuple()],
                                   device=CPU, build_banded=True)
        g = pt.generate_mesh(nx=33, ny=17, device=CPU)
        return d, g

    with_lib = build()
    numpy_paths()
    without = build()
    for a, b in zip(with_lib, without):
        for x, y in zip(a.astuple(), b.astuple()):
            np.testing.assert_array_equal(x.numpy(), y.numpy())
        np.testing.assert_array_equal(a.incidence.numpy(),
                                      b.incidence.numpy())
        for name in ("banded", "banded_paired"):
            ba, bb = getattr(a, name), getattr(b, name)
            assert (ba is None) == (bb is None), name
            if ba is not None:
                for f in banded._TABLES:
                    x, y = getattr(ba, f), getattr(bb, f)
                    assert (x is None) == (y is None), f
                    if x is not None:
                        np.testing.assert_array_equal(x.numpy(), y.numpy())
    assert with_lib[0].banded is not None


def test_bad_input_is_refused():
    with pytest.raises(ValueError, match="out of range"):
        native.build_incidence_table(np.array([[0, 1, 5]]), 4)
    with pytest.raises(ValueError, match="triangles"):
        native.unique_edges(np.zeros((3, 4), np.int32))
    with pytest.raises(ValueError, match="out of range"):
        native.greedy_match(np.array([0, 9]), np.array([1, 2]), 5)


def test_concurrent_builds_share_one_library(tmp_path):
    """Three processes build at once into one directory: all succeed,
    one library is left and no temporary file."""
    script = textwrap.dedent(f"""
        import sys
        from pathlib import Path
        from hidenn_fem_tpu_torch.mesh import native
        native._BUILD_DIR = Path({str(tmp_path)!r})
        native._lib_path.cache_clear()
        path = native.build(verbose=False)
        assert native.available()
        print(path)
    """)
    env = dict(os.environ)
    env.pop("HDNN_NO_NATIVE", None)
    procs = [subprocess.Popen([sys.executable, "-c", script],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env,
                              cwd=os.path.dirname(os.path.dirname(
                                  os.path.abspath(__file__))))
             for _ in range(3)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    assert len({out.strip() for out, _ in outs}) == 1
    files = sorted(f.name for f in tmp_path.iterdir())
    assert [f for f in files if f.endswith(".so")] == [
        os.path.basename(outs[0][0].strip())]
    assert not [f for f in files if f.endswith(".tmp")]


def test_import_never_builds(tmp_path):
    """Importing the package and calling ``available()`` build nothing."""
    script = textwrap.dedent(f"""
        from pathlib import Path
        import hidenn_fem_tpu_torch
        from hidenn_fem_tpu_torch.mesh import native
        native._BUILD_DIR = Path({str(tmp_path)!r})
        native._lib_path.cache_clear()
        assert not native.available()
        hidenn_fem_tpu_torch.generate_mesh(nx=9, ny=5, device="cpu")
    """)
    subprocess.run([sys.executable, "-c", script], check=True,
                   cwd=os.path.dirname(os.path.dirname(
                       os.path.abspath(__file__))))
    assert list(tmp_path.iterdir()) == []
