"""The port's point location and evaluation (``postproc.locate_points``,
``postproc.evaluate_at_points``, ``TriangleP1.interpolate``) against the
JAX package on the same numpy inputs.

Mirrors ``tests/test_point_eval.py``.  The JAX package locates with
matplotlib's trifinder; the port with its own bucket grid and barycentric
test (no matplotlib).  They are held to each other as follows: the
``-1`` set (outside the mesh and in its holes) is equal; every point whose
smallest barycentric coordinate in JAX's element exceeds 1e-9 gets the
same element, and its reference coordinates agree at atol 1e-12 (both
take them by the same float64 formula); a point on an edge or at a
vertex may get either element that holds it, and its interpolated value
is then JAX's at rtol 1e-6 (f32 values; the element's corners blend to
the same point value).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hidenn_fem_tpu as ht
import hidenn_fem_tpu_torch as pt
from hidenn_fem_tpu import postproc as jpost
from hidenn_fem_tpu.mesh.delaunay import generate_mesh_delaunay
from hidenn_fem_tpu_torch import postproc as tpost

from torch_port_common import CPU, assert_close, port_mesh

HOLES = ((0.5, 0.7, 0.12), (1.0, 0.3, 0.15), (1.4, 0.6, 0.1))


def _np(t):
    return t.detach().cpu().numpy()


def _min_bary(coords, conn, elem_id, ref):
    xi, eta = ref[:, 0], ref[:, 1]
    return np.minimum(np.minimum(xi, eta), 1.0 - xi - eta)


def test_locate_points_roundtrip():
    mesh = pt.proxy_plate_mesh(nx=9, ny=5, device=CPU)
    rng = np.random.default_rng(0)
    pts = np.stack([rng.uniform(0.05, 1.95, 40),
                    rng.uniform(0.05, 0.95, 40)], axis=1)
    elem_id, ref = (_np(a) for a in tpost.locate_points(
        mesh.coords, mesh.connectivity, pts))
    assert elem_id.dtype == np.int64 and ref.dtype == np.float64
    assert np.all(elem_id >= 0)
    assert np.all(ref >= -1e-9) and np.all(ref.sum(1) <= 1 + 1e-6)
    v = _np(mesh.coords)[_np(mesh.connectivity)[elem_id]]
    rec = (ref[:, :1] * v[:, 0] + ref[:, 1:2] * v[:, 1]
           + (1 - ref.sum(1, keepdims=True)) * v[:, 2])
    np.testing.assert_allclose(rec, pts, atol=1e-6)


def _meshes():
    plate = ht.generate_mesh(nx=21, ny=11, holes=list(HOLES))
    delaunay = generate_mesh_delaunay(holes=list(HOLES), lc=0.09)
    return {"plate_holes": plate, "delaunay": delaunay}


@pytest.mark.parametrize("which", ["plate_holes", "delaunay"])
def test_locate_points_matches_jax_trifinder(which):
    """Uniform random points over (and beyond) the bounding box, plus
    every vertex and every edge midpoint of the mesh."""
    mesh = _meshes()[which]
    coords = np.asarray(mesh.coords, np.float64)
    conn = np.asarray(mesh.connectivity)
    rng = np.random.default_rng(1)
    rand = np.stack([rng.uniform(-0.1, 2.1, 3000),
                     rng.uniform(-0.1, 1.1, 3000)], axis=1)
    edges = np.concatenate([conn[:, [0, 1]], conn[:, [1, 2]],
                            conn[:, [2, 0]]])
    on_mesh = np.concatenate(
        [coords, 0.5 * (coords[edges[:, 0]] + coords[edges[:, 1]])])
    pts = np.concatenate([rand, on_mesh])
    je, jr = jpost.locate_points(coords, conn, pts)
    te, tr = (_np(a) for a in tpost.locate_points(coords, conn, pts,
                                                  device=CPU))
    np.testing.assert_array_equal(te < 0, je < 0)
    inside = je >= 0
    deep = inside & (_min_bary(coords, conn, je, jr) > 1e-9)
    assert deep.sum() > 1500
    np.testing.assert_array_equal(te[deep], je[deep])
    np.testing.assert_allclose(tr[deep], jr[deep], atol=1e-12)
    # every located point lies in the element the port names
    assert np.all(_min_bary(coords, conn, te[inside], tr[inside]) > -1e-9)

    # points on edges and vertices: either element, the same value
    model = ht.TriangleP1()
    u = np.random.default_rng(2).standard_normal((mesh.n_nodes, 2))
    jparams = {"coords": mesh.coords, "u": jnp.asarray(u, jnp.float32)}
    want = np.asarray(jpost.evaluate_at_points(model, jparams, mesh, pts))
    tmesh = port_mesh(dataclasses.replace(mesh, lattice=None))
    tmodel = pt.TriangleP1()
    tparams = {"coords": tmesh.coords, "u": torch.tensor(u,
                                                         dtype=torch.float32)}
    got = _np(tpost.evaluate_at_points(tmodel, tparams, tmesh, pts))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want[:, 0])
    assert_close(got[ok], want[ok], 1e-6, 1e-6, "values")


@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_interpolate_matches_jax(dt):
    jdt, tdt = ((jnp.float64, torch.float64) if dt == "f64"
                else (jnp.float32, torch.float32))
    m0 = ht.proxy_plate_mesh(nx=9, ny=5)
    rng = np.random.default_rng(3)
    u = rng.standard_normal((m0.n_nodes, 2))
    ref = rng.uniform(0, 0.5, (50, 2))
    eid = rng.integers(0, m0.n_elements, 50)
    with jax.enable_x64(dt == "f64"):
        mesh = ht.TriMesh.from_arrays(*[np.asarray(a) for a in m0.astuple()],
                                      dtype=jdt)
        want = np.asarray(ht.TriangleP1(dtype=jdt).interpolate(
            {"coords": mesh.coords, "u": jnp.asarray(u, jdt)}, mesh,
            jnp.asarray(ref, jdt), jnp.asarray(eid)))
    tmesh = pt.TriMesh.from_arrays(*[np.asarray(a) for a in m0.astuple()],
                                   dtype=tdt, device=CPU)
    got = pt.TriangleP1(dtype=tdt).interpolate(
        {"coords": tmesh.coords, "u": torch.tensor(u, dtype=tdt)}, tmesh,
        torch.tensor(ref), torch.tensor(eid))
    assert got.dtype == tdt
    assert_close(_np(got), want, 1e-6 if dt == "f32" else 1e-14, 1e-7)


def test_evaluate_linear_field_at_points():
    """P1 reproduces a linear field: u = A x at any point inside."""
    m0 = ht.proxy_plate_mesh(nx=9, ny=5)
    mesh = pt.TriMesh.from_arrays(np.asarray(m0.coords),
                                  np.asarray(m0.connectivity), device=CPU)
    model = pt.TriangleP1()
    A = np.asarray([[1e-3, 2e-4], [-3e-4, 5e-4]], np.float32)
    params = {"coords": mesh.coords,
              "u": torch.tensor(np.asarray(m0.coords) @ A.T)}
    pts = np.asarray([[0.3, 0.4], [1.7, 0.9], [0.99, 0.51]])
    u = _np(tpost.evaluate_at_points(model, params, mesh, pts))
    np.testing.assert_allclose(u, pts @ A.T, rtol=1e-4, atol=1e-8)


def test_outside_points_are_nan():
    mesh = pt.generate_mesh(nx=20, ny=10, device=CPU)      # with holes
    model = pt.TriangleP1()
    params = model.init(torch.Generator().manual_seed(0), mesh, device=CPU)
    pts = np.asarray([[1.0, 0.3],     # inside a hole
                      [-0.5, 0.5],    # outside the plate
                      [0.1, 0.1]])    # valid
    u = _np(tpost.evaluate_at_points(model, params, mesh, pts))
    assert np.all(np.isnan(u[0])) and np.all(np.isnan(u[1]))
    assert np.all(np.isfinite(u[2]))


def test_evaluate_follows_the_current_coordinates():
    """Location runs on the model's coordinates (moved interior nodes),
    and the values keep their gradient in u."""
    m0 = ht.proxy_plate_mesh(nx=9, ny=5)
    mesh = pt.TriMesh.from_arrays(
        *[np.asarray(a) for a in m0.astuple()], device=CPU)
    jmesh = dataclasses.replace(m0, lattice=None)
    rng = np.random.default_rng(4)
    coords = np.asarray(m0.coords) + 0.02 * rng.standard_normal(
        (m0.n_nodes, 2))
    u = rng.standard_normal((m0.n_nodes, 2))
    pts = np.stack([rng.uniform(0, 2, 200), rng.uniform(0, 1, 200)], axis=1)
    want = np.asarray(jpost.evaluate_at_points(
        ht.TriangleP1(), {"coords": jnp.asarray(coords, jnp.float32),
                          "u": jnp.asarray(u, jnp.float32)}, jmesh, pts))
    tu = torch.tensor(u, dtype=torch.float32, requires_grad=True)
    got = tpost.evaluate_at_points(
        pt.TriangleP1(), {"coords": torch.tensor(coords,
                                                 dtype=torch.float32),
                          "u": tu}, mesh, pts)
    ok = ~np.isnan(want[:, 0])
    np.testing.assert_array_equal(np.isnan(_np(got)[:, 0]), ~ok)
    assert_close(_np(got)[ok], want[ok], 1e-6, 1e-6)
    (g,) = torch.autograd.grad(got[torch.tensor(ok)].sum(), tu)
    assert float(g.abs().sum()) > 0
