"""The port's host mesh layer and quadrature tables against the JAX
package: every array is equal (exact integer and float equality; the
incidence tables are compared row-sorted, because the JAX package may
fill a node's slots through its native library in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hidenn_fem_tpu as ht
import hidenn_fem_tpu_torch as pt
from hidenn_fem_tpu.ops import quadrature as jq
from hidenn_fem_tpu_torch.mesh import structured as ps
from hidenn_fem_tpu_torch.ops import quadrature as pq


@pytest.mark.parametrize("order", [1, 3, 4, 6, 7])
def test_triangle_rules_bit_equal(order):
    jp, jw = jq.triangle_gauss_points(order, dtype=jnp.float32)
    tp, tw = pq.triangle_gauss_points(order, dtype=torch.float32)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    assert pq.triangle_weight_sum(order) == jq.triangle_weight_sum(order)


@pytest.mark.parametrize("order", [1, 2, 3, 5])
def test_interval_rules_bit_equal(order):
    for jfn, tfn in ((jq.interval_gauss_points, pq.interval_gauss_points),
                     (jq.interval_gauss_points_m11,
                      pq.interval_gauss_points_m11)):
        jx, jw = jfn(order)
        tx, tw = tfn(order)
        np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))


@pytest.mark.parametrize("variant", ["zigzag", "up", "down"])
def test_rectangle_tri_zigzag_equal(variant):
    jp, jc = ht.rectangle_tri_zigzag(13, 7, 2.0, 1.0, variant)
    tp, tc = ps.rectangle_tri_zigzag(13, 7, 2.0, 1.0, variant)
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tc, np.asarray(jc))
    with pytest.raises(ValueError):
        ps.rectangle_tri_zigzag(3, 3, 1.0, 1.0, "diagonal")


def test_unique_edges_equal():
    from hidenn_fem_tpu.mesh.structured import unique_edges as jue
    _, cells = ps.rectangle_tri_zigzag(15, 9, 2.0, 1.0)
    np.testing.assert_array_equal(ps.unique_edges(cells),
                                  np.asarray(jue(cells)))


def _sorted_rows(a):
    return np.sort(np.asarray(a), axis=1)


MESH_CASES = {
    "no_holes": dict(holes=(), nx=21, ny=11),
    "holes": dict(nx=41, ny=21),
    "holes_keep_dead": dict(nx=41, ny=21, keep_dead_nodes=True),
    "holes_up_dirichlet_top": dict(nx=30, ny=16, variant="up",
                                   boundaries={"up": 1, "down": 0,
                                               "right": 2, "left": 1}),
}


@pytest.mark.parametrize("case", sorted(MESH_CASES))
def test_generate_mesh_equal(case):
    kw = MESH_CASES[case]
    jm = ht.generate_mesh(**kw)
    tm = pt.generate_mesh(**kw)
    for name in ("coords", "connectivity", "geom_boundary_mask",
                 "dirichlet_mask", "neumann_mask", "neumann_edges",
                 "fused_connectivity"):
        np.testing.assert_array_equal(getattr(tm, name).numpy(),
                                      np.asarray(getattr(jm, name)),
                                      err_msg=name)
    for name in ("incidence", "fused_incidence"):
        np.testing.assert_array_equal(_sorted_rows(getattr(tm, name)),
                                      _sorted_rows(getattr(jm, name)),
                                      err_msg=name)
    assert tm.connectivity.dtype == torch.int32
    assert tm.coords.dtype == torch.float32
    assert tm.lattice is None and tm.banded is None and tm.hybrid is None
    if kw.get("keep_dead_nodes"):
        # dead hole nodes: referenced by no element, all -1 incidence
        used = np.zeros(tm.n_nodes, bool)
        used[tm.connectivity.numpy().ravel()] = True
        assert (~used).sum() > 0
        assert np.all(tm.incidence.numpy()[~used] == -1)
        assert np.all(tm.dirichlet_mask.numpy()[~used])


def test_from_arrays_rejects_out_of_range_indices():
    coords = np.zeros((4, 2))
    with pytest.raises(ValueError):
        pt.TriMesh.from_arrays(coords, np.asarray([[0, 1, 4]]))
    with pytest.raises(ValueError):
        pt.TriMesh.from_arrays(coords, np.asarray([[0, 1, 2]]),
                               neumann_edges=np.asarray([[-1, 2]]))


def test_incidence_table_semantics():
    conn = np.asarray([[0, 1, 2], [1, 2, 3], [3, 0, 1]])
    table = pt.mesh.types.build_incidence_table(conn, 5)
    flat = conn.reshape(-1)
    for n in range(5):
        rows = sorted(r for r in table[n] if r >= 0)
        assert rows == sorted(np.nonzero(flat == n)[0].tolist())
    assert np.all(table[4] == -1)


def test_proxy_plate_and_convert_roundtrip():
    jm = ht.proxy_plate_mesh(nx=9, ny=5)
    tm = pt.proxy_plate_mesh(nx=9, ny=5)
    cm = pt.mesh_from_numpy(jm)
    for name in ("coords", "connectivity", "dirichlet_mask",
                 "neumann_edges", "fused_connectivity"):
        np.testing.assert_array_equal(getattr(tm, name).numpy(),
                                      getattr(cm, name).numpy())
    moved = tm.to("cpu")
    assert moved.device == torch.device("cpu")
    assert moved.n_elements == 64 and moved.n_neumann_edges == 4
    p = pt.params_from_numpy({"u": np.ones((3, 2))}, dtype=torch.float64)
    assert p["u"].dtype == torch.float64
