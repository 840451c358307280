"""The port's hybrid lattice+collar meshes (``mesh/hybrid.py``, the collar
term of ``ops/lattice_energy.py``, ``PlaneStressEnergy._hybrid_total``)
against the JAX package on the same numpy inputs.

* Generation: the same mesh arrays, the same ``LatticeRoute`` over the
  node-table prefix and the same compact collar tables, for the three
  diagonal variants, one hole, no hole; the same rejections.
* ``hybrid_mesh_from_arrays``: given the generator's six arrays it
  rebuilds the generator's mesh, every route table equal (two sizes, both
  diagonal variants); the loaded faces are the arrays' Neumann edges
  (two faces, part of a face), and a Neumann edge the route cannot load
  raises, as do arrays of another layout; a JAX hybrid mesh keeps its
  route through ``mesh_from_numpy``, equal to JAX's.
* ``losses.route_counts["hybrid"]``: one an energy of the hybrid route,
  none on another route.
* ``collar_energy`` (compact ``[stair | rim]`` space, sorted-unique row
  take whose backward is an ``index_add_``) against the generic
  ``extra_elements_energy`` and against JAX's ``collar_energy``.
* ``total()`` on the hybrid route, value and both gradient groups,
  against JAX's hybrid route, with the default traction, a custom
  traction and a body force; the route against the same mesh with the
  route stripped (the gather route), in the port.
* A short L-BFGS solve against JAX's.

Tolerances: meshes exactly equal.  f32: energies rtol 1e-5, gradients
rtol 5e-4 with atol 1e-5 x max|g| per group (the coordinate gradients
are sums of cancelling terms, see ``tests/test_torch_losses.py``).  f64:
rtol 1e-10, gradients atol 1e-12 x max|g|.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hidenn_fem_tpu as ht
import hidenn_fem_tpu_torch as pt
from hidenn_fem_tpu.mesh import hybrid as jh
from hidenn_fem_tpu.ops import lattice_energy as jle
from hidenn_fem_tpu_torch.mesh import hybrid as th
from hidenn_fem_tpu_torch.ops import lattice_energy as tle
from hidenn_fem_tpu_torch.ops import losses as tlosses

from test_torch_delaunay import assert_mesh_equal
from torch_port_common import (CPU, assert_close, assert_route_equal,
                               random_params, to_jax, to_torch)

E, NU, W_SUM = 10e9, 0.3, 0.5
HOLE1 = ((1.0, 0.5, 0.25),)

MESHES = {
    "up": dict(lc=0.075, variant="up"),
    "down": dict(lc=0.075, variant="down"),
    "zigzag": dict(lc=0.075, variant="zigzag"),
    "one_hole": dict(lc=0.06, holes=HOLE1),
    "no_hole": dict(lc=0.1, holes=()),
}
HYBRID_FIELDS = ("extra_conn", "stair_ids", "extra_conn_rel",
                 "extra_incidence")
ARRAYS = ("coords", "connectivity", "geom_boundary_mask", "dirichlet_mask",
          "neumann_mask", "neumann_edges")


def _meshes(name, dtype=torch.float32):
    kw = MESHES[name]
    return jh.generate_mesh_hybrid(**kw), th.generate_mesh_hybrid(
        dtype=dtype, device=CPU, **kw)


def _assert_grad(got, want, f64=False):
    rtol, atol = (1e-10, 1e-12) if f64 else (5e-4, 1e-5)
    assert_close(got, want, rtol=rtol, atol=atol * np.abs(want).max())


# ------------------------------------------------------------ generation
@pytest.mark.parametrize("name", sorted(MESHES))
def test_hybrid_mesh_equal_jax(name):
    jm, tm = _meshes(name)
    assert_mesh_equal(tm, jm)
    assert tm.hybrid is not None and jm.hybrid is not None
    assert_route_equal(tm.hybrid.lattice, jm.hybrid.lattice)
    for field in HYBRID_FIELDS:
        np.testing.assert_array_equal(
            getattr(tm.hybrid, field).numpy(),
            np.asarray(getattr(jm.hybrid, field)).reshape(
                getattr(tm.hybrid, field).shape), err_msg=field)
    assert tm.fused_connectivity is None           # build_fused=False
    assert tm.banded is None and tm.lattice is None


@pytest.mark.parametrize("kw", [
    dict(lc=0.05, holes=((0.05, 0.5, 0.12),)),
    dict(lc=0.1, variant="diagonal")], ids=["hole_at_boundary",
                                            "bad_variant"])
def test_hybrid_rejects_like_jax(kw):
    with pytest.raises(ValueError):
        jh.generate_mesh_hybrid(**kw)
    with pytest.raises(ValueError):
        th.generate_mesh_hybrid(device=CPU, **kw)


def _arrays(mesh) -> dict:
    return {k: getattr(mesh, k).numpy() for k in ARRAYS}


def _assert_hybrid_equal(got, want):
    """Every array, route table and static flag of two hybrid meshes."""
    for name in ARRAYS + ("incidence",):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and torch.equal(a, b), name
    for name in ("banded", "banded_paired", "lattice", "fused_connectivity",
                 "fused_incidence"):
        assert getattr(got, name) is None, name
    for field in HYBRID_FIELDS:
        a, b = getattr(got.hybrid, field), getattr(want.hybrid, field)
        assert a.dtype == b.dtype and torch.equal(a, b), field
    for name in ("sel", "t1", "t2", "inv_map", "fwd_map"):
        a, b = getattr(got.hybrid.lattice, name), getattr(
            want.hybrid.lattice, name)
        assert a.dtype == b.dtype and torch.equal(a, b), name
    ga, wa = got.hybrid.lattice.edge_masks, want.hybrid.lattice.edge_masks
    assert sorted(ga) == sorted(wa)
    assert all(torch.equal(ga[f], wa[f]) for f in wa)
    for name in ("nx", "ny", "identity", "prefix_identity", "uniform_sel",
                 "all_present"):
        assert getattr(got.hybrid.lattice, name) == getattr(
            want.hybrid.lattice, name), name


@pytest.mark.parametrize("variant", ["up", "down"])
@pytest.mark.parametrize("lc", [0.075, 0.05])
def test_from_arrays_rebuilds_the_generator_mesh(lc, variant):
    """The generator's six arrays, handed back with the lattice shape and
    the diagonals, give the generator's mesh: the same tensors, the same
    route, the same collar tables."""
    m = th.generate_mesh_hybrid(lc=lc, variant=variant, device=CPU)
    r = m.hybrid.lattice
    got = pt.hybrid_mesh_from_arrays(**_arrays(m), nx=r.nx, ny=r.ny,
                                     variant=variant, device=CPU)
    _assert_hybrid_equal(got, m)


def test_from_arrays_loads_the_faces_the_arrays_load():
    """The arrays alone say which faces carry traction: with the top face
    loaded besides the right one (the "up" diagonals join no two loaded
    faces), both carry a full mask, and the route's load is the
    reference's."""
    bnd = {"up": 2, "down": 0, "right": 2, "left": 1}
    m = th.generate_mesh_hybrid(lc=0.05, variant="up", boundaries=bnd,
                                device=CPU)
    r = m.hybrid.lattice
    got = pt.hybrid_mesh_from_arrays(**_arrays(m), nx=r.nx, ny=r.ny,
                                     variant="up", device=CPU)
    _assert_hybrid_equal(got, m)
    masks = got.hybrid.lattice.edge_masks
    assert sorted(masks) == ["right", "up"]
    assert all(bool((mk == 1.0).all()) for mk in masks.values())
    energy = pt.PlaneStressEnergy(model=pt.TriangleP1(dtype=torch.float64),
                                  E=E, nu=NU, F_total=1e5,
                                  traction_length=1.0)
    got64 = pt.hybrid_mesh_from_arrays(**_arrays(m), nx=r.nx, ny=r.ny,
                                       variant="up", dtype=torch.float64,
                                       device=CPU)
    u = 1e-4 * torch.ones((got64.n_nodes, 2), dtype=torch.float64)
    p = {"coords": got64.coords, "u": u}
    stripped = dataclasses.replace(got64, hybrid=None)
    assert torch.allclose(energy.total(p, got64), energy.total(p, stripped),
                          rtol=1e-12, atol=0)


def test_from_arrays_loads_part_of_a_face():
    """A Neumann edge on part of a face loads that segment alone."""
    m = th.generate_mesh_hybrid(lc=0.05, variant="up", device=CPU)
    r = m.hybrid.lattice
    a = _arrays(m)
    a["neumann_edges"] = a["neumann_edges"][:3]
    got = pt.hybrid_mesh_from_arrays(**a, nx=r.nx, ny=r.ny, variant="up",
                                     device=CPU)
    mask = got.hybrid.lattice.edge_masks["right"]
    assert float(mask.sum()) == 3.0 and mask.shape == (r.ny - 1,)


def test_two_loaded_faces_meeting_at_a_diagonal_raise():
    """Where two loaded faces meet at a corner quad whose diagonal joins
    them, that diagonal is a Neumann edge the route cannot load: the
    generator and the constructor raise rather than drop its load."""
    bnd = {"up": 2, "down": 0, "right": 2, "left": 1}
    with pytest.raises(ValueError, match="no segment"):
        th.generate_mesh_hybrid(lc=0.05, variant="down", boundaries=bnd,
                                device=CPU)


def _shuffled_lattice(a, nx, ny):
    a = dict(a)
    c = a["coords"].copy()
    c[[0, 1]] = c[[1, 0]]
    a["coords"] = c
    return a, dict(nx=nx, ny=ny, variant="up")


def _collar_first(a, nx, ny):
    a = dict(a)
    a["connectivity"] = a["connectivity"][::-1].copy()
    return a, dict(nx=nx, ny=ny, variant="up")


def _other_variant(a, nx, ny):
    return a, dict(nx=nx, ny=ny, variant="down")


def _transposed_shape(a, nx, ny):
    return a, dict(nx=ny, ny=nx, variant="up")


def _interior_neumann_edge(a, nx, ny):
    a = dict(a)
    a["neumann_edges"] = np.concatenate(
        [a["neumann_edges"], [[ny + 1, ny + 2]]])
    return a, dict(nx=nx, ny=ny, variant="up")


def _rim_neumann_edge(a, nx, ny):
    a = dict(a)
    a["neumann_edges"] = np.concatenate(
        [a["neumann_edges"], [[nx * ny, nx * ny + 1]]])
    return a, dict(nx=nx, ny=ny, variant="up")


def _unknown_variant(a, nx, ny):
    return a, dict(nx=nx, ny=ny, variant="diagonal")


MALFORMED = (_shuffled_lattice, _collar_first, _other_variant,
             _transposed_shape, _interior_neumann_edge, _rim_neumann_edge,
             _unknown_variant)


@pytest.mark.parametrize("malform", MALFORMED,
                         ids=[f.__name__.lstrip("_") for f in MALFORMED])
def test_from_arrays_rejects_another_layout(malform):
    m = th.generate_mesh_hybrid(lc=0.05, variant="up", device=CPU)
    r = m.hybrid.lattice
    arrays, kw = malform(_arrays(m), r.nx, r.ny)
    with pytest.raises(ValueError):
        pt.hybrid_mesh_from_arrays(**arrays, device=CPU, **kw)


@pytest.mark.parametrize("name", ["up", "zigzag", "one_hole"])
def test_mesh_from_numpy_keeps_a_jax_hybrid_route(name):
    """A JAX hybrid mesh through ``convert.mesh_from_numpy``: the port's
    generator's mesh, on the hybrid route (not the gather route)."""
    jm, tm = _meshes(name)
    cm = pt.mesh_from_numpy(jm, device=CPU)
    _assert_hybrid_equal(cm, tm)
    assert_route_equal(cm.hybrid.lattice, jm.hybrid.lattice)
    for field in HYBRID_FIELDS:
        np.testing.assert_array_equal(
            getattr(cm.hybrid, field).numpy(),
            np.asarray(getattr(jm.hybrid, field)).reshape(
                getattr(cm.hybrid, field).shape), err_msg=field)


def test_route_counts_count_each_hybrid_energy():
    """One count an energy of the hybrid route (with its gradient or
    without), none on the same mesh with the route stripped."""
    _, tm = _meshes("one_hole")
    energy = pt.PlaneStressEnergy(model=pt.TriangleP1())
    p = {"coords": tm.coords.clone(),
         "u": torch.zeros((tm.n_nodes, 2), requires_grad=True)}
    before = tlosses.route_counts["hybrid"]
    e = energy.total(p, tm)
    torch.autograd.grad(e, p["u"])
    with torch.no_grad():
        energy.total(p, tm)
    assert tlosses.route_counts["hybrid"] - before == 2
    energy.total(p, dataclasses.replace(tm, hybrid=None))
    assert tlosses.route_counts["hybrid"] - before == 2


def test_mesh_to_moves_the_hybrid_route():
    _, tm = _meshes("one_hole")
    hy = tm.to("meta").hybrid
    for field in HYBRID_FIELDS:
        assert getattr(hy, field).device.type == "meta", field
    assert hy.lattice.sel.device.type == "meta"
    assert hy.lattice.prefix_identity and not hy.lattice.identity


# ---------------------------------------------------------------- collar
def _node(mesh_j, seed, dtype):
    rng = np.random.default_rng(seed)
    n = mesh_j.n_nodes
    return np.concatenate(
        [np.asarray(mesh_j.coords, np.float64)
         + 1e-3 * rng.standard_normal((n, 2)),
         1e-4 * rng.standard_normal((n, 2))], axis=1).astype(dtype)


@pytest.mark.parametrize("f64", [False, True], ids=["f32", "f64"])
def test_collar_energy_matches_generic_and_jax(f64):
    """Value and node-table gradient of the compact collar term against
    the generic gather over ``extra_conn`` (port) and JAX's collar."""
    jm, tm = _meshes("one_hole", torch.float64 if f64 else torch.float32)
    node = _node(jm, seed=3, dtype=np.float64 if f64 else np.float32)
    with jax.enable_x64(f64):
        vj, gj = jax.value_and_grad(
            lambda n: jle.collar_energy(n, jm.hybrid, E, NU, W_SUM))(
                jnp.asarray(node))
        vj, gj = float(vj), np.asarray(gj)
    out = []
    for fn in (lambda n: tle.collar_energy(n, tm.hybrid, E, NU, W_SUM),
               lambda n: tle.extra_elements_energy(
                   n, tm.hybrid.extra_conn, E, NU, W_SUM)):
        x = torch.tensor(node, requires_grad=True)
        v = fn(x)
        (g,) = torch.autograd.grad(v, x)
        out.append((float(v.detach()), g.numpy()))
    rtol = 1e-10 if f64 else 1e-5
    for v, g in out:
        assert np.isclose(v, vj, rtol=rtol), (v, vj)
        _assert_grad(g, gj, f64)
    # rows no collar triangle touches get exactly zero
    used = np.zeros(jm.n_nodes, bool)
    used[np.asarray(jm.hybrid.extra_conn).reshape(-1)] = True
    assert not out[0][1][~used].any()


def test_take_sorted_rows_backward_is_index_add():
    rng = np.random.default_rng(4)
    node = torch.tensor(rng.standard_normal((9, 4)), requires_grad=True)
    ids = torch.tensor([1, 4, 5, 8], dtype=torch.int32)
    ct = torch.tensor(rng.standard_normal((4, 4)))
    (g,) = torch.autograd.grad(
        torch.sum(tle._take_sorted_rows(node, ids) * ct), node)
    (g_ref,) = torch.autograd.grad(torch.sum(node[ids.long()] * ct), node)
    np.testing.assert_array_equal(g.numpy(), g_ref.numpy())


# ----------------------------------------------------------------- total
def _body_force_j(x):
    return jnp.stack([jnp.sin(x[:, 0]) * 1e4, x[:, 1] * 2e4], axis=1)


def _body_force_t(x):
    return torch.stack([torch.sin(x[:, 0]) * 1e4, x[:, 1] * 2e4], dim=1)


def _traction_j(x):
    return jnp.stack([1e5 + 0 * x[:, 1], 2e4 * x[:, 1]], axis=1)


def _traction_t(x):
    return torch.stack([1e5 + 0 * x[:, 1], 2e4 * x[:, 1]], dim=1)


CASES = {
    "default": ({}, {}),
    "traction": (dict(traction=_traction_j), dict(traction=_traction_t)),
    "body_force": (dict(body_force=_body_force_j),
                   dict(body_force=_body_force_t)),
}


def _jax_total(jm, params_np, kw, f64=False):
    jdt = jnp.float64 if f64 else jnp.float32
    with jax.enable_x64(f64):
        je = ht.PlaneStressEnergy(model=ht.TriangleP1(dtype=jdt), **kw)
        assert je._hybrid_total(to_jax(params_np, jdt), jm) is not None
        v, g = jax.value_and_grad(lambda p: je.total(p, jm))(
            to_jax(params_np, jdt))
        return float(v), {k: np.asarray(x) for k, x in g.items()}


def _port_total(tm, params_np, kw, dtype=torch.float32):
    te = pt.PlaneStressEnergy(model=pt.TriangleP1(dtype=dtype), **kw)
    p = to_torch(params_np, dtype=dtype, requires_grad=True)
    v = te.total(p, tm)
    gc, gu = torch.autograd.grad(v, [p["coords"], p["u"]])
    return float(v.detach()), {"coords": gc.numpy(), "u": gu.numpy()}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("name", ["up", "zigzag", "one_hole"])
def test_hybrid_total_matches_jax(name, case):
    """total() on the hybrid route in both packages (f32)."""
    jkw, tkw = CASES[case]
    jm, tm = _meshes(name)
    params_np = random_params(jm, seed=7)
    vj, gj = _jax_total(jm, params_np, jkw)
    te = pt.PlaneStressEnergy(model=pt.TriangleP1(), **tkw)
    assert te._hybrid_total(to_torch(params_np), tm) is not None
    vt, gt = _port_total(tm, params_np, tkw)
    assert_close(vt, vj, rtol=1e-5)
    for k in ("coords", "u"):
        _assert_grad(gt[k], gj[k])


@pytest.mark.parametrize("case", ["default", "body_force"])
def test_hybrid_total_f64_matches_jax(case):
    jkw, tkw = CASES[case]
    jm, tm = _meshes("zigzag", torch.float64)
    params_np = random_params(jm, seed=8)
    vj, gj = _jax_total(jm, params_np, jkw, f64=True)
    vt, gt = _port_total(tm, params_np, tkw, torch.float64)
    assert_close(vt, vj, rtol=1e-10)
    for k in ("coords", "u"):
        _assert_grad(gt[k], gj[k], f64=True)


@pytest.mark.parametrize("case", sorted(CASES))
def test_hybrid_route_equals_gather_route(case):
    """In the port, the hybrid route against the same mesh with the route
    stripped, which takes the gather route over the full connectivity
    (as ``tests/test_hybrid.py::test_energy_equals_generic_path`` does in
    the JAX package)."""
    _, tkw = CASES[case]
    jm, tm = _meshes("up", torch.float64)
    params_np = random_params(jm, seed=9)
    v_route, g_route = _port_total(tm, params_np, tkw, torch.float64)
    v_gen, g_gen = _port_total(dataclasses.replace(tm, hybrid=None),
                               params_np, tkw, torch.float64)
    assert_close(v_route, v_gen, rtol=1e-10)
    for k in ("coords", "u"):
        _assert_grad(g_route[k], g_gen[k], f64=True)


def test_hybrid_lbfgs_matches_jax():
    """Ten L-BFGS steps from u0 = 1e-5 N(0,1) on the hybrid route in both
    packages (f32).  rtol 5e-3: the first fixed step jumps to ~1e10 and
    each package's f32 rounding of it carries into the later steps, as
    in ``tests/test_torch_delaunay.py``."""
    jm, tm = _meshes("zigzag")
    u0 = 1e-5 * np.random.default_rng(0).standard_normal((jm.n_nodes, 2))
    je = ht.PlaneStressEnergy(model=ht.TriangleP1())
    _, lj = ht.run_lbfgs(je.total, {"coords": jm.coords,
                                    "u": jnp.asarray(u0, jnp.float32)},
                         num_steps=10, loss_args=(jm,))
    te = pt.PlaneStressEnergy(model=pt.TriangleP1())
    _, lt = pt.run_lbfgs(te.total, pt.params_from_numpy(
        {"coords": tm.coords.numpy(), "u": u0}, device=CPU), num_steps=10,
        loss_args=(tm,))
    lt = lt.numpy()
    assert np.all(np.isfinite(lt)) and lt[-1] < lt[0]
    assert_close(lt, np.asarray(lj), rtol=5e-3)
