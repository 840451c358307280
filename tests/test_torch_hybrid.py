"""The port's hybrid lattice+collar meshes (``mesh/hybrid.py``, the collar
term of ``ops/lattice_energy.py``, ``PlaneStressEnergy._hybrid_total``)
against the JAX package on the same numpy inputs.

* Generation: the same mesh arrays, the same ``LatticeRoute`` over the
  node-table prefix and the same compact collar tables, for the three
  diagonal variants, one hole, no hole; the same rejections.
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
