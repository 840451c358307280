"""The port's model, energy and post-processing against the JAX package on
the same numpy inputs (the JAX energy on the gather route: lattice
stripped, Pallas kernel in interpret mode).

Tolerances.  f32: rtol 1e-5 on energies (sums in another order); rtol
5e-4 on gradients with atol 1e-5 x max|grad|, because coordinate
gradients are sums of cancelling terms: on the holes plate both packages'
f32 coordinate gradients lie ~4e-6 x max|grad| from an f64 reference
(measured, JAX and port alike); rtol 1e-5 on pointwise fields (same
per-element arithmetic).  f64 (JAX under ``jax.enable_x64``): rtol 1e-10
on energies, rtol 1e-8 with atol 1e-11 x max|grad| on gradients.
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
from hidenn_fem_tpu.ops.losses import mesh_quality_penalty as jpenalty
from hidenn_fem_tpu_torch import postproc as tpost
from hidenn_fem_tpu_torch.ops.losses import mesh_quality_penalty as tpenalty

from torch_port_common import (assert_close, jax_mesh, port_mesh,
                               random_params, to_jax, to_torch)

MESHES = {
    "proxy_plate": lambda: dataclasses.replace(
        ht.proxy_plate_mesh(nx=21, ny=11), lattice=None),
    "holes_plate": lambda: jax_mesh(holes=((0.5, 0.7, 0.12),
                                           (1.0, 0.3, 0.15),
                                           (1.4, 0.6, 0.1)),
                                    nx=41, ny=21, keep_dead_nodes=True),
}


def _energies(jax_kw=None, port_kw=None, compat="exact", f64=False):
    jm = ht.TriangleP1(compat=compat,
                       dtype=jnp.float64 if f64 else jnp.float32)
    tm = pt.TriangleP1(compat=compat,
                       dtype=torch.float64 if f64 else torch.float32)
    je = ht.PlaneStressEnergy(model=jm, **(jax_kw or {}))
    te = pt.PlaneStressEnergy(model=tm, **(port_kw or {}))
    return je, te


def _value_and_grads(je, te, mesh_j, params_np, fn="total", f64=False):
    jdt, tdt = ((jnp.float64, torch.float64) if f64
                else (jnp.float32, torch.float32))
    mesh_t = port_mesh(mesh_j, dtype=tdt)
    with jax.enable_x64(f64):
        if f64:
            mesh_j = ht.TriMesh.from_arrays(
                *[np.asarray(a) for a in mesh_j.astuple()], dtype=jdt,
                build_lattice=False)
        pj = to_jax(params_np, dtype=jdt)
        vj, gj = jax.jit(jax.value_and_grad(
            lambda p, m: getattr(je, fn)(p, m)))(pj, mesh_j)
        vj, gj = float(vj), {k: np.asarray(v) for k, v in gj.items()}
    pt_ = to_torch(params_np, dtype=tdt, requires_grad=True)
    vt = getattr(te, fn)(pt_, mesh_t)
    gt = torch.autograd.grad(vt, [pt_["coords"], pt_["u"]])
    return (vj, gj, float(vt.detach()),
            dict(zip(("coords", "u"), (g.numpy() for g in gt))))


def _assert_value(vt, vj, f64=False):
    assert np.isclose(vt, vj, rtol=1e-10 if f64 else 1e-5, atol=0.0), \
        (vt, vj)


def _assert_grads(gt, gj, f64=False):
    rtol, scale = (1e-8, 1e-11) if f64 else (5e-4, 1e-5)
    for k in ("coords", "u"):
        assert_close(gt[k], gj[k], rtol=rtol,
                     atol=scale * np.abs(gj[k]).max(), what=k)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("fuse_edges", [False, True])
@pytest.mark.parametrize("f64", [False, True], ids=["f32", "f64"])
def test_total_and_both_gradients_match_jax(mesh_name, fuse_edges, f64):
    mesh_j = MESHES[mesh_name]()
    params_np = random_params(mesh_j, seed=1)
    je, te = _energies(dict(backend="pallas_interpret",
                            fuse_edges=fuse_edges),
                       dict(fuse_edges=fuse_edges), f64=f64)
    vj, gj, vt, gt = _value_and_grads(je, te, mesh_j, params_np, f64=f64)
    _assert_value(vt, vj, f64)
    _assert_grads(gt, gj, f64)
    # pinned entries get exactly zero gradients in both packages
    pinned = np.asarray(mesh_j.dirichlet_mask)
    assert np.all(gt["u"][pinned] == 0.0)
    assert np.all(gt["coords"][np.asarray(mesh_j.geom_boundary_mask)] == 0)


def test_fuse_edges_equals_domain_minus_edge():
    mesh_j = MESHES["holes_plate"]()
    mesh_t = port_mesh(mesh_j)
    assert mesh_t.fused_connectivity.shape[0] == (mesh_t.n_elements
                                                  + mesh_t.n_neumann_edges)
    p = to_torch(random_params(mesh_j, seed=2))
    model = pt.TriangleP1()
    fused = pt.PlaneStressEnergy(model=model, fuse_edges=True)
    split = pt.PlaneStressEnergy(model=model)
    assert fused._fused_total(p, mesh_t) is not None
    assert split._fused_total(p, mesh_t) is None
    v1 = float(fused.total(p, mesh_t))
    v2 = float(split.domain_energy(p, mesh_t) - split.edge_energy(p, mesh_t))
    assert np.isclose(v1, v2, rtol=1e-6), (v1, v2)
    # a custom traction disables the fused path
    custom = pt.PlaneStressEnergy(model=model, fuse_edges=True,
                                  traction=lambda x: torch.ones_like(x))
    assert custom._fused_total(p, mesh_t) is None


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_reference_compat_quadrature_path_matches_jax(mesh_name):
    """compat="reference": quirks E3 (edge rule), E7 (halved order-4
    weights) and the model's E9 (Jacobian transpose) on the general
    quadrature path, value and both gradient groups."""
    mesh_j = MESHES[mesh_name]()
    params_np = random_params(mesh_j, seed=3)
    je, te = _energies(dict(compat="reference"), dict(compat="reference"),
                       compat="reference")
    vj, gj, vt, gt = _value_and_grads(je, te, mesh_j, params_np)
    _assert_value(vt, vj)
    _assert_grads(gt, gj)


@pytest.mark.parametrize("assembly", ["fused", "quadrature"])
def test_body_force_paths_match_jax(assembly):
    """A body force on the fused path (_body_work_gathered) and on the
    quadrature path at physical points (E8 corrected), and under compat
    (E8: reference-triangle coordinates)."""
    mesh_j = MESHES["proxy_plate"]()
    params_np = random_params(mesh_j, seed=4)

    def bf_j(x):
        return jnp.stack([1e6 * x[:, 1], -2e6 * x[:, 0] * x[:, 0]], axis=1)

    def bf_t(x):
        return torch.stack([1e6 * x[:, 1], -2e6 * x[:, 0] * x[:, 0]], dim=1)

    for compat in ("exact", "reference"):
        if compat == "reference" and assembly == "fused":
            continue
        je, te = _energies(
            dict(assembly=assembly, body_force=bf_j, compat=compat,
                 backend="pallas_interpret"),
            dict(assembly=assembly, body_force=bf_t, compat=compat))
        vj, gj, vt, gt = _value_and_grads(je, te, mesh_j, params_np,
                                          fn="domain_energy")
        _assert_value(vt, vj)
        _assert_grads(gt, gj)


def test_custom_traction_edge_quadrature_matches_jax():
    mesh_j = MESHES["holes_plate"]()
    params_np = random_params(mesh_j, seed=5)
    je, te = _energies(dict(traction=lambda x: jnp.stack(
        [1e5 * (1 + x[:, 1]), 3e4 * x[:, 1]], axis=1)),
        dict(traction=lambda x: torch.stack(
            [1e5 * (1 + x[:, 1]), 3e4 * x[:, 1]], dim=1)))
    vj, gj, vt, gt = _value_and_grads(je, te, mesh_j, params_np,
                                      fn="edge_energy")
    _assert_value(vt, vj)
    _assert_grads(gt, gj)


def test_mesh_penalty_and_model_fields_match_jax():
    mesh_j = MESHES["holes_plate"]()
    mesh_t = port_mesh(mesh_j)
    params_np = random_params(mesh_j, seed=6)
    pj, ptt = to_jax(params_np), to_torch(params_np)
    jm, tm = ht.TriangleP1(), pt.TriangleP1()
    assert np.isclose(float(tpenalty(tm, ptt, mesh_t)),
                      float(jpenalty(jm, pj, mesh_j)), rtol=1e-5)
    assert np.isclose(float(tm.min_abs_detJ(ptt, mesh_t)),
                      float(jm.min_abs_detJ(pj, mesh_j)), rtol=1e-5)
    rng = np.random.default_rng(7)
    x_ref = rng.uniform(0, 0.5, (40, 2)).astype(np.float32)
    elem = rng.integers(0, mesh_t.n_elements, 40)
    for compat in ("exact", "reference"):
        jmc, tmc = ht.TriangleP1(compat=compat), pt.TriangleP1(compat=compat)
        for a, b in zip(tmc.apply_domain(ptt, mesh_t, x_ref, elem),
                        jmc.apply_domain(pj, mesh_j, x_ref, elem)):
            assert_close(a.numpy(), b, rtol=1e-5, atol=1e-12)
    xi = np.asarray([0.0, 0.3, 1.0], np.float32)
    eid = np.asarray([0, 1, 2])
    for a, b in zip(tm.apply_edge(ptt, mesh_t, xi, eid),
                    jm.apply_edge(pj, mesh_j, xi, eid)):
        assert_close(a.numpy(), b, rtol=1e-5, atol=1e-12)
    assert_close(tm.edge_points(ptt, mesh_t, xi, eid).numpy(),
                 jm.edge_points(pj, mesh_j, xi, eid), rtol=1e-6)


def test_von_mises_and_displacement_match_jax_postproc():
    mesh_j = MESHES["holes_plate"]()
    mesh_t = port_mesh(mesh_j)
    params_np = random_params(mesh_j, seed=8)
    pj, ptt = to_jax(params_np), to_torch(params_np)
    jm, tm = ht.TriangleP1(), pt.TriangleP1()
    vm_j = jpost.von_mises_per_element(jm, pj, mesh_j, 10e9, 0.3)
    vm_t = tpost.von_mises_per_element(tm, ptt, mesh_t, 10e9, 0.3)
    assert_close(vm_t.numpy(), vm_j, rtol=1e-5, atol=1e-6 * float(
        np.max(vm_j)))
    for a, b in zip(tpost.displacement_magnitude(tm, ptt, mesh_t),
                    jpost.displacement_magnitude(jm, pj, mesh_j)):
        assert_close(a.numpy(), b, rtol=1e-6)


def test_backend_resolution():
    mesh_t = pt.proxy_plate_mesh(nx=5, ny=3)
    p = pt.TriangleP1().init(torch.Generator().manual_seed(0), mesh_t)
    node = pt.TriangleP1().packed_nodes(p, mesh_t)
    auto = pt.PlaneStressEnergy(model=pt.TriangleP1())
    assert auto._resolve_backend(node) == "plain"
    kernel = pt.PlaneStressEnergy(model=pt.TriangleP1(), backend="kernel")
    with pytest.raises(ValueError):
        kernel.total(p, mesh_t)
    with pytest.raises(ValueError):
        pt.PlaneStressEnergy(model=pt.TriangleP1(), backend="pallas")
