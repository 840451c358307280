"""The port's node-space L-BFGS (``solve/nodespace.py``) against the JAX
package's, from the same numpy mesh and params.

Tolerances: ``grad_gate`` and ``node_free_mask`` exact; the masked node
gradient against the params gradient rtol 1e-6 with atol 1e-8 (f32, the
JAX test's limits), and against JAX's node gradient likewise (atol 1e-5 x
max|grad| on the coordinate columns, sums of cancelling terms: see
tests/test_torch_losses.py); the 30-step node-space L-BFGS loss history
against JAX's in f64 at rtol 1e-8 (the fixed-step solve amplifies f32
rounding), and its plateau against the port's params-space solve at
rtol 1e-3 (``tests/test_nodespace.py``'s limit).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hidenn_fem_tpu as ht
import hidenn_fem_tpu_torch as pt
from hidenn_fem_tpu.solve import nodespace as jns
from hidenn_fem_tpu_torch.solve import nodespace as tns

from torch_port_common import CPU, assert_close


def _plate(f64=False):
    """The 17x9 "up" plate (lattice route in both packages), JAX's and the
    port's, with the same numpy params."""
    jm = ht.generate_mesh(nx=17, ny=9, holes=(), variant="up")
    if f64:
        jm = ht.TriMesh.from_arrays(*[np.asarray(a) for a in jm.astuple()],
                                    dtype=jnp.float64)
    tdt = torch.float64 if f64 else torch.float32
    tm = pt.mesh_from_numpy(jm, device=CPU, dtype=tdt)
    assert jm.lattice is not None and tm.lattice is not None
    rng = np.random.default_rng(0)
    params = {"coords": np.asarray(jm.coords, np.float64),
              "u": 1e-5 * rng.standard_normal((jm.n_nodes, 2))}
    return jm, tm, params


def test_grad_gate_masks_the_gradient_as_jax():
    x = np.arange(8.0)
    m = np.array([1.0, 0, 1, 0, 1, 0, 1, 0])
    gj = jax.grad(lambda x: jnp.sum(jns.grad_gate(x, jnp.asarray(m)) ** 2))(
        jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    mt = torch.tensor(m, requires_grad=True)
    y = tns.grad_gate(xt, mt)
    assert torch.equal(y, xt.detach())
    gt, gm = torch.autograd.grad(torch.sum(y ** 2), [xt, mt],
                                 allow_unused=True)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))
    np.testing.assert_array_equal(gt.numpy(), 2 * x * m)
    assert gm is None


def test_node_free_mask_matches_jax():
    jm, tm, _ = _plate()
    jmask = jns.node_free_mask(ht.TriangleP1(), jm)
    tmask = tns.node_free_mask(pt.TriangleP1(), tm)
    assert tmask.dtype == torch.float32 and tmask.shape == (jm.n_nodes, 4)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))


def test_node_gradient_equals_params_gradient_and_jax():
    jm, tm, params = _plate()
    tmodel = pt.TriangleP1()
    te = pt.PlaneStressEnergy(model=tmodel, E=10e9, nu=0.3)
    tp = pt.params_from_numpy(params, device=CPU)
    node = tmodel.packed_nodes(tp, tm).detach().requires_grad_(True)
    mask = tns.node_free_mask(tmodel, tm)
    (g_node,) = torch.autograd.grad(
        te.total_from_nodes(tns.grad_gate(node, mask), tm), node)
    tpg = {k: v.detach().requires_grad_(True) for k, v in tp.items()}
    g_c, g_u = torch.autograd.grad(te(tpg, tm), [tpg["coords"], tpg["u"]])
    assert_close(g_node[:, 2:].numpy(), g_u.numpy(), rtol=1e-6, atol=1e-8)
    assert_close(g_node[:, :2].numpy(), g_c.numpy(), rtol=1e-6, atol=1e-8)

    jmodel = ht.TriangleP1()
    je = ht.PlaneStressEnergy(model=jmodel, E=10e9, nu=0.3)
    jp = {k: jnp.asarray(v, jnp.float32) for k, v in params.items()}
    jnode = jmodel.packed_nodes(jp, jm)
    jmask = jns.node_free_mask(jmodel, jm)
    gj = np.asarray(jax.grad(lambda n: je.total_from_nodes(
        jns.grad_gate(n, jmask), jm))(jnode))
    for cols in (slice(0, 2), slice(2, 4)):
        want = gj[:, cols]
        assert_close(g_node[:, cols].numpy(), want, rtol=1e-5,
                     atol=1e-5 * np.abs(want).max())


def test_lbfgs_node_space_matches_jax():
    with jax.enable_x64(True):
        jm, tm, params = _plate(f64=True)
        je = ht.PlaneStressEnergy(model=ht.TriangleP1(dtype=jnp.float64),
                                  E=10e9, nu=0.3)
        jsol, jl = jns.lbfgs_node_space(
            je, {k: jnp.asarray(v) for k, v in params.items()}, jm,
            num_steps=30)
        jl = np.asarray(jl)
        ju = np.asarray(jsol["u"])
    te = pt.PlaneStressEnergy(model=pt.TriangleP1(dtype=torch.float64),
                              E=10e9, nu=0.3)
    tp = pt.params_from_numpy(params, device=CPU, dtype=torch.float64)
    tsol, tl = tns.lbfgs_node_space(te, tp, tm, num_steps=30)
    assert sorted(tsol) == ["coords", "u"]
    assert tsol["u"].shape == (tm.n_nodes, 2)
    assert_close(tl.numpy(), jl, rtol=1e-8, what="loss history")
    assert_close(tsol["u"].numpy(), ju, rtol=1e-8,
                 atol=1e-8 * np.abs(ju).max(), what="u")
    # pinned entries carry their pinned values, the free ones moved
    fixed = tm.dirichlet_mask.numpy()
    assert np.all(tsol["u"].numpy()[fixed] == 0.0)
    # the plateau of the params-space solve (f32, as the JAX test)
    jm32, tm32, params = _plate()
    te32 = pt.PlaneStressEnergy(model=pt.TriangleP1(), E=10e9, nu=0.3)
    tp32 = pt.params_from_numpy(params, device=CPU)
    _, lp = pt.minimize(te32.total, tp32, method="lbfgs", num_steps=150,
                        loss_args=(tm32,))
    sol_n, ln = tns.lbfgs_node_space(te32, tp32, tm32, num_steps=150)
    scale = abs(float(lp[-1]))
    assert abs(float(ln[-1]) - float(lp[-1])) / scale < 1e-3
    with torch.no_grad():
        assert abs(float(te32(sol_n, tm32)) - float(lp[-1])) / scale < 1e-3


def test_lbfgs_node_space_needs_a_lattice_route():
    jm, _, params = _plate()
    tm = pt.mesh_from_numpy(jm, device=CPU, build_lattice=False)
    te = pt.PlaneStressEnergy(model=pt.TriangleP1(), E=10e9, nu=0.3)
    with pytest.raises(ValueError, match="lattice-routable"):
        tns.lbfgs_node_space(te, pt.params_from_numpy(params, device=CPU),
                             tm, num_steps=2)
