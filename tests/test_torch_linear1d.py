"""The port's 1D model, L2 loss and bar energy (``models/linear1d.py``,
``ops/losses.py``, ``postproc.derivative_1d_per_element``) against the JAX
package on the same numpy inputs.

Mirrors ``tests/test_linear1d.py``, ``tests/test_losses_1d.py`` and the
example-1 row of ``tests/test_baseline_parity.py``.  The same numpy params
go to both packages.

Tolerances.  f32: rtol 1e-6 on grids (the softplus-cumsum-rescale of
either package rounds in its own order), rtol 1e-5 on values and losses,
rtol 1e-4 with atol 1e-5 x max|g| on gradients (sums through cumsum);
f64 (JAX under ``jax.enable_x64``): rtol 1e-12 on grids and values, rtol
1e-10 with atol 1e-12 x max|g| on gradients.  Fixed-coordinate grids
(``x_inner``) are the same numbers in both packages, so evaluation at
their nodes is held bit for bit, and the derivative there at rtol 1e-6
(the element of a nodal point is the left one in both:
``searchsorted(side="left") - 1``; the slopes of neighbouring elements
differ by far more).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hidenn_fem_tpu as ht
import hidenn_fem_tpu_torch as pt
from examples.example3 import b_force as jax_b_force
from examples.example3 import u_true
from examples.example3_torch import b_force as port_b_force
from hidenn_fem_tpu import postproc as jpost
from hidenn_fem_tpu_torch import postproc as tpost
from hidenn_fem_tpu_torch.models import linear1d as tl1

from torch_port_common import (CPU, DTYPES, assert_close, set_both,
                               value_and_grads)

TOL = {"f32": dict(grid=1e-6, val=1e-5, grad=1e-4, atol=1e-5),
       "f64": dict(grid=1e-12, val=1e-12, grad=1e-10, atol=1e-12)}


def _pair(coords, dt="f32", **kw):
    """(JAX model, JAX params, port model, port params) of one grid."""
    jdt, tdt = DTYPES[dt]
    jm, jp = ht.Linear1D.from_node_coords(coords, dtype=jdt, **kw)
    tm, tp = pt.Linear1D.from_node_coords(coords, dtype=tdt, device=CPU,
                                          **kw)
    return jm, jp, tm, tp


def _assert_grads(got, want, dt):
    tol = TOL[dt]
    for k in want:
        ref = np.asarray(want[k])
        assert_close(got[k].numpy(), ref, tol["grad"],
                     tol["atol"] * max(np.abs(ref).max(), 1e-300), k)


@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_grid_init_matches_coords(dt):
    """Uniform coords (raw-diff init) and non-uniform coords
    (inverse-softplus init, exact initial geometry), against JAX."""
    for coords in (np.linspace(0, 1, 50),
                   np.sort(np.r_[0.0, np.random.default_rng(0)
                                 .uniform(0, 1, 30), 1.0])):
        with jax.enable_x64(dt == "f64"):
            jm, jp, tm, tp = _pair(coords, dt, r_adapt=True)
            jg = np.asarray(jm.grid(jp))
        assert_close(tm.grid(tp).numpy(), jg, TOL[dt]["grid"], 0, "grid")
        np.testing.assert_allclose(tm.grid(tp).numpy(), coords, atol=1e-6)


def test_grid_nonuniform_non_adaptive_is_exact():
    coords = np.array([0.0, 0.1, 0.5, 0.6, 1.0])
    jm, jp, tm, tp = _pair(coords)
    assert tm.x_inner == jm.x_inner
    np.testing.assert_array_equal(tm.grid(tp).numpy(), np.asarray(jm.grid(jp)))


@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_grid_monotone_under_any_increments(dt):
    """Random increments (some far below the softplus floor, some above
    torch's softplus threshold of 20) give JAX's monotone grid."""
    rng = np.random.default_rng(1234)
    inc = rng.normal(size=19) * 5
    inc[[3, 11]] = (-40.0, 30.0)
    with jax.enable_x64(dt == "f64"):
        jm, jp, tm, tp = _pair(np.linspace(0, 2, 20), dt, r_adapt=True)
        set_both(jp, tp, dt, x_increments=inc)
        jg = np.asarray(jm.grid(jp))
    g = tm.grid(tp).numpy()
    assert np.all(np.diff(g) > 0), "reparameterized grid must stay monotone"
    assert g[0] == 0.0 and np.isclose(g[-1], 2.0)
    assert_close(g, jg, TOL[dt]["grid"], 0, "grid")


def test_linear_interpolation_exact():
    """The piecewise-linear space reproduces linear functions."""
    jm, jp, tm, tp = _pair(np.linspace(0, 1, 17))
    nodes = tm.grid(tp).numpy().astype(np.float64)
    set_both(jp, tp, "f32", u=3.0 * nodes - 1.0)
    x = np.random.default_rng(0).uniform(0, 1, 200).astype(np.float32)
    got = tm.apply(tp, torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, 3.0 * x - 1.0, atol=1e-5)
    assert_close(got, np.asarray(jm.apply(jp, jnp.asarray(x))), 1e-5, 1e-6)


def test_nodal_points_take_the_left_element_as_jax():
    """u_h(x_i) == u_i at every node, and du/dx at a node is the slope of
    the element on its left (the first node: the first element), bit for
    bit as in JAX, on a fixed non-uniform grid."""
    coords = np.array([0.0, 0.1, 0.25, 0.5, 0.6, 0.9, 1.0])
    jm, jp, tm, tp = _pair(coords)
    set_both(jp, tp, "f32", u=np.arange(7.0) ** 2)
    nodes = np.asarray(jm.grid(jp))
    got = tm.apply(tp, torch.tensor(nodes)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jm.apply(jp, nodes)))
    np.testing.assert_allclose(got, np.arange(7.0) ** 2, rtol=1e-6)
    d_port = tm.du_dx(tp, torch.tensor(nodes)).numpy()
    d_jax = np.asarray(jm.du_dx(jp, jnp.asarray(nodes)))
    np.testing.assert_allclose(d_port, d_jax, rtol=1e-6)
    slopes = np.diff(np.arange(7.0) ** 2) / np.diff(coords)
    np.testing.assert_allclose(d_port, np.r_[slopes[0], slopes], rtol=1e-5)


def test_dirichlet_values_baked_in():
    jm, jp, tm, tp = _pair(np.linspace(0, 1, 10), u0=2.0, uN=-1.0)
    assert tp["u"].shape == (8,)
    uf = tm.u_full(tp).numpy()
    assert uf[0] == 2.0 and uf[-1] == -1.0
    np.testing.assert_array_equal(uf, np.asarray(jm.u_full(jp)))
    assert float(tm.apply(tp, torch.tensor([0.0]))[0]) == 2.0
    _, g = value_and_grads(lambda p: torch.sum(tm.apply(
        p, torch.linspace(0, 1, 30)) ** 2), tp)
    assert g["u"].shape == (8,)


@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_du_dx_matches_jax_and_finite_difference(dt):
    with jax.enable_x64(dt == "f64"):
        jm, jp, tm, tp = _pair(np.linspace(0, 1, 11), dt)
        set_both(jp, tp, dt, u=np.sin(np.linspace(0, 1, 11)))
        x = np.asarray([0.05, 0.13, 0.77, 0.5])
        jd = np.asarray(jm.du_dx(jp, jnp.asarray(x, DTYPES[dt][0])))
    d = tm.du_dx(tp, torch.tensor(x, dtype=DTYPES[dt][1])).numpy()
    assert_close(d, jd, TOL[dt]["val"], 0, "du/dx")
    eps = 1e-3                  # inside the elements (0.5 is a node)
    xt = torch.tensor(x[:3], dtype=DTYPES[dt][1])
    fd = (tm.apply(tp, xt + eps) - tm.apply(tp, xt - eps)).numpy() / (2 * eps)
    np.testing.assert_allclose(d[:3], fd, rtol=1e-3)


@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_l2_gradients_match_jax(dt):
    """Both gradient groups (u, increments) of the L2 loss."""
    rng = np.random.default_rng(3)
    with jax.enable_x64(dt == "f64"):
        jm, jp, tm, tp = _pair(np.linspace(0, 1, 30), dt, r_adapt=True)
        set_both(jp, tp, dt, u=rng.normal(size=30),
             x_increments=np.diff(np.linspace(0, 1, 30))
             * np.exp(0.3 * rng.normal(size=29)))
        x = np.linspace(0.01, 0.99, 100)
        jx = jnp.asarray(x, DTYPES[dt][0])
        tgt = jnp.sin(2 * jnp.pi * jx)
        jv, jg = jax.value_and_grad(
            lambda p: ht.l2_loss(jm, p, jx, tgt))(jp)
    tx = torch.tensor(x, dtype=DTYPES[dt][1])
    ttgt = torch.tensor(np.asarray(tgt))
    tv, tg = value_and_grads(lambda p: pt.l2_loss(tm, p, tx, ttgt), tp)
    assert_close(float(tv), float(jv), TOL[dt]["val"], 0, "loss")
    _assert_grads(tg, jg, dt)
    assert float(tg["x_increments"].norm()) > 0


def test_double_grad_matches_jax():
    """grad of sum(du/dx^2) through the located elements (f64)."""
    with jax.enable_x64(True):
        jm, jp, tm, tp = _pair(np.linspace(0, 1, 12), "f64", u0=0.0,
                               uN=0.0, r_adapt=True)
        set_both(jp, tp, "f64", u=np.random.default_rng(0).normal(size=10))
        x = np.linspace(0.03, 0.97, 40)
        jx = jnp.asarray(x)

        def loss(p):
            _, du = jax.jvp(lambda xx: jm.apply(p, xx), (jx,),
                            (jnp.ones_like(jx),))
            return jnp.sum(du ** 2)

        jg = jax.jit(jax.grad(loss))(jp)
    tx = torch.tensor(x)
    _, tg = value_and_grads(lambda p: torch.sum(tm.du_dx(p, tx) ** 2), tp)
    _assert_grads(tg, jg, "f64")
    assert float(tg["u"].norm()) > 0


def test_clip_and_softplus_follow_jax_at_ties_and_large_inputs():
    """``_clip_min`` gives gradient 1/2 at an exact tie, 1 above, 0 below
    (``jnp.clip``); ``_softplus`` is ``jax.nn.softplus`` also above 20."""
    with jax.enable_x64(True):
        m = 1e-6
        xs = np.array([m, 0.5 * m, 2 * m, 0.0])
        want = [float(jax.grad(lambda v: jnp.clip(v, min=m))(jnp.float64(v)))
                for v in xs]
        xs_sp = np.array([-40.0, -1.0, 0.0, 3.0, 25.0, 50.0])
        sp = np.asarray(jax.nn.softplus(jnp.asarray(xs_sp)))
        dsp = np.asarray(jax.vmap(jax.grad(jax.nn.softplus))(
            jnp.asarray(xs_sp)))
    x = torch.tensor(xs, requires_grad=True)
    y = tl1._clip_min(x, m)
    (g,) = torch.autograd.grad(y.sum(), x)
    np.testing.assert_array_equal(y.detach().numpy(), np.maximum(xs, m))
    np.testing.assert_array_equal(g.numpy(), want)
    assert want[0] == 0.5
    x = torch.tensor(xs_sp, requires_grad=True)
    y = tl1._softplus(x)
    (g,) = torch.autograd.grad(y.sum(), x)
    np.testing.assert_allclose(y.detach().numpy(), sp, rtol=1e-15)
    np.testing.assert_allclose(g.numpy(), dsp, rtol=1e-15)


def _bar_pair(n_nodes, dt="f32"):
    return _pair(np.linspace(0, 10, n_nodes), dt, r_adapt=True, u0=0.0,
                 uN=0.0)


def test_bar_energy_zero_at_zero_u():
    _, _, tm, tp = _bar_pair(89)
    assert float(pt.bar_energy_1d(tm, tp, 2, port_b_force,
                                  E=175.0).detach()) == 0.0


@pytest.mark.parametrize("geometry", [True, False], ids=["diff", "E5"])
@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_bar_energy_and_both_gradient_groups_match_jax(dt, geometry):
    """Value, d/du and d/d increments of the bar energy, with the
    differentiable quadrature map and with quirk E5's detach."""
    rng = np.random.default_rng(0)
    with jax.enable_x64(dt == "f64"):
        jm, jp, tm, tp = _bar_pair(21, dt)
        set_both(jp, tp, dt, u=rng.normal(size=19) * 1e-3,
             x_increments=0.5 * np.exp(0.2 * rng.normal(size=20)))
        jv, jg = jax.value_and_grad(lambda p: ht.bar_energy_1d(
            jm, p, 2, jax_b_force, E=175.0,
            differentiable_geometry=geometry))(jp)
    tv, tg = value_and_grads(lambda p: pt.bar_energy_1d(
        tm, p, 2, port_b_force, E=175.0, differentiable_geometry=geometry),
        tp)
    assert_close(float(tv), float(jv), TOL[dt]["val"], 0, "energy")
    _assert_grads(tg, jg, dt)


def test_gradients_flow_through_quadrature_geometry():
    """The default differentiable map and quirk E5 give different
    increment gradients, both finite."""
    _, _, tm, tp = _bar_pair(21)
    tp["u"] = torch.tensor(np.random.default_rng(0).normal(size=19) * 1e-3,
                           dtype=torch.float32)
    g = {geo: value_and_grads(lambda p: pt.bar_energy_1d(
        tm, p, 2, port_b_force, E=175.0, differentiable_geometry=geo),
        tp)[1] for geo in (True, False)}
    for gg in g.values():
        for k, v in gg.items():
            assert torch.isfinite(v).all(), k
    assert not np.allclose(g[True]["x_increments"].numpy(),
                           g[False]["x_increments"].numpy())


def test_bar_energy_without_grad_mode():
    """Under ``torch.no_grad`` the energy still takes du/dx (the value
    equals the one with gradients)."""
    _, _, tm, tp = _bar_pair(15)
    tp["u"] = torch.linspace(-1e-3, 1e-3, 13)
    with torch.no_grad():
        e0 = pt.bar_energy_1d(tm, tp, 3, port_b_force, E=175.0)
    e1 = pt.bar_energy_1d(tm, tp, 3, port_b_force, E=175.0)
    assert float(e0) == float(e1.detach()) != 0.0 and not e0.requires_grad


def test_bar_solve_matches_exact_and_jax():
    """2500 Adam steps (lr 1e-4) reach the exact solution within 5e-4 RMS
    (``tests/test_losses_1d.py``); the loss history follows JAX's (rtol
    1e-3: f32 rounding carried through 2500 Adam steps)."""
    jm, jp, tm, tp = _bar_pair(89)
    tp, tl = pt.minimize(
        lambda p: pt.bar_energy_1d(tm, p, 2, port_b_force, E=175.0), tp,
        method="adam", num_steps=2500, learning_rate=1e-4)
    _, jl = ht.minimize(
        lambda p: ht.bar_energy_1d(jm, p, 2, jax_b_force, E=175.0), jp,
        method="adam", num_steps=2500, learning_rate=1e-4)
    xs = np.linspace(0, 10, 1500)
    with torch.no_grad():
        u_h = tm.apply(tp, torch.tensor(xs, dtype=torch.float32)).numpy()
    err = np.sqrt(np.mean((u_h - u_true(xs, 175.0)) ** 2))
    assert err < 5e-4, err
    steps = [100, 500, 1000, 2499]
    assert_close(tl.numpy()[steps], np.asarray(jl)[steps], 1e-3, 0,
                 "bar history")


@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_derivative_1d_per_element_matches_jax(dt):
    rng = np.random.default_rng(5)
    with jax.enable_x64(dt == "f64"):
        jm, jp, tm, tp = _pair(np.linspace(0, 1, 16), dt, r_adapt=True)
        set_both(jp, tp, dt, u=rng.normal(size=16),
             x_increments=np.full(15, 1 / 15) * np.exp(
                 0.2 * rng.normal(size=15)))
        jd = np.asarray(jpost.derivative_1d_per_element(jm, jp))
    d = tpost.derivative_1d_per_element(tm, tp)
    assert d.shape == (15,)
    assert_close(d.detach().numpy(), jd, 1e-4 if dt == "f32" else 1e-10,
                 0, "du/dx per element")


def test_example1_mse_parity():
    """Example 1 at its own size (100 nodes, r-adaptive, Adam lr 5e-3, 500
    epochs): the loss at init JAX's (rtol 1e-6), and the final MSE under
    the JAX test's 6.5e-7 (baseline 3.24e-7) and within a factor 1.1 of
    JAX's own run.  The histories between are not held pointwise: some
    training points are grid nodes (i/99 = j/999 for i a multiple of
    11), where the element, and so the increments' gradient, hangs on the
    last bit of the grid, and Adam's normalized steps carry that on (the
    f64 runs of the two packages part by 6e-5 within 100 epochs)."""
    x = np.linspace(0, 1, 1000)
    jm, jp, tm, tp = _pair(np.linspace(0, 1, 100), r_adapt=True)
    jx = jnp.asarray(x, jnp.float32)
    _, jl = ht.minimize(lambda p: ht.l2_loss(jm, p, jx, jnp.sin(2 * jnp.pi
                                                                * jx)),
                        jp, method="adam", num_steps=500, learning_rate=5e-3)
    tx = torch.tensor(x, dtype=torch.float32)
    _, tl = pt.minimize(lambda p: pt.l2_loss(tm, p, tx, torch.sin(
        2 * np.pi * tx)), tp, method="adam", num_steps=500,
        learning_rate=5e-3)
    final, jfinal = float(tl[-1]), float(jl[-1])
    assert final < 6.5e-7, final
    assert abs(np.log(final / jfinal)) < np.log(1.1), (final, jfinal)
    assert_close(float(tl[0]), float(jl[0]), 1e-6, 0, "loss at init")
