"""The port's structured bilinear model (``models/bilinear2d.py``), example
2's training loop and the reference-style wrappers
(``models/wrappers.py``) against the JAX package on the same numpy inputs.

Mirrors ``tests/test_bilinear2d.py`` and the wrapper case of
``tests/test_utils_aux.py``.  The two packages draw ``u`` from different
generators (a JAX key, a ``torch.Generator``), so every comparison puts
the same numpy ``u`` into both.

Tolerances.  f32: rtol 1e-6 on grids, rtol 1e-5 (atol 1e-6) on values,
rtol 1e-4 with atol 1e-5 x max|g| on gradients; f64 (JAX under
``jax.enable_x64``): rtol 1e-12 on grids and values, rtol 1e-10 with
atol 1e-12 x max|g| on gradients.  Adam histories in f32: rtol 1e-4 over
50-300 steps (f32 rounding carried by the optimizer).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import hidenn_fem_tpu as ht
import hidenn_fem_tpu_torch as pt
from hidenn_fem_tpu.models.wrappers import (
    PiecewiseLinearShapeNN as JNN1, PiecewiseLinearShapeNN2D as JNN2,
    PiecewiseLinearShapeNN2DStructured as JNN2S)
from hidenn_fem_tpu_torch.config import Projection2DConfig
from hidenn_fem_tpu_torch.models.wrappers import (
    PiecewiseLinearShapeNN, PiecewiseLinearShapeNN2D,
    PiecewiseLinearShapeNN2DStructured)

from torch_port_common import (CPU, DTYPES, assert_close, set_both,
                               value_and_grads)

TOL = {"f32": dict(grid=1e-6, val=1e-5, grad=1e-4, atol=1e-5),
       "f64": dict(grid=1e-12, val=1e-12, grad=1e-10, atol=1e-12)}


def _grids(nx=9, ny=7):
    return np.linspace(0, 1, nx), np.linspace(0, 2, ny)


def _pair(gx, gy, dt="f32", u=None, **kw):
    """(JAX model, JAX params, port model, port params), ``u`` the same
    numpy array in both (N(0, 1) from default_rng(0) when None)."""
    jdt, tdt = DTYPES[dt]
    jm, jp = ht.Bilinear2D.create(gx, gy, dtype=jdt, **kw)
    tm, tp = pt.Bilinear2D.create(gx, gy, dtype=tdt, device=CPU, **kw)
    if u is None:
        u = np.random.default_rng(0).standard_normal((len(gx), len(gy)))
    set_both(jp, tp, dt, u=u)
    return jm, jp, tm, tp


@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_grid_init_exact(dt):
    """Uniform axes (raw-diff init) and a non-uniform axis
    (inverse-softplus init) give the initial grids, as in JAX."""
    gx = np.linspace(0, 1, 9)
    gy = np.r_[0.0, np.sort(np.random.default_rng(1).uniform(0, 2, 5)), 2.0]
    with jax.enable_x64(dt == "f64"):
        jm, jp, tm, tp = _pair(gx, gy, dt, r_adapt=True)
        jgx, jgy = (np.asarray(g) for g in jm.grid(jp))
    tgx, tgy = (g.numpy() for g in tm.grid(tp))
    np.testing.assert_allclose(tgx, gx, atol=1e-6)
    np.testing.assert_allclose(tgy, gy, atol=1e-6)
    assert_close(tgx, jgx, TOL[dt]["grid"], 0, "grid_x")
    assert_close(tgy, jgy, TOL[dt]["grid"], 0, "grid_y")


def test_bilinear_exactness():
    """The bilinear space reproduces a + bx + cy + dxy."""
    gx, gy = _grids()
    f = lambda x, y: 1.0 + 2.0 * x - 0.5 * y + 3.0 * x * y  # noqa: E731
    XX, YY = np.meshgrid(gx, gy, indexing="ij")
    jm, jp, tm, tp = _pair(gx, gy, u=f(XX, YY))
    rng = np.random.default_rng(0)
    pts = np.stack([rng.uniform(0, 1, 300), rng.uniform(0, 2, 300)], axis=1)
    got = tm.apply(tp, torch.tensor(pts, dtype=torch.float32)).numpy()
    np.testing.assert_allclose(got, f(pts[:, 0], pts[:, 1]), rtol=1e-5,
                               atol=1e-5)
    assert_close(got, np.asarray(jm.apply(jp, jnp.asarray(pts,
                                                          jnp.float32))),
                 1e-5, 1e-6)


def test_u_fixed_on_boundary():
    gx, gy = _grids()
    jm, jp, tm, tp = _pair(gx, gy, u_fixed=0.0)
    u = tm.u_full(tp).numpy()
    assert np.all(u[0, :] == 0) and np.all(u[-1, :] == 0)
    assert np.all(u[:, 0] == 0) and np.all(u[:, -1] == 0)
    assert np.any(u[1:-1, 1:-1] != 0)
    np.testing.assert_array_equal(u, np.asarray(jm.u_full(jp)))
    np.testing.assert_array_equal(tm.node_mask(CPU).numpy(),
                                  np.asarray(jm.node_mask()))


@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_boundary_coords_pinned_under_adaptation(dt):
    """Random increments: the boundary coordinates stay pinned, the grids
    stay monotone and equal JAX's."""
    rng = np.random.default_rng(1234)
    gx, gy = _grids()
    with jax.enable_x64(dt == "f64"):
        jm, jp, tm, tp = _pair(gx, gy, dt, r_adapt=True)
        set_both(jp, tp, dt, increments_x=rng.normal(size=8) * 3,
             increments_y=rng.normal(size=6) * 3)
        jgx, jgy = (np.asarray(g) for g in jm.grid(jp))
    tgx, tgy = (g.numpy() for g in tm.grid(tp))
    assert tgx[0] == gx[0] and tgx[-1] == gx[-1]
    assert tgy[0] == gy[0] and tgy[-1] == gy[-1]
    assert np.all(np.diff(tgx) > 0) and np.all(np.diff(tgy) > 0)
    assert_close(tgx, jgx, TOL[dt]["grid"], 0, "grid_x")
    assert_close(tgy, jgy, TOL[dt]["grid"], 0, "grid_y")


@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_grad_u_matches_jax_and_finite_difference(dt):
    gx, gy = _grids()
    pts = np.asarray([[0.33, 0.41], [0.72, 1.37], [0.5, 1.0]])
    with jax.enable_x64(dt == "f64"):
        jm, jp, tm, tp = _pair(gx, gy, dt)
        jg = np.asarray(jm.grad_u(jp, jnp.asarray(pts, DTYPES[dt][0])))
    tpts = torch.tensor(pts, dtype=DTYPES[dt][1])
    g = tm.grad_u(tp, tpts).detach().numpy()
    assert_close(g, jg, TOL[dt]["val"], 0, "grad_u")
    eps = 1e-3
    for k, d in enumerate(np.eye(2)):
        step = torch.tensor(eps * d, dtype=DTYPES[dt][1])
        fd = (tm.apply(tp, tpts[:2] + step) - tm.apply(tp, tpts[:2] - step)
              ).numpy() / (2 * eps)
        np.testing.assert_allclose(g[:2, k], fd, rtol=2e-2)


@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_value_and_all_gradient_groups_match_jax(dt):
    """The L2 loss of the r-adaptive model with u_fixed: value and the
    gradients in u, increments_x and increments_y."""
    rng = np.random.default_rng(7)
    gx, gy = _grids()
    pts = np.stack([rng.uniform(0, 1, 200), rng.uniform(0, 2, 200)], axis=1)
    tgt = np.sin(2 * np.pi * pts[:, 0]) * np.cos(np.pi * pts[:, 1])
    with jax.enable_x64(dt == "f64"):
        jm, jp, tm, tp = _pair(gx, gy, dt, r_adapt=True, u_fixed=0.25)
        set_both(jp, tp, dt,
             increments_x=np.diff(gx) * np.exp(0.3 * rng.normal(size=8)),
             increments_y=np.diff(gy) * np.exp(0.3 * rng.normal(size=6)))
        jx = jnp.asarray(pts, DTYPES[dt][0])
        jv, jg = jax.value_and_grad(lambda p: ht.l2_loss(
            jm, p, jx, jnp.asarray(tgt, DTYPES[dt][0])))(jp)
    tx = torch.tensor(pts, dtype=DTYPES[dt][1])
    tt = torch.tensor(tgt, dtype=DTYPES[dt][1])
    tv, tg = value_and_grads(lambda p: pt.l2_loss(tm, p, tx, tt), tp)
    tol = TOL[dt]
    assert_close(float(tv), float(jv), tol["val"], 0, "loss")
    for k in jg:
        ref = np.asarray(jg[k])
        assert_close(tg[k].numpy(), ref, tol["grad"],
                     tol["atol"] * np.abs(ref).max(), k)
    assert float(tg["increments_y"].norm()) > 0


def test_l2_training_reduces_loss_as_jax():
    """300 Adam steps (lr 5e-3) on the r-adaptive 12x12 model: the loss
    falls below a tenth of its start, and the history follows JAX's."""
    gx = gy = np.linspace(0, 1, 12)
    jm, jp, tm, tp = _pair(gx, gy, r_adapt=True)
    g = np.linspace(0, 1, 40)
    XX, YY = np.meshgrid(g, g, indexing="ij")
    x = np.stack([XX.ravel(), YY.ravel()], axis=1)
    target = np.sin(2 * np.pi * x[:, 0]) * np.cos(2 * np.pi * x[:, 1])
    jx, jt = jnp.asarray(x, jnp.float32), jnp.asarray(target, jnp.float32)
    _, jl = ht.minimize(lambda p: ht.l2_loss(jm, p, jx, jt), jp,
                        method="adam", num_steps=300, learning_rate=5e-3)
    tx = torch.tensor(x, dtype=torch.float32)
    tt = torch.tensor(target, dtype=torch.float32)
    _, tl = pt.minimize(lambda p: pt.l2_loss(tm, p, tx, tt), tp,
                        method="adam", num_steps=300, learning_rate=5e-3)
    tl = tl.numpy()
    assert tl[-1] < 0.1 * tl[0]
    assert_close(tl, np.asarray(jl), 1e-4, 0, "history")


def _jax_example2(cfg, params, batches):
    """The JAX package's example-2 step (``examples/example2.py``) over
    the given minibatch index table."""
    model, _ = ht.Bilinear2D.create(np.linspace(0, 1, cfg.nx),
                                    np.linspace(0, 1, cfg.ny),
                                    r_adapt=cfg.r_adapt)
    g = jnp.linspace(0, 1, cfg.n_train_1d)
    XX, YY = jnp.meshgrid(g, g, indexing="ij")
    x_train = jnp.stack([XX.ravel(), YY.ravel()], axis=1)
    u_true = jnp.sin(2 * jnp.pi * x_train[:, 0]) \
        * jnp.cos(2 * jnp.pi * x_train[:, 1])
    opt = ht.adam(cfg.learning_rate)

    def step(carry, idx):
        p, s = carry
        loss, grads = jax.value_and_grad(lambda q: jnp.mean(
            (model.apply(q, x_train[idx]) - u_true[idx]) ** 2))(p)
        updates, s = opt.update(grads, s, p)
        return (optax.apply_updates(p, updates), s), loss

    (params, _), losses = jax.lax.scan(step, (params, opt.init(params)),
                                       jnp.asarray(batches))
    return np.asarray(losses)


def test_example2_on_an_index_table_matches_jax(tmp_path):
    """Example 2's loop at a small size (8x8 grid, 20x20 points, batches
    of 64, 50 epochs) on one numpy index table in both packages, from the
    same numpy init: the minibatch histories at rtol 1e-4."""
    from examples.example2_torch import main

    cfg = Projection2DConfig(nx=8, ny=8, n_train_1d=20, batch_size=64,
                             epochs=50)
    rng = np.random.default_rng(0)
    batches = rng.integers(0, 400, (cfg.epochs, cfg.batch_size))
    u0 = rng.standard_normal((8, 8))
    inc = np.full(7, 1 / 7)
    jl = _jax_example2(cfg, {"u": jnp.asarray(u0, jnp.float32),
                             "increments_x": jnp.asarray(inc, jnp.float32),
                             "increments_y": jnp.asarray(inc, jnp.float32)},
                       batches)
    tp = {k: torch.tensor(v, dtype=torch.float32)
          for k, v in (("u", u0), ("increments_x", inc),
                       ("increments_y", inc))}
    _, _, tl, mse = main(cfg, outdir=str(tmp_path), device=CPU, params=tp,
                         batches=batches)
    assert_close(tl, jl, 1e-4, 0, "example-2 history")
    assert np.isfinite(mse) and mse < tl[0]


def test_create_draws_u_from_the_generator():
    gx, gy = _grids()
    _, p0 = pt.Bilinear2D.create(gx, gy, device=CPU)
    _, p1 = pt.Bilinear2D.create(
        gx, gy, generator=torch.Generator().manual_seed(0), device=CPU)
    _, p2 = pt.Bilinear2D.create(
        gx, gy, generator=torch.Generator().manual_seed(1), device=CPU)
    assert torch.equal(p0["u"], p1["u"]) and not torch.equal(p0["u"],
                                                             p2["u"])
    assert p0["u"].shape == (9, 7) and "increments_x" not in p0


def test_reference_wrapper_surfaces():
    """The wrappers' reference surface, as JAX's (shapes, and the same
    values where the inputs are the same)."""
    w1 = PiecewiseLinearShapeNN(np.linspace(0, 1, 10), r_adapt=True,
                                device=CPU)
    j1 = JNN1(np.linspace(0, 1, 10), r_adapt=True)
    assert w1.grid.shape == (10,)
    assert_close(w1.grid.detach().numpy(), np.asarray(j1.grid), 1e-6, 0)
    assert w1(torch.tensor([0.5])).shape == (1,)
    assert w1.u_full.shape == (10,)

    w2 = PiecewiseLinearShapeNN2DStructured(np.linspace(0, 1, 5),
                                            np.linspace(0, 1, 6),
                                            r_adapt=True, device=CPU)
    j2 = JNN2S(np.linspace(0, 1, 5), np.linspace(0, 1, 6), r_adapt=True)
    assert w2(torch.tensor([[0.5, 0.5]])).shape == (1,)
    for a, b in zip(w2.grid, j2.grid):
        assert_close(a.numpy(), np.asarray(b), 1e-6, 0)
    assert w2.u_full.shape == (5, 6)

    m = ht.proxy_plate_mesh(nx=5, ny=3)
    arrays = dict(boundary_mask=np.asarray(m.geom_boundary_mask),
                  dirichlet_mask=np.asarray(m.dirichlet_mask), u_fixed=0.0,
                  neumann_edges=np.asarray(m.neumann_edges))
    w3 = PiecewiseLinearShapeNN2D(np.asarray(m.coords),
                                  np.asarray(m.connectivity), device=CPU,
                                  **arrays)
    j3 = JNN2(np.asarray(m.coords), np.asarray(m.connectivity), **arrays)
    assert (w3.Nnodes, w3.Nelems, w3.N_edges) == (j3.Nnodes, j3.Nelems,
                                                   j3.N_edges)
    x_ref = torch.full((3, 2), 1.0 / 3.0)
    u_h, det, grad_u = w3(x_ref, torch.arange(3))
    assert u_h.shape == (3, 2) and grad_u.shape == (3, 2, 2)
    _, jdet, _ = j3(jnp.full((3, 2), 1.0 / 3.0), jnp.arange(3))
    assert_close(det.numpy(), np.asarray(jdet), 1e-6, 0, "detJ")
    u_e, ds = w3(torch.tensor([0.5]), torch.arange(1), edge=True)
    _, jds = j3(jnp.asarray([0.5]), jnp.arange(1), edge=True)
    assert u_e.shape == (1, 2)
    assert_close(ds.numpy(), np.asarray(jds), 1e-6, 0, "ds")
    assert len(w3.domain_elements) == m.n_elements
    assert w3.domain_elements[0].shape == (3, 2)
    assert len(w3.nm_edges) == m.n_neumann_edges
    a, b = w3.nm_edges[0]
    ja, jb = j3.nm_edges[0]
    np.testing.assert_array_equal(torch.stack([a, b]).numpy(),
                                  np.stack([ja, jb]))
    # quirk E4 fixed: models without u_fixed/neumann_edges work
    w4 = PiecewiseLinearShapeNN2D(np.asarray(m.coords),
                                  np.asarray(m.connectivity), device=CPU)
    assert w4.u_full.shape == (m.n_nodes, 2)
