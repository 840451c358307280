"""The port's solve strategies and L-BFGS variants against the JAX
package's (the mirror of ``tests/test_solve_strategies.py``), from the
same numpy arrays.

* ``alternating_solve`` and ``two_phase_solve`` on the 13x7 proxy plate of
  the JAX fixture: losses within rtol 1e-4 of JAX's in f32 and 1e-9 in
  f64 (the two-phase L-BFGS part is the fixed step, whose first step
  jumps to ~1e10 and amplifies f32 rounding, so it is held to JAX f32 at
  init and at its plateau, and step by step in f64).
* ``minimize`` with ``loss_args`` equals the closure; a zero learning
  rate on a group freezes it (port only, as in the JAX tests).
* ``lbfgs(mode="scan")`` (the two-loop recursion) against optax's
  ``scale_by_lbfgs`` trajectory on the Rosenbrock + quadratic loss of
  ``test_compact_lbfgs_matches_two_loop``, m in (2, 5, 16) with
  wraparound: rtol 2e-3 / atol 1e-5 in f32 (the JAX test's bound),
  rtol 1e-9 in f64; the port's compact mode against its two-loop mode at
  the JAX test's bound.
* The zoom line search against optax's ``lbfgs`` with
  ``scale_by_zoom_linesearch``, step by step in f64: the accepted step
  size, the number of trial points and the loss at rtol 1e-9, on the
  Rosenbrock loss (a stiff variant whose searches grow the step and zoom,
  and one with ``max_linesearch_steps=1`` whose searches run out) and on a
  small plate; the port's ``run_lbfgs(linesearch="zoom")`` on the plate
  against that optax loop, which is the JAX package's ``run_lbfgs``
  (its value-and-grad reuse included).
* The manufactured-solution order of ``tests/test_convergence.py``
  (P1 converges at O(h^2); the errors within 1e-3 of JAX's).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import hidenn_fem_tpu as ht
import hidenn_fem_tpu_torch as pt
from hidenn_fem_tpu.solve.optimizers import \
    scale_by_compact_lbfgs as jcompact
from hidenn_fem_tpu_torch.solve import optimizers as topt
from hidenn_fem_tpu_torch.solve.drivers import (_linesearch_steps,
                                                _value_and_grad)

from torch_port_common import CPU, port_mesh

DTYPES = {"f32": (jnp.float32, torch.float32),
          "f64": (jnp.float64, torch.float64)}


def _problem(dt, nx=13, ny=7):
    """(JAX mesh, energy, params; port mesh, energy, params) of the proxy
    plate with JAX's PRNGKey(0) init, carried across as numpy."""
    jdt, tdt = DTYPES[dt]
    jm = ht.proxy_plate_mesh(nx=nx, ny=ny)
    u0 = np.asarray(ht.TriangleP1().init(jax.random.PRNGKey(0), jm)["u"])
    coords = np.asarray(jm.coords, np.float64)
    if dt == "f64":
        jm = dataclasses.replace(
            ht.TriMesh.from_arrays(*[np.asarray(a) for a in jm.astuple()],
                                   dtype=jdt),
            lattice=None)
    tm = port_mesh(jm, dtype=tdt)
    je = ht.PlaneStressEnergy(model=ht.TriangleP1(dtype=jdt))
    te = pt.PlaneStressEnergy(model=pt.TriangleP1(dtype=tdt))
    jp = {"coords": jnp.asarray(coords, jdt), "u": jnp.asarray(u0, jdt)}
    tp = pt.params_from_numpy({"coords": coords, "u": u0}, device=CPU,
                              dtype=tdt)
    return jm, je, jp, tm, te, tp


def _close(got, want, rtol, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               err_msg=what)


@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_alternating_solve_matches_jax(dt):
    kw = dict(outer_epochs=3, u_steps=3, coord_steps=2, u_lr=1e-7,
              coord_lr=1e-8)
    with jax.enable_x64(dt == "f64"):
        jm, je, jp, tm, te, tp = _problem(dt)
        jpf, jl = ht.alternating_solve(lambda p: je(p, jm), jp, **kw)
        jl, jpf = np.asarray(jl), jax.tree.map(np.asarray, jpf)
    tpf, tl = pt.alternating_solve(lambda p: te(p, tm), tp, **kw)
    assert tl.shape == (3,) and np.all(np.isfinite(tl.numpy()))
    rtol = 1e-4 if dt == "f32" else 1e-9
    _close(tl.numpy(), jl, rtol, "losses")
    for k in ("coords", "u"):
        scale = np.abs(jpf[k]).max()
        np.testing.assert_allclose(tpf[k].numpy(), jpf[k], rtol=0,
                                   atol=rtol * scale, err_msg=k)


@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_two_phase_solve_matches_jax(dt):
    with jax.enable_x64(dt == "f64"):
        jm, je, jp, tm, te, tp = _problem(dt)
        _, jl = ht.two_phase_solve(lambda p: je(p, jm), jp, adam_steps=20,
                                   lbfgs_steps=100)
        jl = np.asarray(jl)
    _, tl = pt.two_phase_solve(lambda p: te(p, tm), tp, adam_steps=20,
                               lbfgs_steps=100)
    tl = tl.numpy()
    assert tl.shape == (120,) and tl[-1] < tl[0] and tl[-1] < 0
    if dt == "f64":
        _close(tl, jl, 1e-9, "losses")
    else:
        _close(tl[:21], jl[:21], 1e-4, "Adam phase and L-BFGS start")
        _close(tl[-1], jl[-1], 1e-4, "L-BFGS plateau")


@pytest.fixture(scope="module")
def plate():
    mesh = ht.proxy_plate_mesh(nx=13, ny=7)
    params = ht.TriangleP1().init(jax.random.PRNGKey(0), mesh)
    tm = port_mesh(mesh)
    tp = pt.params_from_numpy({k: np.asarray(v) for k, v in params.items()},
                              device=CPU)
    return tm, pt.PlaneStressEnergy(model=pt.TriangleP1()), tp


def test_loss_args_matches_closure(plate):
    mesh, energy, params = plate
    p1, l1 = pt.minimize(lambda p: energy(p, mesh), params, method="adam",
                         num_steps=30, learning_rate=1e-6)
    p2, l2 = pt.minimize(energy.total, params, method="adam",
                         num_steps=30, learning_rate=1e-6,
                         loss_args=(mesh,))
    np.testing.assert_allclose(l1.numpy(), l2.numpy(), rtol=1e-6)


def test_group_lrs_freeze_semantics(plate):
    mesh, energy, params = plate
    p2, _ = pt.minimize(energy.total, params, method="adam", num_steps=20,
                        group_lrs={"u": 1e-6, "coords": 0.0},
                        loss_args=(mesh,))
    assert torch.equal(p2["coords"], params["coords"])
    assert not torch.equal(p2["u"], params["u"])


# ------------------------------------------------------ the two-loop mode
def _rosen(lib, K=1.0):
    def loss(p):
        x = p["x"]
        return lib.sum(100 * (x[1:] - x[:-1] ** 2) ** 2
                       + (1 - x[:-1]) ** 2) + K * lib.sum(p["y"] ** 2)
    return loss


def _rosen_start():
    return np.linspace(-1.0, 2.0, 13), np.ones((3, 2))


def _port_trajectory(opt, dtype, steps, K=1.0):
    x0, y0 = _rosen_start()
    like = {"x": torch.tensor(x0, dtype=dtype),
            "y": torch.tensor(y0, dtype=dtype)}
    vg = _value_and_grad(_rosen(torch, K), like, ())
    x = topt.ravel_params(like)
    state = opt.init(x, like=like)
    for _ in range(steps):
        _, g = vg(x)
        step, state = opt.update(g, state, x)
        x = x + step
    return {k: v.numpy() for k, v in topt.unravel_params(x, like).items()}


@pytest.mark.parametrize("dt", ["f32", "f64"])
@pytest.mark.parametrize("m", [2, 5, 16])
def test_two_loop_matches_optax(m, dt):
    jdt, tdt = DTYPES[dt]
    steps = 3 * m + 5                    # exercise the wraparound
    x0, y0 = _rosen_start()
    with jax.enable_x64(dt == "f64"):
        p = {"x": jnp.asarray(x0, jdt), "y": jnp.asarray(y0, jdt)}
        opt = optax.chain(optax.scale_by_lbfgs(memory_size=m),
                          optax.scale_by_learning_rate(1e-3))

        @jax.jit
        def step(p, s):
            u, s = opt.update(jax.grad(_rosen(jnp))(p), s, p)
            return optax.apply_updates(p, u), s

        s = opt.init(p)
        for _ in range(steps):
            p, s = step(p, s)
        p = jax.tree.map(np.asarray, p)
    got = _port_trajectory(topt.lbfgs(memory_size=m, mode="scan",
                                      learning_rate=1e-3), tdt, steps)
    for k in p:
        if dt == "f32":
            np.testing.assert_allclose(got[k], p[k], rtol=2e-3, atol=1e-5)
        else:
            np.testing.assert_allclose(got[k], p[k], rtol=1e-9, atol=0)
    if dt == "f32":
        compact = _port_trajectory(topt.lbfgs(memory_size=m,
                                              learning_rate=1e-3),
                                   tdt, steps)
        for k in p:
            np.testing.assert_allclose(compact[k], got[k], rtol=2e-3,
                                       atol=1e-5)


def test_compact_mode_is_unchanged():
    """``lbfgs()`` (compact, no line search) is still the compact
    direction times -1: the JAX package's compact L-BFGS at one update."""
    x0, y0 = _rosen_start()
    p = {"x": jnp.asarray(x0, jnp.float32), "y": jnp.asarray(y0,
                                                             jnp.float32)}
    jopt = optax.chain(jcompact(memory_size=4),
                       optax.scale_by_learning_rate(1.0))
    s = jopt.init(p)
    u, _ = jopt.update(jax.grad(_rosen(jnp))(p), s, p)
    got = _port_trajectory(topt.lbfgs(memory_size=4), torch.float32, 1)
    for k in p:
        np.testing.assert_allclose(got[k], np.asarray(p[k] + u[k]),
                                   rtol=1e-6, atol=1e-7)
    assert isinstance(topt.lbfgs(), topt.CompactLBFGS)
    assert isinstance(topt.lbfgs(mode="scan"), topt.TwoLoopLBFGS)
    assert isinstance(topt.lbfgs(linesearch="zoom"), topt.ZoomLBFGS)
    with pytest.raises(ValueError, match="mode"):
        topt.lbfgs(mode="bogus")
    with pytest.raises(ValueError, match="linesearch"):
        topt.lbfgs(linesearch="bogus")


# ------------------------------------------------------- zoom line search
def _optax_zoom(loss, p, m, mls, steps):
    """optax's zoom L-BFGS (the JAX package's ``lbfgs(linesearch="zoom")``)
    step by step: (loss, accepted step size, trial points, decrease and
    curvature errors) of each step."""
    opt = ht.lbfgs(memory_size=m, linesearch="zoom",
                   max_linesearch_steps=mls)
    vg = optax.value_and_grad_from_state(loss)

    @jax.jit
    def step(p, s):
        v, g = vg(p, state=s)
        u, s = opt.update(g, s, p, value=v, grad=g, value_fn=loss)
        return optax.apply_updates(p, u), s, v

    s = opt.init(p)
    out = []
    for _ in range(steps):
        p, s, v = step(p, s)
        info = s[-1].info
        out.append((float(v), float(s[-1].learning_rate),
                    int(info.num_linesearch_steps),
                    float(info.decrease_error), float(info.curvature_error)))
    return np.asarray(out)


def _port_zoom(loss, like, m, mls, steps):
    opt = topt.lbfgs(memory_size=m, linesearch="zoom",
                     max_linesearch_steps=mls)
    vg = _value_and_grad(loss, like, ())
    x = topt.ravel_params(like)
    state = opt.init(x, like=like)
    out = []
    for _ in range(steps):
        x, state, losses = _linesearch_steps(vg, opt, x, state, 1)
        ls = state.linesearch
        out.append((float(losses[0]), ls.learning_rate,
                    ls.info.num_linesearch_steps, ls.info.decrease_error,
                    ls.info.curvature_error))
    return np.asarray(out)


def _check_zoom(got, want):
    np.testing.assert_array_equal(got[:, 2], want[:, 2])   # trial points
    _close(got[:, 0], want[:, 0], 1e-9, "losses")
    _close(got[:, 1], want[:, 1], 1e-9, "step sizes")
    for col, what in ((3, "decrease"), (4, "curvature")):
        # a search that ran out leaves its last trial's errors; both zero
        # or both positive, and close
        assert np.array_equal(got[:, col] > 0, want[:, col] > 0), what
        np.testing.assert_allclose(got[:, col], want[:, col], rtol=1e-6,
                                   atol=1e-9 * np.abs(want[:, col]).max(),
                                   err_msg=what)


@pytest.mark.parametrize("K,m,mls,steps", [
    (1e4, 5, 20, 20),      # searches that grow the step and that zoom
    (1.0, 16, 1, 30),      # searches that run out of steps
])
def test_zoom_matches_optax_rosenbrock_f64(K, m, mls, steps):
    x0, y0 = _rosen_start()
    with jax.enable_x64(True):
        want = _optax_zoom(_rosen(jnp, K), {"x": jnp.asarray(x0),
                                            "y": jnp.asarray(y0)},
                           m, mls, steps)
    got = _port_zoom(_rosen(torch, K), {"x": torch.tensor(x0),
                                        "y": torch.tensor(y0)},
                     m, mls, steps)
    _check_zoom(got, want)
    if mls == 1:
        assert (want[:, 3] + want[:, 4] > 0).any()     # some ran out
    else:
        assert want[:, 2].max() > 1 and (want[:, 1] != 1.0).any()


def test_zoom_matches_optax_on_a_plate_f64():
    with jax.enable_x64(True):
        jm, je, jp, tm, te, tp = _problem("f64", nx=9, ny=5)
        want = _optax_zoom(lambda p: je(p, jm), jp, 10, 20, 20)
    got = _port_zoom(lambda p: te(p, tm), tp, 10, 20, 20)
    _check_zoom(got, want)
    assert want[:, 2].max() > 1            # the search did more than one
    # the driver: the JAX package's run_lbfgs is this optax loop
    _, tl = pt.run_lbfgs(te.total, tp, num_steps=20, memory_size=10,
                         linesearch="zoom", loss_args=(tm,))
    _close(tl.numpy(), want[:, 0], 1e-9, "run_lbfgs losses")


def test_zoom_tol_pads_history(plate):
    mesh, energy, params = plate
    _, losses = pt.run_lbfgs(energy.total, params, num_steps=200,
                             memory_size=10, tol=1e3, linesearch="zoom",
                             loss_args=(mesh,))
    tail = losses[-20:].numpy()
    assert losses.shape == (200,) and np.all(tail == tail[-1])
    with pytest.raises(ValueError, match="value_fn"):
        opt = topt.lbfgs(linesearch="zoom")
        x = topt.ravel_params(params)
        opt.update(x, opt.init(x), x)


# ------------------------------------------- manufactured-solution order
# tests/test_convergence.py's problem: the unit square clamped on all four
# faces, u_exact = (A sin(pi x) sin(pi y), 0), the balancing body force
MMS_E, MMS_NU, MMS_A = 10.0, 0.3, 1e-2


def _mms_error(n, lib, pkg, key):
    """The area-weighted centroid L2 error of the 500-step L-BFGS solve
    on the n x n mesh, by the package ``pkg`` (array library ``lib``)."""
    c11 = MMS_E / (1 - MMS_NU ** 2)
    c12, c33 = MMS_NU * c11, 0.5 * (1 - MMS_NU) * c11
    pi = np.pi

    def body_force(x):
        s = lib.sin(pi * x[:, 0]) * lib.sin(pi * x[:, 1])
        c = lib.cos(pi * x[:, 0]) * lib.cos(pi * x[:, 1])
        return lib.stack([MMS_A * pi ** 2 * (c11 + c33) * s,
                          -MMS_A * pi ** 2 * (c33 + c12) * c], 1)

    kw = dict(length=1.0, height=1.0, holes=(), nx=n, ny=n,
              boundaries={"left": 1, "right": 1, "up": 1, "down": 1})
    mesh = (pkg.generate_mesh(**kw) if pkg is ht
            else pkg.generate_mesh(**kw, device=CPU))
    model = pkg.TriangleP1()
    params = (model.init(key, mesh) if pkg is ht
              else model.init(key, mesh, device=CPU))
    energy = pkg.PlaneStressEnergy(model=model, E=MMS_E, nu=MMS_NU,
                                   body_force=body_force)
    coords0 = params["coords"]
    pf, _ = pkg.run_lbfgs(
        lambda p: energy({"u": p["u"], "coords": coords0}, mesh),
        {"u": params["u"]}, num_steps=500)
    params = {"u": pf["u"], "coords": coords0}
    conn = mesh.connectivity
    cent = model.coords(params, mesh)[conn].mean(1)
    uh = model.u_full(params, mesh)[conn].mean(1)
    ex = lib.stack([MMS_A * lib.sin(pi * cent[:, 0])
                    * lib.sin(pi * cent[:, 1]),
                    0.0 * cent[:, 0]], 1)
    det, _ = model.element_fields(params, mesh)
    err2 = lib.sum(0.5 * lib.abs(det) * lib.sum((uh - ex) ** 2, 1))
    return float(lib.sqrt(err2))


def test_p1_l2_convergence_is_second_order():
    """The mirror of ``tests/test_convergence.py::
    test_p1_l2_convergence_is_second_order`` on the port: halving h
    shrinks the L2 error more than 3x (P1 is O(h^2)), the fine error is
    below 2e-2 A, and both errors lie within 1e-3 of the JAX package's
    (the solves start from different random u0 and converge: measured
    6e-8 and 1e-5 apart)."""
    gen = torch.Generator().manual_seed(0)
    e_coarse = _mms_error(9, torch, pt, gen)
    e_fine = _mms_error(17, torch, pt, gen)
    assert e_coarse / e_fine > 3.0, (e_coarse, e_fine)
    assert e_fine < 2e-2 * MMS_A, e_fine
    key = jax.random.PRNGKey(0)
    for n, got in ((9, e_coarse), (17, e_fine)):
        assert np.isclose(got, _mms_error(n, jnp, ht, key), rtol=1e-3), n
