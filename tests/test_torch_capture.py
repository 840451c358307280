"""The drivers' restructured step (``solve/drivers.py``: a static leaf,
the optimizers' device counts and in-place state, Adam's bias-correction
table), run eagerly on the CPU, against the JAX package's drivers on the
same numpy inputs; and the ``ops``/``models`` package exports.

The plate is the 13x7 proxy plate on the gather route, scaled so that
the fixed-step L-BFGS takes no jump (E = 1, F_total = 1e-2: a step of
the solve moves the energy by at most a few times its size): then f32
L-BFGS histories agree with JAX's step by step at the f32 rtol of
``tests/test_torch_strategies.py`` (1e-4; measured 1.5e-6), not only at
init and at the plateau.  f64 at rtol 1e-9 under ``jax.enable_x64``.

``tol`` is set between two measured gradient infinity norms of the run
(the L-BFGS norms fall from 3.15e-4 at step 22 to 2.38e-4 at step 23,
Adam's from 1.57e-3 at step 24 to 1.30e-3 at step 25), so both packages
stop at the same step, and the padded history is compared element for
element with JAX's (the JAX package's ``tol`` scan for the optimizers
its ``run_optimizer`` runs without one; under x64 that scan raises, so
the f64 reference is JAX's run without ``tol`` cut at the step where
JAX's own gradient falls below ``tol``, and padded, ``_jax_tol_f64``).

The capture itself exists only on the card (``tests/test_torch_cuda.py``
holds a captured run to an eager one bit for bit there)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hidenn_fem_tpu as ht
import hidenn_fem_tpu_torch as pt
from hidenn_fem_tpu.solve import drivers as jdrivers
from hidenn_fem_tpu.solve import optimizers as jopt
from hidenn_fem_tpu_torch.solve import drivers as tdrivers
from hidenn_fem_tpu_torch.solve import optimizers as topt

from torch_port_common import CPU

STEPS = 40
TOL = {"compact": 2.8e-4, "scan": 2.8e-4, "adam_per_group": 1.4e-3,
       "freeze_groups": 1.4e-3}
STOP = {"compact": 24, "scan": 24, "adam_per_group": 26,
        "freeze_groups": 26}         # steps taken before the stop
KW = dict(E=1.0, nu=0.3, F_total=1e-2)
DTYPES = {"f32": (jnp.float32, torch.float32),
          "f64": (jnp.float64, torch.float64)}


def _optimizers(pkg):
    return {
        "compact": pkg.lbfgs(memory_size=5),
        "scan": pkg.lbfgs(memory_size=5, mode="scan"),
        "adam_per_group": pkg.adam_per_group({"u": 1e-3, "coords": 1e-4}),
        "freeze_groups": pkg.freeze_groups(pkg.adam(1e-3), ["coords"]),
    }


def _problem(dt):
    """(JAX loss, params; port loss, params) of the scaled plate, from
    one numpy init; under x64 for f64."""
    jdt, tdt = DTYPES[dt]
    jm = dataclasses.replace(ht.proxy_plate_mesh(nx=13, ny=7), lattice=None)
    u0 = 1e-5 * np.random.default_rng(0).standard_normal((jm.n_nodes, 2))
    coords = np.asarray(jm.coords, np.float64)
    tm = pt.mesh_from_numpy(jm, device=CPU, dtype=tdt, build_lattice=False)
    if dt == "f64":
        jm = dataclasses.replace(
            ht.TriMesh.from_arrays(*[np.asarray(a) for a in jm.astuple()],
                                   dtype=jdt, build_lattice=False),
            lattice=None)
    je = ht.PlaneStressEnergy(model=ht.TriangleP1(dtype=jdt), **KW)
    te = pt.PlaneStressEnergy(model=pt.TriangleP1(dtype=tdt), **KW)
    jp = {"coords": jnp.asarray(coords, jdt), "u": jnp.asarray(u0, jdt)}
    tp = pt.params_from_numpy({"coords": coords, "u": u0}, device=CPU,
                              dtype=tdt)
    return (lambda p: je(p, jm)), jp, (lambda p: te(p, tm)), tp


def _jax_run(name, loss, params, tol, steps=STEPS):
    opt = _optimizers(jopt)[name]
    if tol is None:
        if name == "compact":
            return ht.run_lbfgs(loss, params, num_steps=steps,
                                memory_size=5)
        return ht.run_optimizer(loss, params, opt, steps)
    if name == "compact":
        return ht.run_lbfgs(loss, params, num_steps=steps, memory_size=5,
                            tol=tol)
    return jdrivers._run_first_order_tol(loss, opt, steps, float(tol),
                                         params, ())


def _jax_tol_f64(name, loss, params, tol):
    """What the JAX ``tol`` scan computes, where under x64 it cannot run
    (its masked branch carries the loss as float32, so ``lax.cond`` sees
    two dtypes): the first ``STOP`` steps without ``tol``, padded with
    the last loss, once the gradient's infinity norm at the params of
    step ``STOP - 1`` is below ``tol`` and at those of step ``STOP - 2``
    is not."""
    n = STOP[name]
    gmax = []
    for k in (n - 2, n - 1):
        pk, _ = _jax_run(name, loss, params, None, steps=k)
        g = jax.grad(loss)(pk)
        gmax.append(max(float(jnp.abs(v).max()) for v in g.values()))
    assert gmax[0] >= tol > gmax[1], gmax
    pf, hist = _jax_run(name, loss, params, None, steps=n)
    hist = np.concatenate([np.asarray(hist),
                           np.full(STEPS - n, np.asarray(hist)[-1])])
    return pf, hist


def _port_run(name, loss, params, tol):
    if name == "compact":
        return pt.run_lbfgs(loss, params, num_steps=STEPS, memory_size=5,
                            tol=tol)
    return pt.run_optimizer(loss, params, _optimizers(topt)[name], STEPS,
                            tol=tol)


@pytest.mark.parametrize("with_tol", [False, True], ids=["no_tol", "tol"])
@pytest.mark.parametrize("dt", ["f32", "f64"])
@pytest.mark.parametrize("name", list(TOL))
def test_driver_matches_jax(name, dt, with_tol):
    """History and final params against the JAX driver's; with ``tol``
    both stop at the same step and pad with the last loss."""
    tol = TOL[name] if with_tol else None
    rtol = 1e-4 if dt == "f32" else 1e-9
    with jax.enable_x64(dt == "f64"):
        jloss, jp, tloss, tp = _problem(dt)
        if with_tol and dt == "f64":
            jpf, jl = _jax_tol_f64(name, jloss, jp, tol)
        else:
            jpf, jl = _jax_run(name, jloss, jp, tol)
        jl, jpf = np.asarray(jl), jax.tree.map(np.asarray, jpf)
    tpf, tl = _port_run(name, tloss, tp, tol)
    tl = tl.numpy()
    assert tl.shape == (STEPS,) and tl.dtype == jl.dtype
    np.testing.assert_allclose(tl, jl, rtol=rtol, err_msg="losses")
    for k in ("coords", "u"):
        np.testing.assert_allclose(tpf[k].numpy(), jpf[k], rtol=0,
                                   atol=rtol * np.abs(jpf[k]).max(),
                                   err_msg=k)
    if with_tol:
        n = STOP[name]
        for h in (tl, jl):          # the padding: the last loss, exactly
            assert np.all(h[n:] == h[n - 1]) and h[n - 1] != h[n - 2]


@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_alternating_solve_matches_jax(dt):
    """Two steppers on one static leaf (the u-step and the coordinate
    step), four epochs of 4 + 3 Adam steps: the per-epoch losses and the
    final params against JAX's."""
    kw = dict(outer_epochs=4, u_steps=4, coord_steps=3, u_lr=1e-3,
              coord_lr=1e-4)
    rtol = 1e-4 if dt == "f32" else 1e-9
    with jax.enable_x64(dt == "f64"):
        jloss, jp, tloss, tp = _problem(dt)
        jpf, jl = ht.alternating_solve(jloss, jp, **kw)
        jl, jpf = np.asarray(jl), jax.tree.map(np.asarray, jpf)
    tpf, tl = pt.alternating_solve(tloss, tp, **kw)
    np.testing.assert_allclose(tl.numpy(), jl, rtol=rtol)
    for k in ("coords", "u"):
        np.testing.assert_allclose(tpf[k].numpy(), jpf[k], rtol=0,
                                   atol=rtol * np.abs(jpf[k]).max(),
                                   err_msg=k)


def _state_tensors(state):
    if isinstance(state, torch.Tensor):
        return [state]
    if isinstance(state, (tuple, list)):
        return [t for s in state for t in _state_tensors(s)]
    return []


@pytest.mark.parametrize("name", list(TOL))
def test_state_is_static_and_counts_agree(name):
    """Every update writes the same state tensors in place (what a
    replayed graph reads and writes), the device count follows the host
    count, and ``advance`` moves the host count alone."""
    _, _, tloss, tp = _problem("f32")
    opt = _optimizers(topt)[name]
    vg = tdrivers._value_and_grad(tloss, tp, ())
    leaf = tdrivers._leaf(tp)
    state = opt.init(leaf.detach(), like=tp)
    tensors = [id(t) for t in _state_tensors(state)]
    x0 = leaf.detach().clone()
    for i in range(7):
        _, _, state = tdrivers._step(vg, opt, leaf, state)
        assert [id(t) for t in _state_tensors(state)] == tensors
        inner = state[1] if name == "freeze_groups" else state
        assert inner.count == i + 1 and int(inner.device_count) == i + 1
    assert not torch.equal(leaf.detach(), x0)      # updated in place
    assert topt.ravel_params(tp).equal(x0)         # the input untouched
    inner = opt.advance(state, 5)
    inner = inner[1] if name == "freeze_groups" else inner
    assert inner.count == 12 and int(inner.device_count) == 7
    assert opt.capturable


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_adam_bias_table_is_the_host_formula(dtype):
    """Each entry is optax's ``1 - b**count`` in the moments' precision as
    the host computes it; the table ends where it reaches 1, and the
    formula stays 1 from there on (checked as far again), so a lookup
    clamped to the end is exact for every count."""
    f = np.float64 if dtype == torch.float64 else np.float32
    for b in (topt.Adam.b1, topt.Adam.b2):
        table = topt._bias_corrections(b, dtype, CPU).numpy()
        assert table.dtype == f and table[-1] == 1.0
        for n in range(1, 2 * table.shape[0]):
            want = f(1) - f(b) ** f(n)
            got = table[min(n, table.shape[0] - 1)]
            assert got == want, (b, n, got, want)


def test_zoom_is_not_capturable_and_gloo_is_not_captured():
    """The decisions before any step: the zoom line search and the CPU are
    never captured; a capturable optimizer on a card is."""
    assert not getattr(topt.lbfgs(linesearch="zoom"), "capturable", False)
    assert not tdrivers._capturable(topt.lbfgs(), CPU)
    assert tdrivers._capturable(topt.lbfgs(), torch.device("cuda", 0))
    assert not tdrivers._capturable(topt.lbfgs(linesearch="zoom"),
                                    torch.device("cuda", 0))


def test_ops_and_models_export_the_jax_names():
    """``from hidenn_fem_tpu_torch.ops import ...`` and ``... .models
    import ...`` give the JAX packages' names, the same objects as their
    modules'."""
    from hidenn_fem_tpu_torch.models import (Bilinear2D, Linear1D,
                                             StructuredGrid,
                                             StructuredGridP1, TriangleP1,
                                             generate_structured_grid)
    from hidenn_fem_tpu_torch.ops import (PlaneStressEnergy,
                                          TRIANGLE_RULE_DEGREE,
                                          bar_energy_1d, energy_density,
                                          interval_gauss_points,
                                          interval_gauss_points_m11,
                                          l2_loss, plane_stress_C,
                                          strain_voigt_from_grad,
                                          stress_from_strain,
                                          triangle_gauss_points,
                                          von_mises_plane_stress)
    from hidenn_fem_tpu_torch.ops import losses, quadrature

    assert PlaneStressEnergy is losses.PlaneStressEnergy is \
        pt.PlaneStressEnergy
    assert TRIANGLE_RULE_DEGREE == ht.ops.TRIANGLE_RULE_DEGREE
    assert triangle_gauss_points is quadrature.triangle_gauss_points
    assert TriangleP1 is pt.TriangleP1 and Linear1D is pt.Linear1D
    assert all(callable(f) for f in (
        bar_energy_1d, energy_density, interval_gauss_points,
        interval_gauss_points_m11, l2_loss, plane_stress_C,
        strain_voigt_from_grad, stress_from_strain,
        von_mises_plane_stress, Bilinear2D, StructuredGrid,
        StructuredGridP1, generate_structured_grid))
    import hidenn_fem_tpu_torch.ops as tops
    with pytest.raises(AttributeError):
        tops.element_energy_pallas
