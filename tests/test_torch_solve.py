"""The port's compact L-BFGS and solve drivers against the JAX package.

* One update at a time: the direction of ``scale_by_compact_lbfgs`` on the
  same (x, g) sequence, including a rejected (negative-curvature) pair and
  a wrapped history; f64, rtol 1e-10 (same algebra, other BLAS order).
* The whole slice (mesh -> TriangleP1 -> PlaneStressEnergy.total ->
  run_lbfgs 100 steps -> von Mises) on a 41x21 plate with holes, in f64
  against JAX under ``jax.enable_x64``: loss history, final params and
  stresses within rtol 1e-6 (the fixed-step solve amplifies rounding
  differences from step to step; measured on the CPU: 4e-8 relative on
  the loss history, 2e-7 x max|u| on the final u).
* The f32 81x41 ``compat="reference"`` plateau -10.392 (abs 0.02), the
  measured reference baseline that ``tests/test_baseline_parity.py``
  holds the JAX package to.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hidenn_fem_tpu as ht
import hidenn_fem_tpu_torch as pt
from hidenn_fem_tpu import postproc as jpost
from hidenn_fem_tpu.solve.optimizers import scale_by_compact_lbfgs as jlbfgs
from hidenn_fem_tpu_torch import postproc as tpost
from hidenn_fem_tpu_torch.solve import optimizers as topt

from torch_port_common import CPU, assert_close, jax_mesh, port_mesh


def _quadratic_sequence(p, steps, seed):
    """(x, g) pairs of a few gradient steps on a random convex quadratic,
    with one non-positive-curvature pair injected."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((p, p))
    A = A @ A.T / p + 0.1 * np.eye(p)
    x = rng.standard_normal(p)
    seq = []
    for i in range(steps):
        g = A @ x
        if i == 3:
            g = -g          # s.y <= 0 at the next pair: rejected
        seq.append((x.copy(), g))
        x = x - 0.3 * g + 0.05 * rng.standard_normal(p)
    return seq


@pytest.mark.parametrize("memory", [3, 8])
def test_compact_lbfgs_update_matches_jax(memory):
    seq = _quadratic_sequence(40, 12, seed=memory)
    with jax.enable_x64(True):
        jopt = jlbfgs(memory_size=memory)
        jstate = jopt.init(jnp.asarray(seq[0][0]))
        jupdate = jax.jit(jopt.update)
        jdirs = []
        for x, g in seq:
            d, jstate = jupdate(jnp.asarray(g), jstate, jnp.asarray(x))
            jdirs.append(np.asarray(d))
    topt_ = topt.scale_by_compact_lbfgs(memory_size=memory)
    tstate = topt_.init(torch.tensor(seq[0][0]))
    for (x, g), dj in zip(seq, jdirs):
        d, tstate = topt_.update(torch.tensor(g), tstate, torch.tensor(x))
        assert_close(d.numpy(), dj, rtol=1e-10,
                     atol=1e-12 * np.abs(dj).max())
    assert tstate.count == len(seq)


def test_ravel_order_matches_ravel_pytree():
    from jax.flatten_util import ravel_pytree
    params = {"u": np.arange(6.0).reshape(3, 2),
              "coords": 10 + np.arange(6.0).reshape(3, 2)}
    flat_j, _ = ravel_pytree({k: jnp.asarray(v) for k, v in params.items()})
    tp = pt.params_from_numpy(params, device=CPU, dtype=torch.float64)
    flat_t = topt.ravel_params(tp)
    np.testing.assert_array_equal(flat_t.numpy(), np.asarray(flat_j))
    back = topt.unravel_params(flat_t, tp)
    for k in params:
        np.testing.assert_array_equal(back[k].numpy(), params[k])


def test_whole_slice_f64_matches_jax():
    holes = ((0.5, 0.7, 0.12), (1.0, 0.3, 0.15), (1.4, 0.6, 0.1))
    mesh32 = jax_mesh(holes=holes, nx=41, ny=21, keep_dead_nodes=True)
    rng = np.random.default_rng(0)
    u0 = 1e-5 * rng.standard_normal((mesh32.n_nodes, 2))
    coords0 = np.asarray(mesh32.coords, dtype=np.float64)
    steps = 100

    with jax.enable_x64(True):
        mesh_j = ht.TriMesh.from_arrays(
            *[np.asarray(a) for a in mesh32.astuple()], dtype=jnp.float64,
            build_lattice=False)
        model_j = ht.TriangleP1(dtype=jnp.float64)
        energy_j = ht.PlaneStressEnergy(model=model_j)
        pj, lj = ht.run_lbfgs(energy_j.total,
                              {"coords": jnp.asarray(coords0),
                               "u": jnp.asarray(u0)},
                              num_steps=steps, loss_args=(mesh_j,))
        lj = np.asarray(lj)
        pj_np = {k: np.asarray(v) for k, v in pj.items()}
        vm_j = np.asarray(jpost.von_mises_per_element(model_j, pj, mesh_j,
                                                      10e9, 0.3))

    mesh_t = port_mesh(mesh32, dtype=torch.float64)
    model_t = pt.TriangleP1(dtype=torch.float64)
    energy_t = pt.PlaneStressEnergy(model=model_t)
    ptt, lt = pt.run_lbfgs(energy_t.total,
                           pt.params_from_numpy({"coords": coords0,
                                                 "u": u0}, device=CPU,
                                                dtype=torch.float64),
                           num_steps=steps, loss_args=(mesh_t,))
    vm_t = tpost.von_mises_per_element(model_t, ptt, mesh_t, 10e9, 0.3)

    assert lt.shape == (steps,)
    assert_close(lt.numpy(), lj, rtol=1e-6, what="loss history")
    for k in ("coords", "u"):
        assert_close(ptt[k].numpy(), pj_np[k], rtol=1e-6,
                     atol=1e-6 * np.abs(pj_np[k]).max(), what=k)
    assert_close(vm_t.numpy(), vm_j, rtol=1e-6, atol=1e-6 * vm_j.max(),
                 what="von Mises")
    assert lt[-1] < lt[0]


def test_run_lbfgs_tol_pads_history():
    mesh = pt.proxy_plate_mesh(nx=9, ny=5, device=CPU)
    model = pt.TriangleP1()
    energy = pt.PlaneStressEnergy(model=model)
    p0 = model.init(torch.Generator().manual_seed(0), mesh, device=CPU)
    _, losses = pt.run_lbfgs(energy.total, p0, num_steps=30,
                             loss_args=(mesh,), tol=1e30)
    # converged at the first step: the history repeats its value
    assert losses.shape == (30,)
    assert torch.all(losses == losses[0])


def test_reference_compat_plateau_f32():
    """The measured reference baseline: 81x41 "up" plate, 6,400
    elements, reference numerics (E3/E7/E9), 600 fixed-step L-BFGS
    iterations -> energy plateau -10.392."""
    mesh = pt.proxy_plate_mesh(device=CPU)
    model = pt.TriangleP1(compat="reference")
    rng = np.random.default_rng(0)
    params = pt.params_from_numpy(
        {"coords": mesh.coords.numpy(),
         "u": 1e-5 * rng.standard_normal((mesh.n_nodes, 2))}, device=CPU)
    energy = pt.PlaneStressEnergy(model=model, E=10e9, nu=0.3,
                                  compat="reference")
    _, losses = pt.run_lbfgs(energy.total, params, num_steps=600,
                             loss_args=(mesh,))
    plateau = float(losses[-1])
    assert plateau == pytest.approx(-10.392, abs=0.02), plateau


def test_compact_lbfgs_fixed_gamma_matches_jax():
    """``scale_init_precond=False``: gamma stays 1 on every update, as in
    the JAX package (f64, rtol 1e-10)."""
    seq = _quadratic_sequence(30, 9, seed=5)
    with jax.enable_x64(True):
        jopt = jlbfgs(memory_size=4, scale_init_precond=False)
        jstate = jopt.init(jnp.asarray(seq[0][0]))
        jdirs = []
        for x, g in seq:
            d, jstate = jax.jit(jopt.update)(jnp.asarray(g), jstate,
                                             jnp.asarray(x))
            jdirs.append(np.asarray(d))
    opt = topt.scale_by_compact_lbfgs(memory_size=4, scale_init_precond=False)
    state = opt.init(torch.tensor(seq[0][0]))
    for (x, g), dj in zip(seq, jdirs):
        d, state = opt.update(torch.tensor(g), state, torch.tensor(x))
        assert float(state.gamma) == 1.0
        assert_close(d.numpy(), dj, rtol=1e-10, atol=1e-12 * np.abs(dj).max())


def test_drivers_take_a_bare_tensor_as_jax():
    """``run_lbfgs`` and ``run_optimizer`` on a bare [N, 4] tensor (the
    node-space solves' params), against the JAX drivers on the same array:
    loss history and final params in f64 within rtol 1e-10, and the final
    params come back as a tensor of the input's shape."""
    rng = np.random.default_rng(9)
    a = rng.standard_normal((24, 24))
    A = a @ a.T / 24 + 0.5 * np.eye(24)
    b = rng.standard_normal((6, 4))
    x0 = rng.standard_normal((6, 4))
    with jax.enable_x64(True):
        Aj, bj = jnp.asarray(A), jnp.asarray(b)

        def jloss(x):
            v = x.reshape(-1)
            return 0.5 * v @ (Aj @ v) - jnp.sum(bj * x)

        xj, lj = ht.run_lbfgs(jloss, jnp.asarray(x0), num_steps=8,
                              memory_size=5)
        xj2, lj2 = ht.run_optimizer(jloss, jnp.asarray(x0),
                                    ht.lbfgs(memory_size=5), num_steps=8)
    At, bt = torch.tensor(A), torch.tensor(b)

    def tloss(x):
        v = x.reshape(-1)
        return 0.5 * v @ (At @ v) - torch.sum(bt * x)

    xt, lt = pt.run_lbfgs(tloss, torch.tensor(x0), num_steps=8,
                          memory_size=5)
    xt2, lt2 = pt.run_optimizer(tloss, torch.tensor(x0),
                                pt.lbfgs(memory_size=5), num_steps=8)
    for x, lh, xr, lr in ((xt, lt, xj, lj), (xt2, lt2, xj2, lj2)):
        assert isinstance(x, torch.Tensor) and x.shape == (6, 4)
        assert_close(lh.numpy(), np.asarray(lr), rtol=1e-10, what="history")
        assert_close(x.numpy(), np.asarray(xr), rtol=1e-10,
                     atol=1e-12, what="final x")
