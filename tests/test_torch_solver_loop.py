"""The linear solvers' one-program loop (``solve/loop.py`` running the
masked PCG body of ``solve/linear.py``) against the JAX package's
``lax.while_loop``: ``cg_solve``, ``jacobi_pcg_solve``, ``mg_pcg_solve``
and ``aux_pcg_solve``, from the same numpy inputs, in f32 and (under
``jax.enable_x64``) f64.

Each solve's ``tol`` lies between two residuals of JAX's own history
(JAX's solve at ``tol = 0`` first), with a margin of 1.2x on each side,
so that JAX stops after n iterations, n not a multiple of
``loop.READ_EVERY``: the port's loop then reads its stop flag only after
the batch that holds the stop and runs the masked calls past it, which
the card's replays run too.  The CPU runs the same body eagerly.

Tolerances:
* iteration counts equal to JAX's; the history element for element: the
  n executed residuals rtol 1e-3 in f32 (the existing files' bound on
  early residuals) and 1e-8 in f64, every entry past the stop exactly 0
  in both packages;
* solutions as in the existing files: CG and Jacobi-PCG within 1e-4 x
  max|u| in f32 and 1e-10 (CG) / 1e-7 (Jacobi-PCG) in f64
  (``tests/test_torch_linear.py``); MG-PCG 1e-4 x max|u| in f32 and 1e-8
  in f64 (``tests/test_torch_multigrid.py``); aux-PCG 2e-3 x max|u| in
  f32 and 1e-8 in f64 (``tests/test_torch_auxspace.py``).  MG-PCG and
  aux-PCG run on JAX's own hierarchy and tables (``levels_from_numpy``,
  ``aux_from_numpy``);
* ``READ_EVERY = 1`` (no call past the stop) and the shipped value give
  bit-equal solutions and histories, and the shipped value makes the
  masked calls: the body runs n rounded up to a multiple of
  ``READ_EVERY`` times, against n.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hidenn_fem_tpu as ht
import hidenn_fem_tpu_torch as pt
from hidenn_fem_tpu.models.structured_grid import (
    StructuredGridP1 as JModel, generate_structured_grid as jgrid_gen)
from hidenn_fem_tpu.solve import auxspace as jax_ax
from hidenn_fem_tpu.solve import multigrid as jmg
from hidenn_fem_tpu_torch.models.structured_grid import \
    StructuredGridP1 as TModel
from hidenn_fem_tpu_torch.solve import loop

from torch_port_common import CPU, assert_close

E, NU = 10e9, 0.3
SOLVERS = ("cg", "jacobi", "mg", "aux")
# (f32, f64) solution tolerance, x max|u|
U_TOL = {"cg": (1e-4, 1e-10), "jacobi": (1e-4, 1e-7), "mg": (1e-4, 1e-8),
         "aux": (2e-3, 1e-8)}
HIST_RTOL = (1e-3, 1e-8)
MAX_ITERS = {"cg": 60, "jacobi": 60, "mg": 30, "aux": 40}


def _u0(shape, seed=0):
    return 1e-5 * np.random.default_rng(seed).standard_normal(shape)


def _stop(jh, every):
    """(n, tol): JAX's history ``jh`` at tol 0 stops after n iterations
    (n >= 5, not a multiple of ``every``) at a tol between jh[n - 1] and
    every earlier residual, 1.2x from each."""
    for n in range(5, len(jh)):
        prev, cur = float(jh[:n - 1].min()), float(jh[n - 1])
        if n % every and cur > 0 and prev >= 1.44 * cur:
            return n, math.sqrt(prev * cur)
    raise AssertionError("no residual with a 1.44x drop below the rest")


def _plate_losses(f64):
    jdt, tdt = (jnp.float64, torch.float64) if f64 else (jnp.float32,
                                                         torch.float32)
    je = ht.PlaneStressEnergy(model=ht.TriangleP1(dtype=jdt), E=E, nu=NU)
    te = pt.PlaneStressEnergy(model=pt.TriangleP1(dtype=tdt), E=E, nu=NU)

    def jl(p, coords, m):
        return je({"u": p["u"], "coords": coords}, m)

    def tl(p, coords, m):
        return te({"u": p["u"], "coords": coords}, m)
    return jl, tl, jdt, tdt


def _krylov(solver, f64):
    """CG or Jacobi-PCG on the 41x21 proxy plate: (JAX's solve of a tol,
    the port's solve of a tol, max_iters)."""
    jl, tl, jdt, tdt = _plate_losses(f64)
    mesh = ht.proxy_plate_mesh(nx=41, ny=21)
    jm = (ht.TriMesh.from_arrays(*[np.asarray(a) for a in mesh.astuple()],
                                 dtype=jdt) if f64 else mesh)
    tm = pt.mesh_from_numpy(mesh, device=CPU, dtype=tdt)
    u0 = _u0((mesh.n_nodes, 2))
    m = MAX_ITERS[solver]
    kw = {"mesh": jm} if solver == "jacobi" else {}
    jfn = ht.jacobi_pcg_solve if solver == "jacobi" else ht.cg_solve
    tfn = pt.jacobi_pcg_solve if solver == "jacobi" else pt.cg_solve

    def jax_solve(tol):
        sol, h = jfn(jl, {"u": jnp.asarray(u0, jdt)}, (jm.coords, jm),
                     max_iters=m, tol=tol, **kw)
        return np.asarray(sol["u"]), np.asarray(h)

    def port_solve(tol):
        tkw = {"mesh": tm} if solver == "jacobi" else {}
        sol, h = tfn(tl, {"u": torch.tensor(u0, dtype=tdt)},
                     (tm.coords, tm), max_iters=m, tol=tol, **tkw)
        return sol["u"], h
    return jax_solve, port_solve


def _multigrid(f64):
    """MG-PCG on the 17x9 zigzag plate with a hole, the port on JAX's
    hierarchy."""
    jdt, tdt = (jnp.float64, torch.float64) if f64 else (jnp.float32,
                                                         torch.float32)
    jg = jgrid_gen(length=2.0, height=1.0, nx=17, ny=9, split="zigzag",
                   holes=((1.0, 0.5, 0.15),))
    jm = JModel(E=E, nu=NU, dtype=jdt)
    u0 = _u0((17, 9, 2))
    coords = np.asarray(jg.coords, dtype=np.float64)
    jp = {"coords": jnp.asarray(coords, jdt), "u": jnp.asarray(u0, jdt)}
    jlev = jmg.build_hierarchy(jm, jg, jm.coords(jp, jg))
    tg = pt.grid_from_numpy(jg, device=CPU, dtype=tdt)
    tm = TModel(E=E, nu=NU, dtype=tdt)
    tp = pt.params_from_numpy({"coords": coords, "u": u0}, device=CPU,
                              dtype=tdt)
    tlev = pt.levels_from_numpy(jlev, tg, device=CPU, dtype=tdt)
    m = MAX_ITERS["mg"]

    def jax_solve(tol):
        sol, h = jmg.mg_pcg_solve(jm, jg, jp, max_iters=m, tol=tol,
                                  levels=jlev)
        return np.asarray(sol["u"]), np.asarray(h)

    def port_solve(tol):
        sol, h = pt.mg_pcg_solve(tm, tg, tp, max_iters=m, tol=tol,
                                 levels=tlev)
        return sol["u"], h
    return jax_solve, port_solve


def _aux(f64):
    """Aux-PCG on JAX's tables: the 33x17 proxy plate on the
    lattice-aligned background (f32), the 33x17 one-hole plate on the
    "perm" background (f64)."""
    jl, tl, jdt, tdt = _plate_losses(f64)
    if f64:
        jm = ht.generate_mesh(length=2.0, height=1.0,
                              holes=((1.0, 0.5, 0.18),),
                              boundaries={"up": 0, "down": 0, "right": 2,
                                          "left": 1},
                              nx=33, ny=17, variant="up")
        jm = ht.TriMesh.from_arrays(*[np.asarray(a) for a in jm.astuple()],
                                    dtype=jdt)
    else:
        jm = ht.proxy_plate_mesh(nx=33, ny=17)
    tm = pt.mesh_from_numpy(jm, device=CPU, dtype=tdt,
                            build_lattice=jm.lattice is not None)
    u0 = _u0((jm.n_nodes, 2))
    bg = JModel(E=E, nu=NU, dtype=jdt)
    up = {"u": jnp.asarray(u0, jdt)}
    jpre = jax_ax.build_aux_preconditioner(jl, up, (jm.coords, jm), jm,
                                           bg_model=bg)
    tpre = pt.aux_from_numpy(jpre, device=CPU)
    m = MAX_ITERS["aux"]

    def jax_solve(tol):
        sol, h = jax_ax.aux_pcg_solve(jl, up, (jm.coords, jm), pre=jpre,
                                      bg_model=bg, max_iters=m, tol=tol)
        return np.asarray(sol["u"]), np.asarray(h)

    def port_solve(tol):
        sol, h = pt.aux_pcg_solve(tl, {"u": torch.tensor(u0, dtype=tdt)},
                                  (tm.coords, tm), pre=tpre,
                                  max_iters=m, tol=tol)
        return sol["u"], h
    return jax_solve, port_solve


def _port_run(port_solve, tol, every):
    """The port's solve with ``loop.READ_EVERY = every``: (solution,
    history, calls of the loop body)."""
    calls = [0]
    while_loop = loop.while_loop

    def counted(body, active, max_iters, device):
        def b():
            calls[0] += 1
            return body()
        return while_loop(b, active, max_iters, device)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(loop, "READ_EVERY", every)
        mp.setattr(loop, "while_loop", counted)
        u, h = port_solve(tol)
    return u, h, calls[0]


@functools.lru_cache(maxsize=None)
def _case(solver, f64):
    """JAX's and the port's solves of one solver and precision at the
    chosen tol (module doc)."""
    with jax.enable_x64(f64):
        jax_solve, port_solve = (_krylov(solver, f64)
                                 if solver in ("cg", "jacobi")
                                 else _multigrid(f64) if solver == "mg"
                                 else _aux(f64))
        n, tol = _stop(jax_solve(0.0)[1], loop.READ_EVERY)
        ju, jh = jax_solve(tol)
    return dict(n=n, tol=tol, ju=ju, jh=jh,
                shipped=_port_run(port_solve, tol, loop.READ_EVERY),
                one=_port_run(port_solve, tol, 1))


@pytest.mark.parametrize("f64", [False, True], ids=["f32", "f64"])
@pytest.mark.parametrize("solver", SOLVERS)
def test_loop_matches_jax_while_loop(solver, f64):
    c = _case(solver, f64)
    n, jh, ju = c["n"], c["jh"], c["ju"]
    u, h, _ = c["shipped"]
    h = h.numpy()
    m = MAX_ITERS[solver]
    assert n % loop.READ_EVERY and h.shape == jh.shape == (m,)
    assert int(np.count_nonzero(jh)) == n and jh[n - 1] <= c["tol"]
    assert int(np.count_nonzero(h)) == n, (int(np.count_nonzero(h)), n)
    assert np.all(h[n:] == 0) and np.all(jh[n:] == 0)
    assert_close(h[:n], jh[:n], rtol=HIST_RTOL[f64], what="history")
    assert u.dtype == (torch.float64 if f64 else torch.float32)
    assert_close(u.numpy(), ju, rtol=0,
                 atol=U_TOL[solver][f64] * np.abs(ju).max(),
                 what="solution")


@pytest.mark.parametrize("solver", SOLVERS)
def test_masked_calls_change_nothing(solver):
    """f32: ``READ_EVERY = 1`` stops at once; the shipped value runs the
    body up to the next multiple of it, masked, with the same bits."""
    c = _case(solver, False)
    n, k = c["n"], loop.READ_EVERY
    (u1, h1, calls1), (uk, hk, callsk) = c["one"], c["shipped"]
    assert calls1 == n
    assert callsk == min(k * -(-n // k), MAX_ITERS[solver]) > n
    assert torch.equal(uk, u1) and torch.equal(hk, h1)


def test_a_solve_that_starts_converged_runs_no_iteration():
    """The flag is read before the first call: a zero residual (the
    start is the solution) runs no body call, as JAX's ``cond`` does."""
    calls = []
    while_loop = loop.while_loop

    def counted(body, active, max_iters, device):
        calls.append(bool(active))
        return while_loop(body, active, max_iters, device)

    n = 8
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(loop, "while_loop", counted)
        sol, h = pt.cg_solve(lambda p: torch.sum(p["x"] ** 2),
                             {"x": torch.zeros(n)}, max_iters=10)
    assert calls == [False]
    assert torch.equal(h, torch.zeros(10)) and torch.equal(sol["x"],
                                                           torch.zeros(n))
