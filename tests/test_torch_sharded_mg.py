"""The port's row-sharded multigrid (``parallel/sharded_mg.py``): the
checks of ``tests/test_sharding.py::
test_sharded_multigrid_matches_single_device`` on the port, held to the
JAX package from the same numpy arrays, and the port's collective census.

* The hierarchy, in this process for D = 8 (set-up issues no collective):
  the signed pad counts ``ks`` and the sharded levels equal JAX's
  ``build_sharded_hierarchy`` on the 8 virtual CPU devices (33x17 and
  65x33); the padded level tables (coords, masks, quad mask, ``free``)
  array-equal, ``dinv`` and ``lmax`` at rtol 1e-5 in f32 (the port's
  multigrid tests' bound), 1e-10 in f64 under ``jax.enable_x64``.
* Solves on spawned gloo groups of 2 and 4 CPU ranks
  (``tests/torch_sharded_common``), both engines, on the hole-free 33x17
  plate from u0 = 1e-5 N(0, 1): every rank's solution and history are
  bit-equal; each ends at relres <= 1e-6, within 3 iterations and
  5e-4 x max|u| of JAX's ``mg_pcg_solve_sharded`` (8 devices, the same
  engine) and of JAX's ``mg_pcg_solve`` (the bounds of the JAX test), and
  in exactly the iterations of the port's single-process
  ``mg_pcg_solve``.  In f64 (engine "all") the groups reach relres 1e-10
  within 1e-8 x max|u| of the port's single-process f64 solve.
* The census: ``count_collectives`` equals the ``all_reduce`` calls a
  group's rank issues in a 4-iteration solve (tol 0, so it runs to its
  cap), for both engines.  JAX's assertion that the all-levels engine
  issues no more collectives than the replicated-coarse one is a property
  of XLA's compiled HLO and is not carried over: the port's "all" engine
  issues one ``all_reduce`` for each sharded level operator, so it issues
  more.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import hidenn_fem_tpu as ht
import hidenn_fem_tpu_torch as pt
from hidenn_fem_tpu.models.structured_grid import (
    StructuredGridP1 as JModel, generate_structured_grid as jgrid_gen)
from hidenn_fem_tpu.parallel import sharded_mg as jsmg
from hidenn_fem_tpu_torch.parallel import DeviceMesh
from hidenn_fem_tpu_torch.parallel import sharded_mg as tsmg
from hidenn_fem_tpu_torch.solve import multigrid as tmg

from torch_port_common import CPU, assert_close
from torch_sharded_common import Groups

NX, NY = 33, 17
WORLDS = (2, 4)
ENGINES = ("all", "replicated_coarse")
CENSUS_ITERS = 4


def _u0(nx=NX, ny=NY):
    return 1e-5 * np.random.default_rng(0).standard_normal((nx, ny, 2))


def _port(nx=NX, ny=NY, dtype=torch.float32):
    """The port's grid, model and params of the hole-free plate (the
    JAX package's ``generate_structured_grid`` makes the same arrays)."""
    grid = pt.grid_from_numpy(pt.generate_structured_grid(
        length=2.0, height=1.0, nx=nx, ny=ny, device=CPU), device=CPU,
        dtype=dtype)
    model = pt.StructuredGridP1(E=10e9, nu=0.3, dtype=dtype)
    params = {"coords": grid.coords,
              "u": torch.tensor(_u0(nx, ny), dtype=dtype)}
    return grid, model, params


def _iters(h) -> int:
    return int((np.asarray(h) > 0).sum())


class _Spawned:
    """The groups, started first; then the JAX references and the port's
    single-process solves, computed while the ranks run."""

    def __init__(self, folder):
        cases = []
        for engine in ENGINES:
            cases.append((dict(name=f"solve_{engine}", fn="mg",
                               dtype="float32", nx=NX, ny=NY, max_iters=40,
                               tol=1e-6, engine=engine), {"p_u": _u0()}))
            cases.append((dict(name=f"census_{engine}", fn="mg",
                               dtype="float32", nx=NX, ny=NY,
                               max_iters=CENSUS_ITERS, tol=0.0,
                               engine=engine), {"p_u": _u0()}))
        cases.append((dict(name="solve_f64", fn="mg", dtype="float64",
                           nx=NX, ny=NY, max_iters=60, tol=1e-10,
                           engine="all"), {"p_u": _u0()}))
        self.groups = Groups(folder, cases, worlds=WORLDS)

        jg = jgrid_gen(length=2.0, height=1.0, nx=NX, ny=NY)
        jm = JModel(E=10e9, nu=0.3)
        jp = {"coords": jg.coords, "u": jnp.asarray(_u0(), jnp.float32)}

        def jax_solve(engine):
            if engine == "single":
                sol, h = ht.mg_pcg_solve(jm, jg, jp, max_iters=40, tol=1e-6)
            else:
                sol, h = jsmg.mg_pcg_solve_sharded(
                    jm, jg, jp, n_devices=8, max_iters=40, tol=1e-6,
                    engine=engine)
            return np.asarray(sol["u"]), np.asarray(h)

        # the three JAX solves compile at once (XLA compiles off the GIL)
        with ThreadPoolExecutor(3) as pool:
            names = ("single",) + ENGINES
            self.jax = dict(zip(names, pool.map(jax_solve, names)))
        self.single = {}
        for dt, tol, iters in ((torch.float32, 1e-6, 40),
                               (torch.float64, 1e-10, 60)):
            grid, model, params = _port(dtype=dt)
            sol, h = pt.mg_pcg_solve(model, grid, params, max_iters=iters,
                                     tol=tol)
            self.single[dt] = (sol["u"].numpy(), h.numpy())


@pytest.fixture(scope="module")
def spawned(tmp_path_factory, eight_devices):
    s = _Spawned(tmp_path_factory.mktemp("sharded_mg"))
    yield s
    s.groups.close()


def _check_levels(tl, tks, jl, jks, rtol):
    assert tks == tuple(jks)
    assert [(lv.grid.nx, lv.grid.ny) for lv in tl] == [
        (lv.grid.nx, lv.grid.ny) for lv in jl]
    for i, (t, j) in enumerate(zip(tl, jl)):
        for name in ("coords", "geom_boundary_mask", "dirichlet_mask",
                     "quad_mask"):
            np.testing.assert_array_equal(
                getattr(t.grid, name).numpy(),
                np.asarray(getattr(j.grid, name)), err_msg=f"{name} {i}")
        assert t.grid.zigzag_phase == j.grid.zigzag_phase
        np.testing.assert_array_equal(t.coords.numpy(), np.asarray(j.coords))
        np.testing.assert_array_equal(t.free.numpy(), np.asarray(j.free))
        jd = np.asarray(j.dinv)
        assert_close(t.dinv.numpy(), jd, rtol=rtol,
                     atol=rtol * np.abs(jd).max(), what=f"dinv {i}")
        assert_close(float(t.lmax), float(j.lmax), rtol=rtol,
                     what=f"lmax {i}")


def _hierarchies(nx, ny, devices, f64=False):
    jdt = jnp.float64 if f64 else jnp.float32
    tdt = torch.float64 if f64 else torch.float32
    jg = jgrid_gen(length=2.0, height=1.0, nx=nx, ny=ny)
    jm = JModel(E=10e9, nu=0.3, dtype=jdt)
    jl, jks = jsmg.build_sharded_hierarchy(
        jm, jg, jnp.asarray(jg.coords, jdt),
        Mesh(np.asarray(devices), ("row",)))
    jl = jax.tree.map(np.asarray, jl)
    grid, model, _ = _port(nx, ny, tdt)
    tl, tks = tsmg.build_sharded_hierarchy(
        model, grid, grid.coords,
        DeviceMesh(group=None, rank=0, size=len(devices), device=CPU))
    return tl, tks, jl, jks


@pytest.mark.parametrize("nx,ny", [(33, 17), (65, 33)])
def test_sharded_hierarchy_matches_jax(eight_devices, nx, ny):
    tl, tks, jl, jks = _hierarchies(nx, ny, eight_devices)
    assert tks[0] != 0 and tks[-1] == 0       # sharded fine, replicated end
    _check_levels(tl, tks, jl, jks, 1e-5)


def test_sharded_hierarchy_matches_jax_f64(eight_devices):
    with jax.enable_x64(True):
        tl, tks, jl, jks = _hierarchies(NX, NY, eight_devices, f64=True)
    assert tl[0].dinv.dtype == torch.float64
    _check_levels(tl, tks, jl, jks, 1e-10)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_mg_matches_jax_and_single_device(spawned, world, engine):
    got = spawned.groups.case(world, f"solve_{engine}")   # ranks bit-equal
    assert "error" not in got, str(got.get("error"))
    h = got["hist"]
    assert h[h > 0][-1] <= 1e-6
    u1, h1 = spawned.single[torch.float32]
    assert _iters(h) == _iters(h1)
    for ref in ("single", engine):
        u0, h0 = spawned.jax[ref]
        assert abs(_iters(h) - _iters(h0)) <= 3, (ref, _iters(h0),
                                                  _iters(h))
        assert np.abs(got["u"] - u0).max() <= 5e-4 * np.abs(u0).max(), ref
    assert np.abs(got["u"] - u1).max() <= 5e-4 * np.abs(u1).max()


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_mg_census_equals_the_calls(spawned, world, engine):
    got = spawned.groups.case(world, f"census_{engine}")
    assert _iters(got["hist"]) == CENSUS_ITERS
    grid, model, params = _port()
    want = tsmg.count_collectives(model, grid, params, n_devices=world,
                                  engine=engine, max_iters=CENSUS_ITERS)
    assert want["broadcast"] == 0
    assert int(got["all_reduce"]) == want["all_reduce"] > 0


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_mg_f64_matches_single_device(spawned, world):
    got = spawned.groups.case(world, "solve_f64")
    assert got["u"].dtype == np.float64
    h = got["hist"]
    assert h[h > 0][-1] <= 1e-10
    u1, _ = spawned.single[torch.float64]
    assert np.abs(got["u"] - u1).max() <= 1e-8 * np.abs(u1).max()


@pytest.mark.parametrize("engine", ENGINES)
def test_one_rank_is_the_single_device_solve(engine):
    """Without a group (one rank, nothing padded), both engines run the
    single-device solve's operations: solution and history bit-equal."""
    grid, model, params = _port()
    one = DeviceMesh(group=None, rank=0, size=1, device=CPU)
    sol1, h1 = tsmg.mg_pcg_solve_sharded(model, grid, params, dmesh=one,
                                         max_iters=40, tol=1e-6,
                                         engine=engine)
    sol0, h0 = tmg.mg_pcg_solve(model, grid, params, max_iters=40,
                                tol=1e-6)
    assert torch.equal(h1, h0)
    assert torch.equal(sol1["u"], sol0["u"])


def test_replicated_coarse_needs_a_coarsenable_grid():
    grid, model, params = _port(nx=6, ny=5)
    one = DeviceMesh(group=None, rank=0, size=1, device=CPU)
    with pytest.raises(ValueError, match="too small to coarsen"):
        tsmg.mg_pcg_solve_sharded(model, grid, params, dmesh=one,
                                  engine="replicated_coarse")
    with pytest.raises(ValueError, match="unknown engine"):
        tsmg.count_collectives(model, grid, params, engine="bogus")
