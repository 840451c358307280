"""The port's sharded auxiliary-space PCG (``parallel/sharded_aux.py``):
the checks of ``tests/test_sharding.py::
test_sharded_aux_pcg_matches_single_device`` and
``::test_sharded_aux_pcg_lattice_matvec[lattice, hybrid]`` on the port,
held to the JAX package from the same numpy arrays.

Spawned gloo groups of 2 and 4 CPU ranks (``tests/torch_sharded_common``)
solve three meshes with ``aux_pcg_solve_sharded``: the 33x17 proxy plate
with its lattice stripped (the banded route, rebanded for the group, as
JAX's test does), the same plate with its lattice (the row-sharded
lattice route) and a hybrid plate (``generate_mesh_hybrid(lc=0.06)``, one
hole).  Every rank's solution and history are bit-equal to rank 0's; as
in the JAX tests, each group ends at relres <= 1e-6 within 6 iterations of
the port's single-device ``aux_pcg_solve`` (whose matvec takes the
mesh's own route; the gather route for the stripped plate) and within
5e-3 x max|u| of its solution.  Both are held to the JAX package's CG
solution of the same system from the same start (tol 1e-6: within
5e-3 x max|u|, the bound of ``tests/test_auxspace.py::
test_aux_pcg_with_holes`` between aux-PCG and CG solutions).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hidenn_fem_tpu as ht
import hidenn_fem_tpu_torch as pt
from hidenn_fem_tpu_torch.models.structured_grid import \
    StructuredGridP1 as TBG
from hidenn_fem_tpu_torch.parallel import DeviceMesh, aux_pcg_solve_sharded

from torch_port_common import CPU
from torch_sharded_common import Groups, mesh_arrays

E, NU = 10e9, 0.3
HYBRID = dict(holes=[[1.0, 0.5, 0.25]], lc=0.06)
WORLDS = (2, 4)
CASES = ("banded", "lattice", "hybrid")


def _jax_meshes():
    plate = ht.proxy_plate_mesh(nx=33, ny=17)
    hyb = ht.generate_mesh_hybrid(**HYBRID)
    assert hyb.lattice is None and hyb.hybrid is not None
    return {"banded": dataclasses.replace(plate, lattice=None),
            "lattice": plate, "hybrid": hyb}


def _port_mesh(name, jm):
    if name == "hybrid":
        tm = pt.generate_mesh_hybrid(device=CPU, **HYBRID)
        np.testing.assert_array_equal(tm.coords.numpy(),
                                      np.asarray(jm.coords))
        return tm
    return pt.mesh_from_numpy(jm, device=CPU, build_banded=False,
                              build_lattice=jm.lattice is not None)


class _Spawned:
    """The groups, the port's single-device solves and the JAX CG
    references (computed while the ranks run)."""

    def __init__(self, folder):
        self.jmeshes = _jax_meshes()
        self.u0 = {}
        cases = []
        for name, jm in self.jmeshes.items():
            u0 = np.asarray(ht.TriangleP1().init(jax.random.PRNGKey(0),
                                                 jm)["u"])
            self.u0[name] = u0
            case = dict(name=name, fn="aux", dtype="float32", max_iters=100,
                        tol=1e-6, lattice=jm.lattice is not None)
            if name == "hybrid":
                case["hybrid"] = HYBRID
            cases.append((case, mesh_arrays(jm, {"coords": jm.coords,
                                                 "u": u0})))
        self.groups = Groups(folder, cases, worlds=WORLDS)
        self.single, self.jax_cg = {}, {}
        for name, jm in self.jmeshes.items():
            self.single[name] = self._single(name, jm)
            self.jax_cg[name] = self._jax_cg(name, jm)

    def _single(self, name, jm):
        tm = _port_mesh(name, jm)
        energy = pt.PlaneStressEnergy(model=pt.TriangleP1(), E=E, nu=NU)

        def u_loss(p, coords, m):
            return energy({"u": p["u"], "coords": coords}, m)

        single = dataclasses.replace(tm, banded=None, banded_paired=None)
        sol, h = pt.aux_pcg_solve(u_loss, {"u": torch.tensor(self.u0[name])},
                                  (tm.coords, single), mesh=tm,
                                  bg_model=TBG(E=E, nu=NU), max_iters=100,
                                  tol=1e-6)
        return sol["u"].numpy(), h.numpy()

    def _jax_cg(self, name, jm):
        energy = ht.PlaneStressEnergy(model=ht.TriangleP1(), E=E, nu=NU)

        def u_loss(p, coords, m):
            return energy({"u": p["u"], "coords": coords}, m)

        sol, _ = ht.cg_solve(u_loss, {"u": jnp.asarray(self.u0[name])},
                             (jm.coords, jm), max_iters=3000, tol=1e-6)
        return np.asarray(sol["u"])


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    s = _Spawned(tmp_path_factory.mktemp("sharded_aux"))
    yield s
    s.groups.close()


def _iters(h) -> int:
    return int((np.asarray(h) > 0).sum())


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", CASES)
def test_sharded_aux_pcg_matches_single_device(spawned, name, world):
    got = spawned.groups.case(world, name)      # bit-equal across ranks
    assert "error" not in got, str(got.get("error"))
    h1 = got["hist"]
    u0, h0 = spawned.single[name]
    assert h1[h1 > 0][-1] <= 1e-6
    assert h0[h0 > 0][-1] <= 1e-6
    # tol 1e-6 sits at the f32 residual floor: the sharded and single
    # reduction orders differ, so the last iterations wobble (JAX's bound)
    assert abs(_iters(h1) - _iters(h0)) <= 6, (_iters(h0), _iters(h1))
    s = np.abs(u0).max()
    assert np.abs(got["u"] - u0).max() <= 5e-3 * s
    ref = spawned.jax_cg[name]
    for u in (got["u"], u0):
        assert np.abs(u - ref).max() <= 5e-3 * np.abs(ref).max()


def test_sharded_aux_one_rank_is_the_single_device_solve():
    """Without a group, ``aux_pcg_solve_sharded`` on the lattice plate
    (one row block) follows ``aux_pcg_solve`` on the lattice route."""
    jm = ht.proxy_plate_mesh(nx=17, ny=9)
    tm = _port_mesh("lattice", jm)
    u0 = np.asarray(ht.TriangleP1().init(jax.random.PRNGKey(0), jm)["u"])
    energy = pt.PlaneStressEnergy(model=pt.TriangleP1(), E=E, nu=NU)
    params = {"coords": tm.coords, "u": torch.tensor(u0)}
    one = DeviceMesh(group=None, rank=0, size=1, device=CPU)
    sol1, h1 = aux_pcg_solve_sharded(energy, tm, params, dmesh=one,
                                     max_iters=60, tol=1e-6)

    def u_loss(p, coords, m):
        return energy({"u": p["u"], "coords": coords}, m)

    sol0, h0 = pt.aux_pcg_solve(u_loss, {"u": params["u"]},
                                (tm.coords, tm), mesh=tm,
                                bg_model=TBG(E=E, nu=NU), max_iters=60,
                                tol=1e-6)
    # the two matvecs sum the same quads in other orders: at relres 1e-6
    # the f32 solutions lie ~4e-5 x max|u| apart (measured 3.9e-5)
    assert abs(_iters(h1) - _iters(h0)) <= 1
    np.testing.assert_allclose(sol1["u"].numpy(), sol0["u"].numpy(),
                               rtol=0, atol=1e-4 * float(
                                   sol0["u"].abs().max()))
