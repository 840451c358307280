"""What the kept PCG plans of the multigrid and the auxiliary-space
solvers share (``solve/linear.py``: a ``PCGLoop`` with a key, held on its
holder through ``take_plan`` and ``hold_plan``), on both solvers, port
only.  Each solver's own plan tests are in ``tests/test_torch_multigrid.py``
and ``tests/test_torch_auxspace.py``.
"""

import dataclasses
import gc
import weakref

import pytest
import torch

import hidenn_fem_tpu_torch as pt
from hidenn_fem_tpu_torch.models.structured_grid import StructuredGridP1
from hidenn_fem_tpu_torch.solve import auxspace, loop, multigrid

from torch_port_common import CPU

E, NU = 10e9, 0.3
LOADS = (1e5, 5e4)
KW = dict(max_iters=12, tol=1e-6)       # bits, not convergence


def _mg():
    """(solve(load, holder), a maker of fresh holders, the plan counts)
    of MG-PCG on the 17x9 plate with a hole, from rest."""
    grid = pt.generate_structured_grid(nx=17, ny=9, holes=((1.0, 0.5, 0.15),),
                                       device=CPU)
    model = StructuredGridP1(E=E, nu=NU)
    params = {"coords": grid.coords, "u": torch.zeros_like(grid.coords)}

    def solve(load, held):
        loaded = dataclasses.replace(model, tractions={"right": (load, 0.0)})
        return multigrid.mg_pcg_solve(loaded, grid, params, levels=held,
                                      nu=1, coarse_degree=4, **KW)

    def fresh():
        with torch.no_grad():
            return multigrid.build_hierarchy(model, grid,
                                             model.coords(params, grid))
    return solve, fresh, multigrid.plan_counts


def _aux():
    """The same of aux-PCG on the 21x11 proxy plate (the lattice
    background), from rest, each load a new loss on the same arguments."""
    mesh = pt.proxy_plate_mesh(nx=21, ny=11, device=CPU)
    rest = {"u": torch.zeros((mesh.n_nodes, 2))}
    args = (mesh.coords, mesh)

    def loss(load):
        energy = pt.PlaneStressEnergy(model=pt.TriangleP1(), E=E, nu=NU,
                                      F_total=load)
        return lambda p, coords, m: energy.total(
            {"coords": coords, "u": p["u"]}, m)

    pre = auxspace.build_aux_preconditioner(
        loss(LOADS[0]), rest, args, mesh, bg_model=StructuredGridP1(E=E,
                                                                    nu=NU))

    def solve(load, held):
        return auxspace.aux_pcg_solve(loss(load), rest, args, pre=held, **KW)
    return solve, lambda: dataclasses.replace(pre), auxspace.plan_counts


@pytest.mark.parametrize("solver", [_mg, _aux], ids=["mg", "aux"])
def test_a_solve_that_raises_leaves_no_plan(solver, monkeypatch):
    """A solve that raises inside the PCG loop leaves no plan on its
    holder, and the plan it took is freed with it, no collection needed;
    the next solve there builds a plan afresh and answers bit for bit as
    on a fresh holder."""
    solve, fresh, counts = solver()
    held = fresh()
    solve(LOADS[0], held)
    plan = weakref.ref(held.plan)

    def broken(*args, **kw):
        raise RuntimeError("the loop broke")
    with monkeypatch.context() as m:
        m.setattr(loop, "while_loop", broken)
        with pytest.raises(RuntimeError, match="the loop broke"):
            solve(LOADS[1], held)
    assert held.plan is None
    collecting = gc.isenabled()
    gc.disable()
    try:
        assert plan() is None
    finally:
        if collecting:
            gc.enable()
    before = dict(counts)
    sol, hist = solve(LOADS[1], held)
    assert {k: counts[k] - before[k] for k in before} == dict(
        dict.fromkeys(before, 0), built=1)
    assert held.plan is not None
    fsol, fhist = solve(LOADS[1], fresh())
    assert torch.equal(sol["u"], fsol["u"]) and torch.equal(hist, fhist)
    assert float(hist[0]) > 0
