"""The port's geometric multigrid (``solve/multigrid.py``) against the JAX
package's, from the same numpy grids and params.

Tolerances:
* ``coarsen_grid``'s masks (the fractional quad mask included),
  ``prolong`` and ``_restrict`` array-equal; adjointness
  ``<prolong(x), y> = <x, _restrict(y)>`` within 1e-6 relative (f32);
* level ``dinv`` rtol 1e-5 and ``lmax`` rtol 1e-5 in f32 (the power
  iteration starts from ``sin(arange)``, which torch and XLA may round an
  ulp apart), 1e-10 in f64;
* one V-cycle on JAX's carried-across levels: rtol 1e-4 x max (f32; 60
  level operators of f32 stencil sums in other orders);
* MG-PCG solutions within 1e-4 x max|u| of JAX's and of the port's
  ``cg_solve`` (as ``tests/test_multigrid.py::test_mg_matches_cg``), and
  on JAX's levels the first 5 residuals rtol 1e-3; f64 to relres 1e-10,
  within 1e-8 x max|u| of the port's f64 CG solution.

The plan a hierarchy keeps (a kept ``linear.PCGLoop``, port only): a
solve on a kept plan is bit-equal to the same load case on a fresh
hierarchy (f32 and f64, from rest and from the noise start), returns
nothing that a later solve overwrites, and a plan is rebuilt where its
key differs and kept nowhere without a prebuilt hierarchy;
``plan_counts`` counts each.  ``tests/test_torch_kept_plan.py`` holds
what both solvers' plans share.
"""

import dataclasses
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hidenn_fem_tpu_torch as pt
from hidenn_fem_tpu.models.structured_grid import (
    StructuredGridP1 as JModel, generate_structured_grid as jgrid_gen)
from hidenn_fem_tpu.solve import multigrid as jmg
from hidenn_fem_tpu_torch.models.structured_grid import (
    StructuredGridP1 as TModel)
from hidenn_fem_tpu_torch.solve import multigrid as tmg

from torch_port_common import CPU, assert_close

HOLE = ((1.0, 0.5, 0.15),)


def _setup(nx, ny, split="up", holes=(), f64=False, seed=0):
    """(JAX grid, model, params; port grid, model, params) of one numpy
    grid and one numpy init (u0 = 1e-5 N(0, 1))."""
    jdt = jnp.float64 if f64 else jnp.float32
    tdt = torch.float64 if f64 else torch.float32
    jg = jgrid_gen(length=2.0, height=1.0, nx=nx, ny=ny, split=split,
                   holes=holes)
    jm = JModel(E=10e9, nu=0.3, dtype=jdt)
    u0 = 1e-5 * np.random.default_rng(seed).standard_normal((nx, ny, 2))
    coords = np.asarray(jg.coords, dtype=np.float64)
    jp = {"coords": jnp.asarray(coords, jdt), "u": jnp.asarray(u0, jdt)}
    tg = pt.grid_from_numpy(jg, device=CPU, dtype=tdt)
    tm = TModel(E=10e9, nu=0.3, dtype=tdt)
    tp = pt.params_from_numpy({"coords": coords, "u": u0}, device=CPU,
                              dtype=tdt)
    return jg, jm, jp, tg, tm, tp


@pytest.fixture(scope="module")
def zigzag_hole():
    """The 17x9 zigzag plate with a hole on both sides, and the JAX
    package's hierarchy, V-cycle and MG-PCG solve on it (computed once:
    JAX compiles each of them for the CPU)."""
    jg, jm, jp, tg, tm, tp = _setup(17, 9, "zigzag", HOLE)
    jlev = jmg.build_hierarchy(jm, jg, jm.coords(jp, jg))
    b = np.random.default_rng(1).standard_normal((17, 9, 2)) * 1e3
    b *= np.asarray(jlev[0].free)
    jz = np.asarray(jax.jit(jmg.vcycle, static_argnums=0)(
        jm, jlev, jnp.asarray(b, jnp.float32)))
    jsol, jh = jmg.mg_pcg_solve(jm, jg, jp, max_iters=40, tol=1e-6,
                                levels=jlev)
    return dict(jlev=jlev, b=b, jz=jz, ju=np.asarray(jsol["u"]),
                jh=np.asarray(jh), tg=tg, tm=tm, tp=tp)


def test_coarsen_grid_matches_jax():
    jg, _, _, tg, _, _ = _setup(17, 9, split="zigzag", holes=HOLE)
    jc, tc = jmg.coarsen_grid(jg), tmg.coarsen_grid(tg)
    assert (tc.nx, tc.ny) == (jc.nx, jc.ny) == (9, 5)
    qm = tc.quad_mask.numpy()
    assert np.any((qm > 0) & (qm < 1))    # fractional weights
    np.testing.assert_array_equal(qm, np.asarray(jc.quad_mask))
    for name in ("coords", "geom_boundary_mask", "dirichlet_mask"):
        np.testing.assert_array_equal(getattr(tc, name).numpy(),
                                      np.asarray(getattr(jc, name)),
                                      err_msg=name)
        assert getattr(tc, name).is_contiguous()
    assert tc.neumann_edge_masks == {} and tc.u_dirichlet is None
    assert (tc.split, tc.zigzag_phase) == (jc.split, jc.zigzag_phase)
    # the lattice bottoms out as JAX's does: 9x5 -> 5x3 -> 3x2 -> None
    assert tmg.coarsen_grid(tmg.coarsen_grid(tmg.coarsen_grid(tc))) is None


def test_prolong_and_restrict_match_jax_and_are_adjoint():
    rng = np.random.RandomState(0)
    cu = rng.randn(7, 5, 2).astype(np.float32)
    fr = rng.randn(13, 9, 2).astype(np.float32)
    tp_ = tmg.prolong(torch.tensor(cu))
    np.testing.assert_array_equal(tp_.numpy(),
                                  np.asarray(jmg.prolong(jnp.asarray(cu))))
    tr = tmg._restrict(torch.tensor(fr))
    jr = np.asarray(jmg._restrict(jnp.asarray(fr)))
    assert tr.shape == (7, 5, 2)
    np.testing.assert_array_equal(tr.numpy(), jr)
    lhs = float(torch.sum(tp_.double() * torch.tensor(fr).double()))
    rhs = float(torch.sum(torch.tensor(cu).double() * tr.double()))
    assert abs(lhs - rhs) <= 1e-6 * max(1.0, abs(lhs))


def _check_levels(tl, jl, rtol):
    assert [(lv.grid.nx, lv.grid.ny) for lv in tl] == [
        (lv.grid.nx, lv.grid.ny) for lv in jl]
    for i, (t, j) in enumerate(zip(tl, jl)):
        jd = np.asarray(j.dinv)
        np.testing.assert_array_equal(t.free.numpy(), np.asarray(j.free))
        assert_close(t.dinv.numpy(), jd, rtol=rtol,
                     atol=rtol * np.abs(jd).max(), what=f"dinv {i}")
        assert_close(float(t.lmax), float(j.lmax), rtol=rtol,
                     what=f"lmax {i}")
        assert t.lmax_host == float(t.lmax)


def test_hierarchy_matches_jax_zigzag_hole(zigzag_hole):
    z = zigzag_hole
    with torch.no_grad():
        tl = tmg.build_hierarchy(z["tm"], z["tg"], z["tm"].coords(z["tp"],
                                                                  z["tg"]))
    _check_levels(tl, z["jlev"], 1e-5)


def test_hierarchy_matches_jax_33x17_up_f64():
    with jax.enable_x64(True):
        jg, jm, jp, tg, tm, tp = _setup(33, 17, "up", (), f64=True)
        jl = jmg.build_hierarchy(jm, jg, jm.coords(jp, jg))
        jl = jax.tree.map(np.asarray, jl)
    with torch.no_grad():
        tl = tmg.build_hierarchy(tm, tg, tm.coords(tp, tg))
    assert len(tl) == 3
    _check_levels(tl, jl, 1e-10)


def test_vcycle_on_jax_levels_matches_jax(zigzag_hole):
    """One V(3,3) cycle on the JAX package's own hierarchy, carried
    across by ``levels_from_numpy``: the port's V-cycle apart from its
    ``build_hierarchy``."""
    z = zigzag_hole
    tlev = pt.levels_from_numpy(z["jlev"], z["tg"], device=CPU)
    assert tlev[0].grid is z["tg"] and len(tlev) == len(z["jlev"])
    tz = tmg.vcycle(z["tm"], tlev, torch.tensor(z["b"], dtype=torch.float32))
    assert_close(tz.numpy(), z["jz"], rtol=0,
                 atol=1e-4 * np.abs(z["jz"]).max())


def _cg_reference(model, grid, params, iters=3000, tol=1e-7):
    def loss(p, coords, g):
        return model({"coords": coords, "u": p["u"]}, g)
    sol, _ = pt.cg_solve(loss, {"u": params["u"]},
                         loss_args=(params["coords"], grid),
                         max_iters=iters, tol=tol)
    return sol["u"]


def test_mg_pcg_matches_jax_and_cg(zigzag_hole):
    z = zigzag_hole
    tg, tm, tp = z["tg"], z["tm"], z["tp"]
    tsol, th = tmg.mg_pcg_solve(tm, tg, tp, max_iters=40, tol=1e-6)
    tu, th = tsol["u"].numpy(), th.numpy()
    k = int((th > 0).sum())
    assert th[k - 1] <= 1e-6 and np.all(th[k:] == 0) and k <= 25
    jh = z["jh"]
    assert jh[jh > 0][-1] <= 1e-6
    scale = np.abs(z["ju"]).max()
    assert_close(tu, z["ju"], rtol=0, atol=1e-4 * scale, what="vs JAX")
    u_cg = _cg_reference(tm, tg, tp).numpy()
    assert_close(tu, u_cg, rtol=0, atol=1e-4 * scale, what="vs cg_solve")
    fixed = tg.dirichlet_mask.numpy()
    assert np.array_equal(tu[fixed], tp["u"].numpy()[fixed])
    assert torch.equal(tsol["coords"], tp["coords"])
    # on JAX's own levels the iterations follow JAX's
    tlev = pt.levels_from_numpy(z["jlev"], tg, device=CPU)
    _, th2 = tmg.mg_pcg_solve(tm, tg, tp, max_iters=40, tol=1e-6,
                              levels=tlev)
    assert_close(th2.numpy()[:5], jh[:5], rtol=1e-3, what="history")


def test_mg_pcg_f64_deep_convergence():
    """f64 MG-PCG to relres 1e-10, far below the float32 floor, within
    1e-8 x max|u| of the port's f64 CG solve (to 1e-12)."""
    with jax.enable_x64(True):
        _, _, _, tg, tm, tp = _setup(17, 9, "zigzag", HOLE, f64=True)
    tsol, th = tmg.mg_pcg_solve(tm, tg, tp, max_iters=60, tol=1e-10)
    th = th.numpy()
    assert tsol["u"].dtype == torch.float64
    assert th[th > 0][-1] <= 1e-10
    u_cg = _cg_reference(tm, tg, tp, tol=1e-12).numpy()
    assert_close(tsol["u"].numpy(), u_cg, rtol=0,
                 atol=1e-8 * np.abs(u_cg).max())


def test_radapt_mg_energies_fall():
    _, _, _, tg, tm, tp = _setup(17, 9)
    pf, energies = tmg.radapt_mg_solve(tm, tg, tp, outer_epochs=3,
                                       mg_iters=30, coord_steps=10,
                                       coord_lr=1e-4)
    e = energies.numpy()
    assert e.shape == (3,) and np.all(np.isfinite(e))
    assert np.all(e[1:] <= e[:-1] + 1e-6 * np.abs(e[:-1]))
    assert float((pf["coords"] - tp["coords"]).abs().max()) > 0


def test_example9_small():
    from examples import example9_multigrid_torch as ex9

    sol, hist, _, levels = ex9.main(nx=33, ny=17, device="cpu")
    h = hist.numpy()
    assert h[h > 0][-1] <= 1e-6
    assert [(lv.grid.nx, lv.grid.ny) for lv in levels] == [
        (33, 17), (17, 9), (9, 5)]


# ------------------------------------------------- the plan a hierarchy keeps
PLAN_KW = dict(max_iters=12, tol=1e-6, nu=1, coarse_degree=4)
LOADS = ((8e4, 0.0), (5e4, 3e4), (1.2e5, -4e4))


def _load_cases(f64=False, warm=False):
    """The 17x9 zigzag plate with a hole (two levels): (grid, params from
    rest or from the noise start, the model under a traction on the right
    face, a maker of fresh hierarchies)."""
    with jax.enable_x64(f64):
        _, _, _, tg, tm, tp = _setup(17, 9, "zigzag", HOLE, f64=f64)
    if not warm:
        tp["u"] = torch.zeros_like(tp["u"])

    def loaded(t, **kw):
        return dataclasses.replace(tm, tractions={"right": t}, **kw)

    def hierarchy():
        with torch.no_grad():
            return tmg.build_hierarchy(tm, tg, tm.coords(tp, tg))
    return tg, tp, loaded, hierarchy


def _moved(before):
    return {k: tmg.plan_counts[k] - before[k] for k in before}


@pytest.mark.parametrize("f64", [False, True], ids=["f32", "f64"])
@pytest.mark.parametrize("warm", [False, True], ids=["rest", "warm"])
def test_a_kept_plan_solves_as_a_fresh_hierarchy(f64, warm):
    tg, tp, loaded, hierarchy = _load_cases(f64, warm)
    held, before = hierarchy(), dict(tmg.plan_counts)
    kept = [tmg.mg_pcg_solve(loaded(t), tg, tp, levels=held, **PLAN_KW)
            for t in LOADS]
    assert _moved(before) == {"built": 1, "reused": len(LOADS) - 1}
    assert held.plan is not None
    for t, (sol, hist) in zip(LOADS, kept):
        fresh, fh = tmg.mg_pcg_solve(loaded(t), tg, tp, levels=hierarchy(),
                                     **PLAN_KW)
        assert sol["u"].dtype == tp["u"].dtype
        assert torch.equal(sol["u"], fresh["u"]) and torch.equal(hist, fh)
        assert float(hist[0]) > 0


def test_a_later_solve_leaves_an_earlier_answer_alone():
    """No returned tensor shares memory with the plan's carried tensors,
    so a second solve on the plan changes nothing the first returned; and
    the plan dies with its hierarchy, no collection needed."""
    tg, tp, loaded, hierarchy = _load_cases()
    held = hierarchy()
    sol, hist = tmg.mg_pcg_solve(loaded(LOADS[0]), tg, tp, levels=held,
                                 **PLAN_KW)
    u1, h1 = sol["u"].clone(), hist.clone()
    c = held.plan.carried
    carried = [t for d in (c.x, c.r, c.p) for t in d.values()] + [
        c.rs0, c.rz, c.rs, c.thresh, c.hist, c.i, c.active]
    plan_memory = {t.untyped_storage().data_ptr() for t in carried}
    for t in (sol["u"], hist):
        assert t.untyped_storage().data_ptr() not in plan_memory
    tmg.mg_pcg_solve(loaded(LOADS[1]), tg, tp, levels=held, **PLAN_KW)
    assert torch.equal(sol["u"], u1) and torch.equal(hist, h1)
    plan = weakref.ref(held.plan)
    collecting = gc.isenabled()
    gc.disable()
    try:
        del held, c, carried
        assert plan() is None
    finally:
        if collecting:
            gc.enable()


@pytest.mark.parametrize("change", [{"E": 2e10}, {"tol": 1e-4},
                                    {"max_iters": 10}],
                         ids=["E", "tol", "max_iters"])
def test_a_key_that_differs_builds_a_new_plan(change):
    """A solve whose key differs from the held plan's builds its own,
    which replaces the held one and solves as a fresh hierarchy does; the
    first key's next solve then builds again."""
    tg, tp, loaded, hierarchy = _load_cases()
    model_kw = {k: v for k, v in change.items() if k == "E"}
    kw = dict(PLAN_KW, **{k: v for k, v in change.items() if k != "E"})
    held, before = hierarchy(), dict(tmg.plan_counts)
    tmg.mg_pcg_solve(loaded(LOADS[0]), tg, tp, levels=held, **PLAN_KW)
    first = held.plan
    sol, hist = tmg.mg_pcg_solve(loaded(LOADS[1], **model_kw), tg, tp,
                                 levels=held, **kw)
    assert _moved(before) == {"built": 2, "reused": 0}
    assert held.plan is not first and held.plan.key != first.key
    fresh, fh = tmg.mg_pcg_solve(loaded(LOADS[1], **model_kw), tg, tp,
                                 levels=hierarchy(), **kw)
    assert torch.equal(sol["u"], fresh["u"]) and torch.equal(hist, fh)
    before = dict(tmg.plan_counts)
    tmg.mg_pcg_solve(loaded(LOADS[2]), tg, tp, levels=held, **PLAN_KW)
    tmg.mg_pcg_solve(loaded(LOADS[0]), tg, tp, levels=held, **PLAN_KW)
    assert _moved(before) == {"built": 1, "reused": 1}


@pytest.mark.parametrize("entry", ["levels_none", "radapt"])
def test_a_solve_without_a_prebuilt_hierarchy_keeps_no_plan(entry,
                                                            monkeypatch):
    """Each solve builds its hierarchy and a plan, and keeps neither."""
    tg, tp, loaded, _ = _load_cases()
    built, build = [], tmg.build_hierarchy

    def recorded(*args, **kw):
        built.append(build(*args, **kw))
        return built[-1]
    monkeypatch.setattr(tmg, "build_hierarchy", recorded)
    before = dict(tmg.plan_counts)
    if entry == "radapt":
        tmg.radapt_mg_solve(loaded(LOADS[0]), tg, tp, outer_epochs=2,
                            mg_iters=6, coord_steps=1, coord_lr=1e-4)
    else:
        for t in LOADS[:2]:
            tmg.mg_pcg_solve(loaded(t), tg, tp, **PLAN_KW)
    assert len(built) == 2
    assert all(h.plan is None for h in built)
    assert _moved(before) == {"built": 2, "reused": 0}
