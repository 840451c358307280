"""The multigrid level steps (``ops/lattice_slab.py``: K6's level
epilogues, the restriction and the bottom levels' one-CTA cycle) against
the composition of ``solve/multigrid.py`` they replace, port only.

On the CPU every plain version is held to the composition bit for bit
(``torch.equal``: the two differ at most in the sign of a zero, where the
composition subtracts a gradient at zero of -0.0): K v, a Chebyshev step,
the first two steps from x = 0, the residual, the restriction and the
prolongation node by node as the kernels compute them, the prolonged
correction with the first post-smoothing step, and the bottom levels'
V-cycle; over the "up" and zigzag splits, with and without a hole, in
float32 and float64.  The dispatch: on the CPU, in float64 and on padded
levels the composition runs and no level step launches.  The launch
count: ``lattice_slab.cycle_launches`` gives what ``lattice_level_cycle``
launches, wrapper by wrapper, with the bottom kernel from level 0, from
level 1 and nowhere (the wrappers replaced by counting plain versions).

On the card (marked ``cuda``; this file imports no JAX, so it runs with
``--noconftest``):

    python -m pytest --noconftest -m cuda tests/test_torch_level_step.py -q

each kernel is held to the composition on the card bit for bit and to
its plain version (the plain stencil's sums in another order than K6's:
within 1e-5 of the largest entry, 1e-4 for a V-cycle), the fused V-cycle
and a whole
``mg_pcg_solve`` to the composed path (the level operators built off the
level-step route) at 129x65 zigzag with a hole and 961x481 "up", and an
aux-space background's cycle at 513x257: bit for bit, the same
iterations, captured equal to eager, a kept plan equal to a fresh
hierarchy, and the level steps' launches exact.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import hidenn_fem_tpu_torch as pt
from hidenn_fem_tpu_torch.models.structured_grid import StructuredGridP1
from hidenn_fem_tpu_torch.ops import lattice_slab as ls
from hidenn_fem_tpu_torch.solve import loop, multigrid as mg

CPU = torch.device("cpu")
torch.set_num_threads(1)

HOLE = ((1.0, 0.5, 0.15),)
NU, COARSE = 3, 24


def _hierarchy(nx, ny, split, holes, dtype, device):
    """(model, levels, level operators) of a plate lattice."""
    grid = pt.generate_structured_grid(nx=nx, ny=ny, split=split,
                                       holes=holes, device=device)
    model = StructuredGridP1(E=10e9, nu=0.3, dtype=dtype)
    with torch.no_grad():
        coords = model.coords({"coords": grid.coords}, grid)
    levels = mg.build_hierarchy(model, grid, coords)
    return model, levels, mg._level_ops(model, levels)


def _lattice_levels(model, levels, coarse=COARSE):
    """Each level as a ``LatticeLevel`` with its smoother (V(3, 3), the
    coarsest to degree ``coarse``), built as ``multigrid._fused_levels``
    builds them, whatever the device and dtype."""
    out = []
    for k, lev in enumerate(levels):
        g = lev.grid
        with torch.no_grad():
            cpin = model.coords({"coords": lev.coords}, g)
        degree = coarse if k == len(levels) - 1 else NU
        theta, coeffs = mg._cheb_coeffs(lev.lmax_host, degree,
                                        lev.lmax.dtype == torch.float64)
        out.append(ls.LatticeLevel(
            coords=cpin.contiguous(), pinned=g.dirichlet_mask.contiguous(),
            E=model.E, nu=model.nu,
            stencil=ls.structured_stencil(g.quad_mask, g.split,
                                          g.zigzag_phase, cpin.dtype),
            dinv=lev.dinv, free=lev.free, theta=theta, coeffs=coeffs))
    return out


def _level_launches() -> dict:
    """The level kernels' launch counters as they stand."""
    return {k: ls.launch_counts[k] for k in ls.LEVEL_KERNELS}


def _since(before: dict) -> dict:
    """The level kernels' launches since ``before``."""
    return {k: ls.launch_counts[k] - v for k, v in before.items()}


def _vector(shape, seed, dtype, device, scale=1e3):
    return torch.tensor(np.random.default_rng(seed).standard_normal(shape)
                        * scale, dtype=dtype, device=device)


# ------------------------------------------------------ node by node
def _prolonged(xc, i, j):
    """prolong(xc) at fine node (i, j) as the kernels compute it (numpy
    scalars: each sum and product rounded alone)."""
    half = xc.dtype.type(0.5)

    def row(J):
        a = xc[i // 2, J]
        return half * (a + xc[i // 2 + 1, J]) if i % 2 else a
    v = row(j // 2)
    return half * (v + row(j // 2 + 1)) if j % 2 else v


def _restricted(r, I, J):
    """Coarse entry (I, J) of the restriction as the kernels compute it."""
    half, zero = r.dtype.type(0.5), np.zeros(2, r.dtype)
    nr, nc = (r.shape[0] + 1) // 2, (r.shape[1] + 1) // 2

    def cols(i):
        o = half * r[i, 2 * J - 1] if J >= 1 else zero
        if J < nc - 1:
            o = o + half * r[i, 2 * J + 1]
        return o + r[i, 2 * J]
    o = half * cols(2 * I - 1) if I >= 1 else zero
    if I < nr - 1:
        o = o + half * cols(2 * I + 1)
    return o + cols(2 * I)


# ------------------------------------------------------------ the CPU
CASES = ["matvec", "step", "from_zero", "residual", "restrict",
         "prolong_correct", "bottom"]


def _outputs(how, case, k, levels, ops, lat):
    """The outputs of ``case`` on level k from fixed inputs (seeded): by
    the plain version (``how`` "plain"), the kernel ("kernel") or the
    composition of ``solve/multigrid.py`` on ``ops`` ("composed"); None
    where the case has no such level (the coarsest has no transfer)."""
    lev, op, lv = levels[k], ops[k], lat[k]
    dtype, dev = lev.dinv.dtype, lev.dinv.device
    shape = (lev.grid.nx, lev.grid.ny, 2)
    b = _vector(shape, 1, dtype, dev) * lev.free
    d = _vector(shape, 2, dtype, dev, 1e-6) * lev.free
    r = _vector(shape, 3, dtype, dev)
    x = _vector(shape, 4, dtype, dev, 1e-6) * lev.free
    c = lv.coeffs[0]
    step = {"plain": ls.lattice_level_step_plain,
            "kernel": ls.lattice_level_step}.get(how)
    if case in ("restrict", "prolong_correct") and k == len(levels) - 1:
        return None
    if case == "matvec":
        return [op(d)] if step is None else [step(ls.MATVEC, lv, d)]
    if case == "step":
        if step is None:
            rn = r - op(d)
            dn = c[0] * d + c[1] * (lev.dinv * rn)
            return [rn, dn, x + dn]
        return list(step(ls.STEP, lv, d, r=r, x=x, c=c))
    if case == "from_zero":
        if step is None:
            return [mg._cheb_smooth(op, lev, b, torch.zeros_like(b), 2)]
        return list(step(ls.FROM_ZERO, lv, b, c=c))[2:]
    if case == "residual":
        if step is None:
            return [b - op(x)]
        return [step(ls.RESIDUAL, lv, x, b=b)]
    if case == "restrict":
        res = b - op(x)
        return [{"plain": ls.restrict_plain, "kernel": ls.lattice_restrict,
                 "composed": mg._restrict}[how](res)]
    cs = (levels[k + 1].grid.nx, levels[k + 1].grid.ny, 2) \
        if k < len(levels) - 1 else None
    if case == "prolong_correct":
        xc = _vector(cs, 5, dtype, dev, 1e-6)
        if step is None:
            return [mg._cheb_smooth(op, lev, b,
                                    x + lev.free * mg.prolong(xc), 1)]
        return list(step(ls.POST_FIRST, lv, x, b=b, xc=xc))[2:]
    # the V-cycle from this level down: the bottom kernel's function
    if how == "composed":
        return [mg._vcycle(ops, levels, b, NU, COARSE, _l=k)]
    if how == "plain":
        return [ls.lattice_level_cycle_plain(lat[k:], b)]
    return [ls.lattice_level_cycle(lat[k:], b)]


@pytest.fixture(scope="module")
def cpu_levels():
    cache = {}

    def get(split, holes, dtype):
        key = (split, holes, dtype)
        if key not in cache:
            model, levels, ops = _hierarchy(33, 17, split, holes, dtype, CPU)
            cache[key] = (levels, ops, _lattice_levels(model, levels))
        return cache[key]
    return get


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("holes", [(), HOLE], ids=["solid", "hole"])
@pytest.mark.parametrize("split", ["up", "zigzag"])
def test_plain_level_step_is_the_composition(cpu_levels, split, holes,
                                             dtype, case):
    """Each plain version equals the composition it replaces, bit for
    bit, on every level of a 33x17 hierarchy (three levels); the
    restriction and the prolongation also node by node in the kernels'
    order."""
    levels, ops, lat = cpu_levels(split, holes, dtype)
    for k in range(len(levels)):
        got = _outputs("plain", case, k, levels, ops, lat)
        if got is None:
            continue
        want = _outputs("composed", case, k, levels, ops, lat)
        if case == "restrict":
            rn = _outputs("composed", "residual", k, levels, ops,
                          lat)[0].numpy()
            nr, nc = (rn.shape[0] + 1) // 2, (rn.shape[1] + 1) // 2
            want.append(torch.tensor(np.array(
                [[_restricted(rn, i, j) for j in range(nc)]
                 for i in range(nr)])))
            got = got * 2
        if case == "prolong_correct":
            cs = (levels[k + 1].grid.nx, levels[k + 1].grid.ny, 2)
            xn = _vector(cs, 5, dtype, CPU, 1e-6).numpy()
            nodes = torch.tensor(np.array(
                [[_prolonged(xn, i, j) for j in range(levels[k].grid.ny)]
                 for i in range(levels[k].grid.nx)]))
            assert torch.equal(nodes, ls.prolong(torch.tensor(xn)))
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w), (
                f"{case} on level {k}: max gap "
                f"{float((g - w).abs().max())}")


@pytest.mark.parametrize("what", ["cpu", "f64", "padded"])
def test_the_composition_runs_off_the_route(what):
    """On the CPU, in float64 and on padded levels (the sharded engines'
    ``ks``) the level operators offer no level step and the V-cycle is
    the composition; no level step launches."""
    model, levels, ops = _hierarchy(
        17, 9, "zigzag", HOLE,
        torch.float64 if what == "f64" else torch.float32, CPU)
    assert all(op.stencil is None for op in ops)
    b = _vector((17, 9, 2), 1, levels[0].dinv.dtype, CPU) * levels[0].free
    ks = [0] * len(levels) if what == "padded" else None
    before = _level_launches()
    assert mg._fused_levels(ops, levels, NU, COARSE) is None
    z = mg._vcycle(ops, levels, b, NU, COARSE, ks)
    params = {"coords": levels[0].coords, "u": torch.zeros_like(b)}
    pt.mg_pcg_solve(model, levels[0].grid, params, max_iters=5,
                    levels=levels)
    assert not any(_since(before).values())
    assert torch.equal(z, ls.lattice_level_cycle_plain(
        _lattice_levels(model, levels), b))


# (nx, ny, the coarsest level's degree): the bottom kernel from level 0
# (33x17: three levels), from level 1 (129x65: 65x33 and below fit one
# CTA) and nowhere (degree 40: more steps than the bottom kernel takes)
LAUNCH_CASES = {"bottom_at_0": (33, 17, COARSE),
                "bottom_at_1": (129, 65, COARSE),
                "no_bottom": (129, 65, 40)}


@pytest.mark.parametrize("case", list(LAUNCH_CASES))
def test_cycle_launches_counts_what_the_cycle_launches(case, monkeypatch):
    """``lattice_slab.cycle_launches`` gives, wrapper by wrapper, the
    launches ``lattice_level_cycle`` makes: its three launching wrappers
    replaced by their plain versions, each counting one launch, on the
    CPU; the answer is the plain cycle's bit for bit."""
    nx, ny, coarse = LAUNCH_CASES[case]
    model, levels, _ = _hierarchy(nx, ny, "zigzag", HOLE, torch.float32,
                                  CPU)
    lat = _lattice_levels(model, levels, coarse)
    made = dict.fromkeys(ls.LEVEL_KERNELS, 0)

    def counted(name, plain):
        def launch(*args, **kwargs):
            made[name] += 1
            return plain(*args, **kwargs)
        return launch
    monkeypatch.setattr(ls, "lattice_level_step", counted(
        "lattice_level_step", ls.lattice_level_step_plain))
    monkeypatch.setattr(ls, "lattice_restrict", counted(
        "lattice_restrict", ls.restrict_plain))
    monkeypatch.setattr(ls, "lattice_bottom_cycle", counted(
        "lattice_bottom_cycle", ls.lattice_level_cycle_plain))
    b = _vector((nx, ny, 2), 1, torch.float32, CPU) * levels[0].free
    z = ls.lattice_level_cycle(lat, b)
    assert made == ls.cycle_launches(lat)
    bottom = {"bottom_at_0": 0, "bottom_at_1": 1, "no_bottom": None}[case]
    assert [k for k in range(len(lat)) if ls._fits_bottom(lat[k:])][:1] \
        == ([] if bottom is None else [bottom])
    assert torch.equal(z, ls.lattice_level_cycle_plain(lat, b))


# ----------------------------------------------------------- the card
@pytest.fixture
def dev():
    """The card; skips where there is none (decided at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (runs on the card)")
    return torch.device("cuda", 0)


# (nx, ny, split, holes) of the card's cases; 513x257 is the aux-space
# background of example 10 and the 898K plate
CARD = {"129x65_zigzag_hole": (129, 65, "zigzag", HOLE),
        "961x481_up": (961, 481, "up", ()),
        "513x257_aux_bg": (513, 257, "up", ())}


def _composed(monkeypatch):
    """Level operators off the level-step route from here on: the
    composition of K6 launches and torch ops."""
    monkeypatch.setattr(mg, "_stencil_level", lambda *a, **k: None)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CARD))
def test_level_kernels_match_the_composition(dev, case, monkeypatch):
    """Each level kernel on every level against the composition it
    replaces on the card (K6 and torch's ops), bit for bit, and against
    its plain version: the plain stencil sums in another order than K6,
    so within 1e-5 of the largest entry (1e-4 for a whole V-cycle), the
    restriction bit for bit."""
    nx, ny, split, holes = CARD[case]
    model, levels, _ = _hierarchy(nx, ny, split, holes, torch.float32,
                                  dev)
    lat = _lattice_levels(model, levels)
    _composed(monkeypatch)
    ops = mg._level_ops(model, levels)
    for k in range(len(levels)):
        for what in CASES:
            got = _outputs("kernel", what, k, levels, ops, lat)
            if got is None:
                continue
            want = _outputs("composed", what, k, levels, ops, lat)
            plain = _outputs("plain", what, k, levels, ops, lat)
            torch.cuda.synchronize()
            rtol = 0.0 if what == "restrict" else (
                1e-4 if what == "bottom" else 1e-5)
            for i, (g, w, p) in enumerate(zip(got, want, plain)):
                assert torch.equal(g, w), (
                    f"{case} {what} level {k} output {i}: max gap "
                    f"{float((g - w).abs().max())} of "
                    f"{float(w.abs().max())}")
                assert float((g - p).abs().max()) <= rtol * float(
                    p.abs().max()), f"{case} {what} level {k} output {i}"


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CARD))
def test_fused_vcycle_matches_the_composed_one(dev, case, monkeypatch):
    """The V-cycle on the fused route against the composed one on the
    same levels, bit for bit, with its level-step launches exact."""
    nx, ny, split, holes = CARD[case]
    model, levels, fused_ops = _hierarchy(nx, ny, split, holes,
                                          torch.float32, dev)
    assert all(op.stencil is not None for op in fused_ops)
    b = _vector((nx, ny, 2), 1, torch.float32, dev) * levels[0].free
    before = _level_launches()
    z = mg._vcycle(fused_ops, levels, b, NU, COARSE)
    assert _since(before) == ls.cycle_launches(
        _lattice_levels(model, levels))
    _composed(monkeypatch)
    ops = mg._level_ops(model, levels)
    before = _level_launches()
    want = mg._vcycle(ops, levels, b, NU, COARSE)
    assert not any(_since(before).values())
    torch.cuda.synchronize()
    assert torch.equal(z, want), (
        f"max gap {float((z - want).abs().max())} of "
        f"{float(want.abs().max())}")


def _solve(model, levels, load, capture=True, monkeypatch=None):
    loaded = dataclasses.replace(model, tractions={"right": (load, 0.0)})
    g = levels[0].grid
    params = {"coords": g.coords, "u": torch.zeros_like(g.coords)}
    if not capture:
        monkeypatch.setattr(loop, "capturable", lambda device: False)
    sol, hist = pt.mg_pcg_solve(loaded, g, params, max_iters=40, tol=1e-6,
                                levels=levels)
    if not capture:
        monkeypatch.undo()
    return sol["u"], hist


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["129x65_zigzag_hole", "961x481_up"])
def test_fused_mg_pcg_matches_the_composed_solve(dev, case, monkeypatch):
    """A whole ``mg_pcg_solve`` on the fused route: bit-equal to the
    composed solve with the same iterations, captured equal to eager, a
    kept plan's later solves equal to a fresh hierarchy's, and its level
    steps' launches exact (a V-cycle for the start, a V-cycle and K p a
    call of the loop body)."""
    nx, ny, split, holes = CARD[case]
    model, levels, _ = _hierarchy(nx, ny, split, holes, torch.float32, dev)
    per_cycle = ls.cycle_launches(_lattice_levels(model, levels))
    before = _level_launches()
    u, hist = _solve(model, levels, 1e5)
    launched = _since(before)
    iters = int(torch.count_nonzero(hist))
    calls = min(math.ceil(iters / loop.READ_EVERY) * loop.READ_EVERY, 40)
    want = {k: (calls + 1) * v for k, v in per_cycle.items()}
    want["lattice_level_step"] += calls         # K p each call
    assert launched == want
    # a kept plan's second and third solves against a fresh hierarchy's
    for load in (5e4, 2e5):
        got = _solve(model, levels, load)
        _, fresh, _ = _hierarchy(nx, ny, split, holes, torch.float32, dev)
        want = _solve(model, fresh, load)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    # eager on the card
    _, eager_levels, _ = _hierarchy(nx, ny, split, holes, torch.float32, dev)
    eager = _solve(model, eager_levels, 1e5, capture=False,
                   monkeypatch=monkeypatch)
    assert torch.equal(eager[0], u) and torch.equal(eager[1], hist)
    # the composed solve on a hierarchy set up on the composed operators
    _composed(monkeypatch)
    _, composed_levels, _ = _hierarchy(nx, ny, split, holes, torch.float32,
                                       dev)
    for a, b in zip(levels, composed_levels):
        assert torch.equal(a.dinv, b.dinv) and a.lmax_host == b.lmax_host
    cu, chist = _solve(model, composed_levels, 1e5)
    torch.cuda.synchronize()
    assert int(torch.count_nonzero(chist)) == iters
    assert torch.equal(chist, hist) and torch.equal(cu, u), (
        f"max gap {float((cu - u).abs().max())} of {float(cu.abs().max())}")
