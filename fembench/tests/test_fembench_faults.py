"""The comparison that decides ``correct`` has to fail what it is there to
catch, at sizes a CPU test run can hold and, where only the cell's own
size shows a fault, on the card:

* the control: the plain reference in the solver's place, in TF32 (the
  precision below the configurations' float32 with TF32 off), fails at
  least one of each cell's limits, while the port's solves pass all;
* a run of each cell with the solve broken underneath comes out not
  correct: a step or iteration that leaves its state unchanged (L-BFGS:
  from the first step and after the twelfth), half of the elements left
  out and the rest counted double, an answer altered where it is
  produced; and, on the card at the L-BFGS cells' own size, a step that
  leaves its state unchanged and the history's pass over half of its
  rows, each after the twelfth step and after the history has wrapped.
  (No cell spans cards, so none can leave out an exchange between
  them.)

The harness's look for a card is skipped (``harness.run_cell`` on the
CPU, or in this process on the card).  The card tests are marked
``cuda``: ``python -m pytest -m cuda fembench/tests``.
"""

from __future__ import annotations

import dataclasses
import subprocess
import sys

import pytest
import torch

from fembench import control, harness, spec

CPU = torch.device("cpu")
BENCH = spec.benchmark()
SMALL = {"plate3h_922k": {"nx": 41, "ny": 21},
         "grid_961x481": {"nx": 33, "ny": 17}}
LBFGS = ["plate3h_922k.lbfgs_m100", "plate3h_922k.lbfgs_m10"]
MG = ["grid_961x481.mg_loadcases"]


def small(workload):
    return SMALL[spec.workload(BENCH, workload)["config"]]


def run(workload, seed=2 ** 31 + 11):
    return harness.run_cell(BENCH, workload, seed, 0.0, False, CPU,
                            overrides=small(workload))


@pytest.mark.parametrize("workload", LBFGS + MG)
def test_the_port_passes_and_the_control_fails(workload):
    limits = spec.limits(workload)
    (line,) = control.readings(workload, [2 ** 31 + 5], 1, CPU,
                               overrides=small(workload))
    assert all(v <= limits[k]["limit"] for k, v in line["program"].items())
    assert any(v > limits[k]["limit"] for k, v in line["control"].items())


# -- faults planted in the port, in this process only.  An L-BFGS fault
# acts from a given step on: the first, the thirteenth, or the twelfth
# after the history has wrapped (its m + 1st pair overwrote the first).
# It reads the optimizer's device count, so a captured step replays it.
def _after(start):
    """The first step (the optimizer's count) at which a fault acts."""
    def first(workload):
        if start != "wrap":
            return start
        mix = spec.traffic(spec.workload(BENCH, workload)["traffic"])
        return int(mix["memory_size"]) + 12
    return first


def _unchanged_step(start):
    def plant(monkeypatch, workload):
        from hidenn_fem_tpu_torch.solve import drivers
        first = _after(start)(workload)

        def frozen(vg, optimizer, leaf, state):
            loss, g = vg(leaf)
            x = leaf.detach()
            moves = (state.device_count < first).to(x.dtype)
            step, state = optimizer.update(g, state, x)
            x.add_(moves * step)        # x no longer moves
            return loss, g, state
        monkeypatch.setattr(drivers, "_step", frozen)
    plant.__name__ = f"_unchanged_step_from_{start}"
    return plant


def _half_history_pass(start):
    """The history's dots pass over half of its rows: the pairs in the
    upper half of the ring read as zero."""
    def plant(monkeypatch, workload):
        from hidenn_fem_tpu_torch.solve import optimizers
        update, dots = optimizers.CompactLBFGS.update, optimizers.history_dots
        first, on = _after(start)(workload), [None]

        def counted(self, g, state, x):
            on[0] = state.device_count >= first
            return update(self, g, state, x)

        def half(SY, y, s, g):
            B = dots(SY, y, s, g)
            m = SY.shape[0] // 2
            keep = torch.ones_like(B)
            keep[m // 2:m] = 0.0
            keep[m + m // 2:] = 0.0
            return torch.where(on[0], keep * B, B)
        monkeypatch.setattr(optimizers.CompactLBFGS, "update", counted)
        monkeypatch.setattr(optimizers, "history_dots", half)
    plant.__name__ = f"_half_history_pass_from_{start}"
    return plant


def _unchanged_iteration(monkeypatch, workload):
    from hidenn_fem_tpu_torch.solve import multigrid
    pcg = multigrid._pcg

    def frozen(*args, **kw):
        x, hist = pcg(*args, **kw)
        return {k: torch.zeros_like(v) for k, v in x.items()}, hist
    monkeypatch.setattr(multigrid, "_pcg", frozen)


def _half(t):
    """Quad weights with the upper half of the quad rows left out."""
    t = t.clone()
    t[t.shape[0] // 2:] = 0.0
    return t


def _half_elements_plate(monkeypatch, workload):
    from hidenn_fem_tpu_torch.ops import losses
    total = losses.lattice_total

    def doubled(node, route, E, nu, w_sum, t_x, t_y=0.0):
        half = dataclasses.replace(route, t1=_half(route.t1),
                                   t2=_half(route.t2), all_present=False)
        none = dataclasses.replace(route, t1=0.0 * route.t1,
                                   t2=0.0 * route.t2, all_present=False)
        # 2 (domain over half) - edge work
        return (2.0 * total(node, half, E, nu, w_sum, t_x, t_y)
                - total(node, none, E, nu, w_sum, t_x, t_y))
    monkeypatch.setattr(losses, "lattice_total", doubled)


def _half_elements_grid(monkeypatch, workload):
    from hidenn_fem_tpu_torch.models import structured_grid
    from hidenn_fem_tpu_torch.solve import multigrid
    fwd, vg = (structured_grid.lattice_stencil_fwd_plain,
               multigrid.lattice_stencil_vg_plain)

    def fwd2(node, nx, ny, E, nu, w_sum, **kw):
        kw = dict(kw, t1=_half(kw["t1"]), t2=_half(kw["t2"]))
        return 2.0 * fwd(node, nx, ny, E, nu, w_sum, **kw)

    def vg2(node, nx, ny, E, nu, w_sum, **kw):
        kw = dict(kw, t1=_half(kw["t1"]), t2=_half(kw["t2"]))
        e, g = vg(node, nx, ny, E, nu, w_sum, **kw)
        return 2.0 * e, 2.0 * g
    monkeypatch.setattr(structured_grid, "lattice_stencil_fwd_plain", fwd2)
    monkeypatch.setattr(multigrid, "lattice_stencil_vg_plain", vg2)


def _altered_gradient(monkeypatch, workload):
    """The energy route's gradient, one free entry doubled."""
    from hidenn_fem_tpu_torch.solve import drivers
    make = drivers._value_and_grad

    def altered(loss_fn, like, loss_args):
        vg = make(loss_fn, like, loss_args)

        def out(x):
            loss, g = vg(x)
            g = g.clone()
            i = int(torch.argmax(g.abs()))
            g[i] = 2.0 * g[i]
            return loss, g
        return out
    monkeypatch.setattr(drivers, "_value_and_grad", altered)


def _altered_solution(monkeypatch, workload):
    """The solution, its largest entry doubled."""
    from hidenn_fem_tpu_torch.solve import multigrid
    solve = multigrid._mg_pcg

    def altered(*args, **kw):
        sol, hist = solve(*args, **kw)
        u = sol["u"].clone().reshape(-1)
        i = int(torch.argmax(u.abs()))
        u[i] = 2.0 * u[i]
        return dict(sol, u=u.view(sol["u"].shape)), hist
    monkeypatch.setattr(multigrid, "_mg_pcg", altered)


FAULTS = ([(w, f) for w in LBFGS for f in (_unchanged_step(1),
                                           _unchanged_step(13),
                                           _half_elements_plate,
                                           _altered_gradient)]
          + [(w, f) for w in MG for f in (_unchanged_iteration,
                                          _half_elements_grid,
                                          _altered_solution)])


@pytest.mark.parametrize("workload,fault", FAULTS,
                         ids=[f"{w}-{f.__name__[1:]}" for w, f in FAULTS])
def test_a_broken_solve_is_not_correct(workload, fault, monkeypatch):
    fault(monkeypatch, workload)
    r = run(workload)
    assert r["correct"] is False and r["failed"] >= 1


@pytest.mark.parametrize("workload", LBFGS + MG)
def test_an_unbroken_solve_is_correct(workload):
    r = run(workload)
    assert r["correct"] is True and r["failed"] == 0


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_a_cell_runs_on_the_card(card):
    out = subprocess.run(
        [sys.executable, "-m", "fembench.run", "--workload", MG[0],
         "--seed", "7", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=spec.ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    assert '"correct": true' in out.stdout.splitlines()[-1]


# The history's later passes, at the cells' own size: a small plate
# converges within the solve, so a fault after its first steps would leave
# its last loss where a sound solve's is; the full plate does not.
CARD_FAULTS = [(w, f) for w in LBFGS
               for f in (_unchanged_step(13), _unchanged_step("wrap"),
                         _half_history_pass(13), _half_history_pass("wrap"))]


@pytest.mark.cuda
@pytest.mark.parametrize("workload,fault", CARD_FAULTS,
                         ids=[f"{w}-{f.__name__[1:]}" for w, f in CARD_FAULTS])
def test_a_later_fault_at_full_size_is_not_correct(card, workload, fault,
                                                   monkeypatch):
    fault(monkeypatch, workload)
    r = harness.run_cell(BENCH, workload, 2 ** 31 + 17, 0.0, False,
                         torch.device("cuda", 0))
    assert r["correct"] is False and r["failed"] >= 1
