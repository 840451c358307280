"""The ``hybrid_847k`` cell's parts on the CPU, at a small size (lc 0.05,
~1,500 elements, on its own 41x21 background of three levels): the cell
run whole through ``harness.run_cell``, which comes out correct, and
with the solve broken underneath, not correct; the control (the system
computed in TF32, solved directly) reads above the cell's limit where
the port reads below it.  The frozen mesh recipe is held to the port's
generator in ``tests/test_torch_hybrid_reference.py``.

Faults planted in the port, in this process only:
* the collar's energy dropped from the hybrid route (the rim points and
  the staircase's links to them carry no stiffness);
* the collar's energy halved (a stiffness wrong only around the holes);
* each matvec 1.5 K v, planted in ``auxspace._system`` (the kept plan
  runs the matvec it was made with, so a plant around the loop would not
  reach it).

Run: ``python -m pytest fembench/tests/test_fembench_hybrid.py -q``.
"""

from __future__ import annotations

import pytest
import torch

from fembench import control, harness, spec

CPU = torch.device("cpu")
BENCH = spec.benchmark()
CELL = "hybrid_847k.aux_pcg"
SMALL = {"lc": 0.05, "aux_background": {"shape": [41, 21], "levels": 3}}


def run(seed=2 ** 31 + 13):
    return harness.run_cell(BENCH, CELL, seed, 0.0, False, CPU,
                            overrides=SMALL)


def test_the_configuration_states_the_full_plate():
    cfg = spec.config(BENCH, "hybrid_847k")
    assert cfg["mesh"]["kind"] == "hybrid_holes"
    assert cfg["mesh"]["lc"] == 0.00209 and cfg["reduced"] == []
    assert cfg["mesh"]["variant"] == "up" and cfg["mesh"]["clear"] == 0.6
    assert cfg["material"] == {"E": 1.0e10, "nu": 0.3}
    assert cfg["mesh"]["aux_background"] == {"shape": [961, 481],
                                             "levels": 6}
    assert "lc" in cfg["assumed"]


def test_another_background_is_refused():
    with pytest.raises(RuntimeError, match="not 'reshape'"):
        harness.run_cell(BENCH, CELL, 7, 0.0, False, CPU,
                         overrides=dict(SMALL, aux_background={
                             "shape": [961, 481], "levels": 6}))


def test_the_control_reads_above_the_limit():
    limit = spec.limits(CELL)["u_err"]["limit"]
    (r,) = control.readings(CELL, [2 ** 31 + 5], 1, CPU, overrides=SMALL)
    assert r["program"]["u_err"] < limit < r["control"]["u_err"]


def test_an_unbroken_solve_is_correct():
    r = run()
    assert r["correct"] is True and r["failed"] == 0
    assert r["checked_solves"] >= 1


def _collar_dropped(monkeypatch):
    from hidenn_fem_tpu_torch.ops import losses

    def none(node, *args, **kw):
        return node.new_zeros(())
    monkeypatch.setattr(losses, "collar_energy", none)


def _collar_halved(monkeypatch):
    from hidenn_fem_tpu_torch.ops import losses
    collar = losses.collar_energy

    def half(*args, **kw):
        return 0.5 * collar(*args, **kw)
    monkeypatch.setattr(losses, "collar_energy", half)


def _matvec_off(monkeypatch):
    from hidenn_fem_tpu_torch.solve import auxspace
    system = auxspace._system

    def off(*args, **kw):
        matvec, precond, dot = system(*args, **kw)

        def scaled(v):
            return {k: 1.5 * w for k, w in matvec(v).items()}
        return scaled, precond, dot
    monkeypatch.setattr(auxspace, "_system", off)


FAULTS = (_collar_dropped, _collar_halved, _matvec_off)


@pytest.mark.parametrize("fault", FAULTS,
                         ids=[f.__name__.lstrip("_") for f in FAULTS])
def test_a_broken_solve_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    r = run()
    assert r["correct"] is False and r["failed"] >= 1
