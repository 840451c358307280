"""The ``delaunay_898k`` cells' parts on the CPU: the frozen mesh recipe
against the port's generator, K4's byte count against a hand count, and
both cells run whole at a small size (lc 0.05, ~1,700 elements, the
banded tables built as the full plate gets them) through
``harness.run_cell``: sound, they come out correct and the TF32 control
does not; with the solve broken underneath, they come out not correct.

Faults planted in the port, in this process only:
* aux-space PCG: the matvec off by a factor, the preconditioner without
  its coarse term (the background V-cycle), the iteration's answer
  dropped, the solution altered where it is produced;
* L-BFGS on the banded route: ``test_fembench_faults``'s plants (a step
  that leaves its state unchanged, from the first step and after the
  twelfth, and an altered gradient entry), and half of the banded tables'
  rows left out and the rest counted double.

Run: ``python -m pytest fembench/tests -q``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import test_fembench_faults as faults
from fembench import banded_bytes, control, harness, spec
from fembench.meshes import delaunay_holes

CPU = torch.device("cpu")
BENCH = spec.benchmark()
AUX = "delaunay_898k.aux_loadcases"
LBFGS = "delaunay_898k.lbfgs_m100"
SMALL = {"lc": 0.05}
HOLES = [[0.5, 0.7, 0.12], [1.0, 0.3, 0.15], [1.4, 0.6, 0.1]]


def mesh_cfg(lc):
    return dict(spec.config(BENCH, "delaunay_898k")["mesh"], lc=lc)


def run(workload, seed=2 ** 31 + 13):
    return harness.run_cell(BENCH, workload, seed, 0.0, False, CPU,
                            overrides=SMALL)


@pytest.mark.parametrize("lc", [0.1, 0.05])
def test_recipe_matches_the_port(lc, monkeypatch):
    import hidenn_fem_tpu_torch as ht
    monkeypatch.setenv("HDNN_NO_NATIVE", "1")
    a = delaunay_holes.arrays(mesh_cfg(lc))
    m = ht.generate_mesh_delaunay(holes=[tuple(h) for h in HOLES], lc=lc,
                                  device=CPU)
    assert set(a) == {"coords", "connectivity", "geom_boundary_mask",
                      "dirichlet_mask", "neumann_mask", "neumann_edges"}
    for k, v in a.items():
        assert np.array_equal(v, getattr(m, k).numpy()), k


def test_the_configuration_states_the_full_plate():
    cfg = spec.config(BENCH, "delaunay_898k")
    assert cfg["mesh"]["kind"] == "delaunay_holes"
    assert cfg["mesh"]["lc"] == 0.00218 and cfg["reduced"] == []
    assert cfg["mesh"]["holes"] == HOLES
    assert cfg["material"] == {"E": 1.0e10, "nu": 0.3}
    assert "lc" in cfg["assumed"]


def test_k4_bytes_by_hand():
    """n = 10 nodes: node table read and gradient written (2 x 10 x 16),
    int32 tables 2 + 2*3*4 + 2 + 2 + 2*5*6 = 90 entries, the energy."""
    shapes = {"re_nstarts": (2,), "re_conn_rel": (2, 3, 4),
              "re_own_lo": (2,), "re_own_hi": (2,), "re_inc_rel": (2, 5, 6)}
    assert banded_bytes.banded_vg_bytes(10, shapes) == 320 + 360 + 4


def test_k4_bytes_count_the_paired_tables():
    """The count of ``chip_smoke.py``'s kernel table, from the tables."""
    import hidenn_fem_tpu_torch as ht
    a = delaunay_holes.arrays(mesh_cfg(0.05))
    ba = ht.TriMesh.from_arrays(**a, build_banded=True,
                                device=CPU).banded_paired
    n = a["coords"].shape[0]
    want = (2 * 16 * n + 4 * (ba.re_nstarts.numel() + ba.re_conn_rel.numel())
            + 4 * (ba.re_own_lo.numel() + ba.re_own_hi.numel())
            + 4 * ba.re_inc_rel.numel() + 4)
    assert banded_bytes.banded_vg_bytes(n, banded_bytes.shapes_of(ba)) \
        == want


@pytest.mark.parametrize("workload", [AUX, LBFGS])
def test_the_port_passes_and_the_control_fails(workload):
    limits = spec.limits(workload)
    (line,) = control.readings(workload, [2 ** 31 + 5], 1, CPU,
                               overrides=SMALL)
    assert all(v <= limits[k]["limit"] for k, v in line["program"].items())
    assert any(v > limits[k]["limit"] for k, v in line["control"].items())


@pytest.mark.parametrize("workload", [AUX, LBFGS])
def test_an_unbroken_solve_is_correct(workload):
    r = run(workload)
    assert r["correct"] is True and r["failed"] == 0
    assert r["checked_solves"] >= 1


# -- aux-space PCG
def _matvec_off(monkeypatch, workload):
    """Each matvec 1.5 K v: the answer a third too small."""
    from hidenn_fem_tpu_torch.solve import auxspace
    pcg = auxspace._pcg

    def off(matvec, *args, **kw):
        def scaled(v):
            return {k: 1.5 * w for k, w in matvec(v).items()}
        return pcg(scaled, *args, **kw)
    monkeypatch.setattr(auxspace, "_pcg", off)


def _no_coarse_term(monkeypatch, workload):
    """The preconditioner's diagonal term alone: Jacobi-PCG, which does
    not reach the tolerance within ``max_iters``."""
    from hidenn_fem_tpu_torch.solve import auxspace

    def jacobi(bg_model, pre, r, ops=None):
        return pre.free * (pre.omega * pre.dinv * r)
    monkeypatch.setattr(auxspace, "_apply_aux", jacobi)


def _unchanged_iteration(monkeypatch, workload):
    from hidenn_fem_tpu_torch.solve import auxspace
    pcg = auxspace._pcg

    def frozen(*args, **kw):
        x, hist = pcg(*args, **kw)
        return {k: torch.zeros_like(v) for k, v in x.items()}, hist
    monkeypatch.setattr(auxspace, "_pcg", frozen)


def _altered_solution(monkeypatch, workload):
    from hidenn_fem_tpu_torch.solve import auxspace
    solve = auxspace._aux_pcg

    def altered(*args, **kw):
        sol, hist = solve(*args, **kw)
        u = sol["u"].clone().reshape(-1)
        i = int(torch.argmax(u.abs()))
        u[i] = 2.0 * u[i]
        return dict(sol, u=u.view(sol["u"].shape)), hist
    monkeypatch.setattr(auxspace, "_aux_pcg", altered)


# -- L-BFGS on the banded route
def _half_tables(monkeypatch, workload):
    """The upper half of the recompute tables' node blocks see rows of one
    node (zero energy and cotangent), and the energy is doubled."""
    from hidenn_fem_tpu_torch.ops import banded_energy
    energy = banded_energy.banded_element_energy

    def doubled(node, ba, E, nu, w_sum, row_start=None):
        rel = ba.re_conn_rel.clone()
        rel[rel.shape[0] // 2:] = rel[rel.shape[0] // 2:, :, :1]
        half = dataclasses.replace(ba, re_conn_rel=rel)
        return 2.0 * energy(node, half, E, nu, w_sum, row_start)
    monkeypatch.setattr(banded_energy, "banded_element_energy", doubled)


FAULTS = ([(AUX, f) for f in (_matvec_off, _no_coarse_term,
                              _unchanged_iteration, _altered_solution)]
          + [(LBFGS, f) for f in (faults._unchanged_step(1),
                                  faults._unchanged_step(13),
                                  faults._altered_gradient, _half_tables)])


@pytest.mark.parametrize("workload,fault", FAULTS,
                         ids=[f"{w}-{f.__name__.lstrip('_')}"
                              for w, f in FAULTS])
def test_a_broken_solve_is_not_correct(workload, fault, monkeypatch):
    fault(monkeypatch, workload)
    r = run(workload)
    assert r["correct"] is False and r["failed"] >= 1
