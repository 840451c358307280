"""The load-case solve on a structured grid: ``mg_pcg_solve(model, grid,
params, max_iters, tol, levels=levels)`` from rest, on a hierarchy built
once in set-up, each load case a ``StructuredGridP1`` with its own
traction on the loaded face.

Set-up: the grid arrays (``fembench/meshes``), the port's grid
(``convert.grid_from_numpy``), the hierarchy (``build_hierarchy``).  A
solve's answer is its solution and its residual history, read to the
host.

The check (``judge``), in float64 on the card: ``u_err``, the relative
L2 gap ||u - u_ref|| / ||u_ref|| between the solve's displacements and the
reference's solution of its own system (its stiffness and load, assembled
from the same arrays, solved by plain CG).  The residual of a float32
answer in float64 says little here: rounding u to float32 alone leaves a
relative residual near 1e-3 at this size, 1e3 times the solve's
tolerance.
"""

from __future__ import annotations

import types

import numpy as np
import torch
from torch.profiler import record_function

from .. import roofline, spec
from ..reference.cg import cg
from ..reference.grid_plate import grid_plate
from ..reference.precision import Precision, round_tf32


def grid_arrays(cfg: dict) -> dict:
    return spec.module("meshes", cfg["mesh"]["kind"]).arrays(cfg["mesh"])


def loaded_face(cfg: dict) -> str:
    (face,) = [f for f, c in cfg["mesh"]["boundaries"].items() if c == 2]
    return face


class Driver:
    def __init__(self, cfg: dict, mix: dict, device):
        self.cfg, self.mix, self.device = cfg, mix, device
        self.max_iters = int(mix["max_iters"])
        self.tol = float(mix["tol"])
        self.smooth = int(mix["nu"])
        self.coarse = int(mix["coarse_degree"])

    def setup(self, phases):
        with phases("library_load"):
            import hidenn_fem_tpu_torch as ht
            from hidenn_fem_tpu_torch.models.structured_grid import \
                StructuredGridP1
            from hidenn_fem_tpu_torch.ops import lattice_slab
            if self.device.type == "cuda":
                from hidenn_fem_tpu_torch.ops.cuda_build import build_kernels
                torch.zeros((), device=self.device)
                build_kernels()
        self.ht, self.ls, self.P1 = ht, lattice_slab, StructuredGridP1
        with phases("mesh_arrays"):
            arrays = grid_arrays(self.cfg)
        with phases("port_tables"):
            self.grid = ht.grid_from_numpy(types.SimpleNamespace(**arrays),
                                           device=self.device)
        mat = self.cfg["material"]
        self.E, self.nu = float(mat["E"]), float(mat["nu"])
        with phases("hierarchy"):
            model = StructuredGridP1(E=self.E, nu=self.nu)
            with torch.no_grad():
                coords = model.coords({"coords": self.grid.coords},
                                      self.grid)
            self.levels = ht.build_hierarchy(model, self.grid, coords)
        self.face = loaded_face(self.cfg)

    def solve(self, case):
        with record_function("fembench.load_case"):
            model = self.P1(E=self.E, nu=self.nu,
                            tractions={self.face: case["traction"]})
            params = {"coords": self.grid.coords,
                      "u": torch.zeros_like(self.grid.coords)}
        with record_function("fembench.entry"):
            sol, hist = self.ht.mg_pcg_solve(
                model, self.grid, params, max_iters=self.max_iters,
                tol=self.tol, nu=self.smooth, coarse_degree=self.coarse,
                levels=self.levels)
        with record_function("fembench.read_result"):
            hist = hist.cpu().numpy()
        return {"case": case, "hist": hist, "u": sol["u"]}

    def keep(self, out):
        return {"case": out["case"], "hist": out["hist"],
                "u": out["u"].cpu()}

    def program_readings(self, kept):
        pass

    def release(self):
        del self.grid, self.levels

    def counters(self) -> dict:
        return dict(self.ls.launch_counts)

    def steps(self, out) -> int:
        return 0

    def iterations(self, out) -> int:
        return int(np.count_nonzero(out["hist"]))

    def work(self, solves) -> dict:
        """Bytes of the stencil value-and-grads that ``solves`` need: per
        solve, the right-hand side's gradient and each level's gradient at
        zero; per iteration the fine operator and a V(nu, nu) cycle (each
        level above the coarsest 2 nu + 1 operators, the coarsest
        ``coarse_degree``).  Each level passes its quad mask as both
        triangle weights."""
        sizes = [(lv.grid.nx, lv.grid.ny) for lv in self.levels]
        per_op = [roofline.stencil_vg_bytes(nx, ny, 2) for nx, ny in sizes]
        per_iter = (per_op[0] + sum(per_op[:-1]) * (2 * self.smooth + 1)
                    + per_op[-1] * self.coarse)
        per_solve = per_op[0] + sum(per_op)
        return {"lattice_vg": sum(per_solve + self.iterations(o) * per_iter
                                  for o in solves)}


def reference(cfg: dict, traction, prec: Precision, device):
    mat = cfg["material"]
    return grid_plate(grid_arrays(cfg), float(mat["E"]), float(mat["nu"]),
                      traction, prec=prec, device=device)


def solutions(cfg: dict, mix: dict, tractions: list, prec: Precision,
              device) -> list:
    """The reference's displacements [N, 2] for each traction: the
    system is linear in the traction, so two solves (unit tractions along
    x and y, by plain CG in float64 to ``reference_tol``) give every load
    case.  Under "tf32" the system is the one computed in TF32 (its
    element matrices' products on TF32 operands, its stiffness and load
    rounded to TF32), and CG solves it in float64: the answer that a
    sound solve of the TF32 system would give."""
    basis = []
    for unit in ((1.0, 0.0), (0.0, 1.0)):
        ref = reference(cfg, unit, prec, device)
        K, f, free = ref.stiffness()
        if prec.name == "tf32":
            f = round_tf32(f)
        K, f = K.to(torch.float64), f.to(torch.float64)
        u, _ = cg(lambda v: (K @ v[:, None])[:, 0], f,
                  float(mix["reference_tol"]), int(mix["reference_cg_iters"]))
        full = torch.zeros(free.shape, dtype=u.dtype, device=device)
        full[free] = u
        basis.append(full.view(-1, 2))
        del K
    return [t[0] * basis[0] + t[1] * basis[1] for t in tractions]


def _error(u: torch.Tensor, want: torch.Tensor) -> float:
    want = want.double().cpu()
    return float(torch.linalg.vector_norm(u.double().cpu().reshape(-1, 2)
                                          - want)
                 / torch.linalg.vector_norm(want))


def judge(cfg: dict, mix: dict, kept: list, device) -> list:
    want = solutions(cfg, mix, [k["case"]["traction"] for k in kept],
                     Precision("float64"), device)
    return [{"u_err": _error(k["u"], w)} for k, w in zip(kept, want)]


def control(cfg: dict, mix: dict, kept: list, device) -> list:
    """``kept`` with each solution replaced by the reference's solution
    of the TF32 system (``solutions``)."""
    got = solutions(cfg, mix, [k["case"]["traction"] for k in kept],
                    Precision("tf32"), device)
    return [dict(k, u=u.cpu()) for k, u in zip(kept, got)]
