"""The load-case solve on an unstructured mesh: ``aux_pcg_solve(loss,
{"u": 0}, (coords, mesh), pre=pre, bg_model=..., max_iters, tol)`` from
rest, on an auxiliary-space preconditioner built once in set-up
(``build_aux_preconditioner``: the background lattice and its multigrid
hierarchy, the transfer tables and the exact Jacobi diagonal), each load
case the plane-stress energy under a traction of its magnitude on the
loaded edge, along +x (a traction along another direction needs a custom
traction callable, which takes the energy off the kernel route).  Each
matvec is a value-and-grad on the banded route (K4), each preconditioner
application a V-cycle on the background (K6).  This is example 11's
workflow with the preconditioner kept for many load cases.

Set-up: the mesh arrays (``fembench/meshes``, built once a process and
shared with the check), the port's tables (asserted to take the banded
route on the paired tables), the preconditioner (timed as the
``hierarchy`` phase).  A solve's answer is its solution and its residual
history, read to the host.

The check (``judge``), in float64 on the card: ``u_err``, the relative
L2 gap ||u - u_ref|| / ||u_ref|| between the solve's displacements and the
reference's solution of its own system (its stiffness and load assembled
from the same arrays, solved by plain CG on the Jacobi-scaled system).
The system is linear in the resultant and its direction is fixed, so one
reference solve, scaled, serves every load case.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

from ..harness import log
from ..reference.cg import cg
from ..reference.p1_plate import P1Plate
from ..reference.precision import Precision, round_tf32
from .lbfgs_banded import banded_mesh, build_libraries, k4_bytes, \
    mesh_arrays
from .mg_pcg import _error

# the reference example's load, for the preconditioner's set-up: the
# Jacobi diagonal and the hierarchy depend on the stiffness alone
SETUP_LOAD_N = 100e3


class Driver:
    def __init__(self, cfg: dict, mix: dict, device):
        self.cfg, self.mix, self.device = cfg, mix, device
        if [float(a) for a in mix["load"]["angle_deg"]] != [0.0, 0.0]:
            raise ValueError("the energy's kernel route takes a traction "
                             "along +x only")
        self.max_iters = int(mix["max_iters"])
        self.tol = float(mix["tol"])

    def setup(self, phases):
        with phases("library_load"):
            import hidenn_fem_tpu_torch as ht
            from hidenn_fem_tpu_torch.models.structured_grid import \
                StructuredGridP1
            from hidenn_fem_tpu_torch.ops import banded_energy
            build_libraries(self.device)
        self.ht, self.be = ht, banded_energy
        with phases("mesh_arrays"):
            arrays = mesh_arrays(self.cfg)
        with phases("port_tables"):
            self.mesh = banded_mesh(ht, arrays, self.device)
        self.k4_bytes = k4_bytes(self.mesh)
        mat = self.cfg["material"]
        self.E, self.nu = float(mat["E"]), float(mat["nu"])
        self.model = ht.TriangleP1()
        self.bg = StructuredGridP1(E=self.E, nu=self.nu)
        self.args = (self.mesh.coords, self.mesh)
        with phases("hierarchy"):
            self.pre = ht.build_aux_preconditioner(
                self.loss(SETUP_LOAD_N), self.rest(), self.args, self.mesh,
                bg_model=self.bg)

    def rest(self) -> dict:
        return {"u": torch.zeros((self.mesh.n_nodes, 2), device=self.device)}

    def loss(self, magnitude: float):
        energy = self.ht.PlaneStressEnergy(
            model=self.model, E=self.E, nu=self.nu, F_total=magnitude,
            traction_length=1.0)

        def u_loss(p, coords, mesh):
            return energy.total({"coords": coords, "u": p["u"]}, mesh)
        return u_loss

    def solve(self, case):
        before = self.be.launch_counts["banded_vg"]
        with record_function("fembench.load_case"):
            loss, params = self.loss(case["magnitude"]), self.rest()
        with record_function("fembench.entry"):
            sol, hist = self.ht.aux_pcg_solve(
                loss, params, self.args, pre=self.pre, bg_model=self.bg,
                max_iters=self.max_iters, tol=self.tol)
        with record_function("fembench.read_result"):
            hist = hist.cpu().numpy()
        return {"case": case, "hist": hist, "u": sol["u"],
                "banded_vg": self.be.launch_counts["banded_vg"] - before}

    def keep(self, out):
        return {"case": out["case"], "hist": out["hist"],
                "u": out["u"].cpu()}

    def program_readings(self, kept):
        pass

    def release(self):
        del self.mesh, self.pre, self.args

    def counters(self) -> dict:
        return dict(self.be.launch_counts)

    def steps(self, out) -> int:
        return 0

    def iterations(self, out) -> int:
        return int(np.count_nonzero(out["hist"]))

    def work(self, solves) -> dict:
        """Bytes of the K4 launches the solves made (a matvec an
        iteration, the right-hand side's gradient, the loop's masked
        calls past the stop)."""
        return {"banded_vg": self.k4_bytes * sum(o["banded_vg"]
                                                 for o in solves)}


def solution(cfg: dict, mix: dict, prec: Precision, device) -> torch.Tensor:
    """The reference's displacements [N, 2] under a unit resultant along
    +x: plain CG on the Jacobi-scaled system S K S y = S f (S = diag(K)^-1/2,
    u = S y) in float64 to ``reference_tol``.  Under "tf32" the system is
    the one computed in TF32 (its element matrices' products on TF32
    operands, its stiffness and load rounded to TF32), and CG solves it in
    float64: the answer a sound solve of the TF32 system would give."""
    a = mesh_arrays(cfg)
    mat = cfg["material"]
    ref = P1Plate(a["coords"], a["connectivity"], a["geom_boundary_mask"],
                  a["dirichlet_mask"], a["neumann_edges"], float(mat["E"]),
                  float(mat["nu"]), traction=(1.0, 0.0), prec=prec,
                  device=device)
    K, f, free = ref.stiffness()
    if prec.name == "tf32":
        f = round_tf32(f)
    K, f = K.to(torch.float64), f.to(torch.float64)
    coo = K.to_sparse_coo()
    i, j = coo.indices()
    on = i == j
    d = torch.zeros_like(f).index_add_(0, i[on], coo.values()[on])
    s = 1.0 / torch.sqrt(d)
    del coo
    y, iters = cg(lambda v: s * (K @ (s * v)[:, None])[:, 0], s * f,
                  float(mix["reference_tol"]),
                  int(mix["reference_cg_iters"]))
    log(f"reference ({prec.name}): {iters} CG iterations")
    full = torch.zeros(free.shape, dtype=y.dtype, device=device)
    full[free] = s * y
    return full.view(-1, 2)


def _judged(cfg, mix, kept, prec, device) -> list:
    t0 = time.perf_counter()
    unit = solution(cfg, mix, prec, device)
    out = [k["case"]["magnitude"] * unit for k in kept]
    log(f"reference ({prec.name}) for {len(kept)} solves in "
        f"{time.perf_counter() - t0:.2f} s")
    return out


def judge(cfg: dict, mix: dict, kept: list, device) -> list:
    want = _judged(cfg, mix, kept, Precision("float64"), device)
    return [{"u_err": _error(k["u"], w)} for k, w in zip(kept, want)]


def control(cfg: dict, mix: dict, kept: list, device) -> list:
    """``kept`` with each solution replaced by the reference's solution
    of the TF32 system (``solution``)."""
    got = _judged(cfg, mix, kept, Precision("tf32"), device)
    return [dict(k, u=u.cpu()) for k, u in zip(kept, got)]
