"""The load-case solve of ``aux_pcg`` on a hybrid lattice+collar mesh:
``aux_pcg_solve(loss, {"u": 0}, (coords, mesh), pre=pre, bg_model=...,
max_iters, tol)`` from rest, on an auxiliary-space preconditioner built
once in set-up, each load case the plane-stress energy under a traction
of its magnitude on the loaded edge, along +x.  Each matvec is a
value-and-grad on the hybrid route (``ops/losses.py``'s
``_hybrid_total``: the plain torch lattice route on the node-table
prefix and the collar's gather, no kernel of the port), each
preconditioner application a V-cycle on the lattice-aligned background
(kind "reshape": P^T a reshape and a zero pad, P a slice, the rim points
on their own small tables; the level kernels).  This is example 12's
workflow with the preconditioner kept for many load cases.

Set-up: the mesh arrays (``fembench/meshes/hybrid_holes.py``, built once
a process and shared with the check), the port's mesh by
``hybrid_mesh_from_arrays`` (asserted to carry the hybrid route and no
other), the preconditioner (timed as the ``hierarchy`` phase; asserted
to be the lattice-aligned kind with rim tables on the background the
configuration's ``mesh.aux_background`` states: at full size 961x481 of
six levels, as the JAX package builds it, ``chip_smoke.py``
``JAX_AUX_SETUP["hybrid"]``).  A solve's answer is its solution and its
residual history, read to the host.

The check (``judge``) is ``aux_pcg``'s: ``u_err`` against the
reference's float64 solution of the system it assembles from the same
arrays.  The control (``control``) solves the system computed in TF32
directly: Jacobi-scaled CG, ``aux_pcg``'s control, stops at its cap on
that system, which TF32's products leave unsymmetric.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

from ..harness import log
from ..reference.p1_plate import P1Plate
from ..reference.precision import Precision, round_tf32
from . import aux_pcg
from .aux_pcg import judge  # noqa: F401
from .lbfgs_banded import build_libraries, mesh_arrays

SIX = ("coords", "connectivity", "geom_boundary_mask", "dirichlet_mask",
       "neumann_mask", "neumann_edges")


class Driver(aux_pcg.Driver):
    def setup(self, phases):
        with phases("library_load"):
            import hidenn_fem_tpu_torch as ht
            from hidenn_fem_tpu_torch import hybrid_mesh_from_arrays
            from hidenn_fem_tpu_torch.models.structured_grid import \
                StructuredGridP1
            from hidenn_fem_tpu_torch.ops import lattice_slab, losses
            build_libraries(self.device)
        self.ht, self.ls, self.losses = ht, lattice_slab, losses
        with phases("mesh_arrays"):
            a = mesh_arrays(self.cfg)
        with phases("port_tables"):
            self.mesh = hybrid_mesh_from_arrays(
                **{k: a[k] for k in SIX}, nx=a["nx"], ny=a["ny"],
                variant=a["variant"], device=self.device)
        m = self.mesh
        if m.hybrid is None or any(t is not None for t in (
                m.lattice, m.banded, m.banded_paired)):
            raise RuntimeError("the mesh does not take the hybrid route "
                               "alone")
        mat = self.cfg["material"]
        self.E, self.nu = float(mat["E"]), float(mat["nu"])
        self.model = ht.TriangleP1()
        self.bg = StructuredGridP1(E=self.E, nu=self.nu)
        self.args = (m.coords, m)
        with phases("hierarchy"):
            self.pre = ht.build_aux_preconditioner(
                self.loss(aux_pcg.SETUP_LOAD_N), self.rest(), self.args, m,
                bg_model=self.bg)
        pre = self.pre
        got = ((pre.grid.nx, pre.grid.ny), len(pre.levels))
        bg = self.cfg["mesh"]["aux_background"]
        want = (tuple(bg["shape"]), bg["levels"])
        if pre.lat_kind != "reshape" or pre.rim_corners is None \
                or got != want:
            raise RuntimeError(
                f"the preconditioner is {pre.lat_kind!r} with rim tables "
                f"{pre.rim_corners is not None} on {got}, not 'reshape' "
                f"with rim tables on {want}")

    def solve(self, case):
        with record_function("fembench.load_case"):
            loss, params = self.loss(case["magnitude"]), self.rest()
        with record_function("fembench.entry"):
            sol, hist = self.ht.aux_pcg_solve(
                loss, params, self.args, pre=self.pre, bg_model=self.bg,
                max_iters=self.max_iters, tol=self.tol)
        with record_function("fembench.read_result"):
            hist = hist.cpu().numpy()
        return {"case": case, "hist": hist, "u": sol["u"]}

    def counters(self) -> dict:
        """The level kernels' launches and the hybrid route's energies."""
        return dict(self.ls.launch_counts, **self.losses.route_counts)

    def iterations(self, out) -> int:
        return int(np.count_nonzero(out["hist"]))

    def work(self, solves) -> dict:
        return {}


def tf32_direct(cfg: dict, device) -> torch.Tensor:
    """The reference's displacements [N, 2] under a unit resultant along
    +x on the system computed in TF32 (``aux_pcg.solution``'s: its element
    matrices' products on TF32 operands, its stiffness and load rounded to
    TF32), solved by a sparse LU in float64 on the host (SuperLU): the
    answer of that system, where CG, which needs a symmetric matrix,
    stalls.  Logs the system's asymmetry, the solve's residual and the
    signs of the pivots of its symmetric part's LDL^T (all positive: the
    stiffness stays positive definite)."""
    import scipy.sparse as sp
    from scipy.sparse.linalg import splu
    t0 = time.perf_counter()
    a = mesh_arrays(cfg)
    mat = cfg["material"]
    ref = P1Plate(a["coords"], a["connectivity"], a["geom_boundary_mask"],
                  a["dirichlet_mask"], a["neumann_edges"], float(mat["E"]),
                  float(mat["nu"]), traction=(1.0, 0.0),
                  prec=Precision("tf32"), device=device)
    K, f, free = ref.stiffness()
    coo = K.to(torch.float64).to_sparse_coo().coalesce()
    i, j = coo.indices().cpu().numpy()
    A = sp.csc_matrix((coo.values().cpu().numpy(), (i, j)), shape=K.shape)
    b = round_tf32(f).double().cpu().numpy()
    del K, coo
    y = splu(A, permc_spec="MMD_AT_PLUS_A").solve(b)
    relres = np.linalg.norm(A @ y - b) / np.linalg.norm(b)
    asym = sp.linalg.norm(A - A.T) / sp.linalg.norm(A)
    # no pivoting and one ordering of rows and columns: U's diagonal is
    # the D of LDL^T, whose signs are the eigenvalues' (Sylvester)
    sym = splu(((A + A.T) * 0.5).tocsc(), permc_spec="MMD_AT_PLUS_A",
               diag_pivot_thresh=0.0, options={"SymmetricMode": True})
    if (sym.perm_r == sym.perm_c).all():
        pivots = f"{int((sym.U.diagonal() <= 0).sum())} of {b.size} " \
                 "pivots of its symmetric part not positive"
    else:
        pivots = "its symmetric part pivoted off the diagonal"
    log(f"control (tf32, direct): asymmetry {asym:.3e}, relative "
        f"residual {relres:.3e}, {pivots}, "
        f"{time.perf_counter() - t0:.2f} s")
    full = torch.zeros(free.shape, dtype=torch.float64)
    full[free.cpu()] = torch.from_numpy(y)
    return full.view(-1, 2)


def control(cfg: dict, mix: dict, kept: list, device) -> list:
    """``kept`` with each solution replaced by the TF32 system's own
    answer under the case's load (``tf32_direct``, scaled)."""
    unit = tf32_direct(cfg, device)
    return [dict(k, u=k["case"]["magnitude"] * unit) for k in kept]
