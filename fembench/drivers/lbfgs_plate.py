"""The r-adaptive plate solve: ``run_lbfgs(energy.total, params,
num_steps, memory_size, loss_args=(mesh,))`` from the mesh's coordinates
and u0 = ``u0_scale`` * N(0, 1), under a traction of the load case's
magnitude on the right edge.

Set-up: the mesh arrays (``fembench/meshes``), the port's tables
(``TriMesh.from_arrays`` with its defaults), the energy route asserted to
be the identity lattice route of the stencil kernels.  A solve's answer is
its loss history, read to the host, and its final parameters.

The check (``judge``), in float64 on the card, of each checked solve.
The reference replays the whole solve, all ``num_steps`` steps of plain
L-BFGS from the same start, and the solve's loss history is held to the
replay's:
* ``loss_gap``: the largest relative gap over the first
  ``opening_steps`` steps, which float32 follows closely;
* ``final_gap``: the relative gap of the last loss, where every step of
  the solve, and every pass over the history after it has wrapped, has
  had its effect (fixed steps of 1 on this problem carry rounding far:
  float32 ends 0.07-5% from float64, PERF.md section 2);
* ``energy_gap``, ``grad_gap``: the port's energy and both gradient
  groups (coords, u), by its energy route, at the parameters the solve
  started and ended at, against the reference's there: the relative gap of
  the energy, and the largest ||g_port - g_ref|| / ||s|| of a group, s the
  per-node sums of the absolute values of the gradient's terms (near
  equilibrium the terms cancel, and ||g_ref|| says nothing of rounding).
"""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from .. import roofline, spec
from ..reference import lbfgs as ref_lbfgs
from ..reference.p1_plate import P1Plate
from ..reference.precision import Precision


def u0(n_nodes: int, case: dict, scale: float, device) -> torch.Tensor:
    """The load case's initial displacements, made on ``device``."""
    gen = torch.Generator(device=device).manual_seed(case["u0_seed"])
    return scale * torch.randn((n_nodes, 2), generator=gen, device=device)


def mesh_arrays(cfg: dict) -> dict:
    return spec.module("meshes", cfg["mesh"]["kind"]).arrays(cfg["mesh"])


class Driver:
    def __init__(self, cfg: dict, mix: dict, device):
        self.cfg, self.mix, self.device = cfg, mix, device
        self.m = int(mix["memory_size"])
        self.num_steps = int(mix["num_steps"])

    def setup(self, phases):
        with phases("library_load"):
            import hidenn_fem_tpu_torch as ht
            from hidenn_fem_tpu_torch.ops import lattice_slab
            if self.device.type == "cuda":
                from hidenn_fem_tpu_torch.mesh import native
                from hidenn_fem_tpu_torch.ops.cuda_build import build_kernels
                torch.zeros((), device=self.device)
                build_kernels()
                native.build(verbose=False)
        self.ht, self.ls = ht, lattice_slab
        with phases("mesh_arrays"):
            self.arrays = mesh_arrays(self.cfg)
        with phases("port_tables"):
            self.mesh = ht.TriMesh.from_arrays(**self.arrays,
                                               device=self.device)
        route = self.mesh.lattice
        if route is None or not route.identity:
            raise RuntimeError("the plate did not take the identity "
                               "lattice route")
        if self.device.type == "cuda" and not lattice_slab.slab_supported(
                route, torch.float32):
            raise RuntimeError("the stencil kernels do not take this route")
        self.model = ht.TriangleP1()

    def energy(self, case):
        mat = self.cfg["material"]
        return self.ht.PlaneStressEnergy(
            model=self.model, E=float(mat["E"]), nu=float(mat["nu"]),
            F_total=case["magnitude"], traction_length=1.0)

    def solve(self, case):
        with record_function("fembench.load_case"):
            energy = self.energy(case)
            params = {"coords": self.mesh.coords,
                      "u": u0(self.mesh.n_nodes, case,
                              float(self.mix["u0_scale"]), self.device)}
        with record_function("fembench.entry"):
            final, losses = self.ht.run_lbfgs(
                energy.total, params, num_steps=self.num_steps,
                memory_size=self.m, loss_args=(self.mesh,))
        with record_function("fembench.read_result"):
            losses = losses.cpu().numpy()
        return {"case": case, "losses": losses, "final": final}

    def keep(self, out):
        return {"case": out["case"], "losses": out["losses"],
                "final": {k: v.cpu() for k, v in out["final"].items()}}

    def program_readings(self, kept):
        """The port's energy and gradients at each kept solve's start and
        end, by its energy route."""
        for k in kept:
            energy = self.energy(k["case"])
            start = {"coords": self.mesh.coords,
                     "u": u0(self.mesh.n_nodes, k["case"],
                             float(self.mix["u0_scale"]), self.device)}
            k["program"] = {}
            for where, p in (("start", start), ("end", k["final"])):
                leaves = {n: v.to(self.device).detach().clone()
                          .requires_grad_(True) for n, v in p.items()}
                e = energy.total(leaves, self.mesh)
                gc, gu = torch.autograd.grad(e, [leaves["coords"],
                                                 leaves["u"]])
                k["program"][where] = (float(e.detach()), gc.cpu(),
                                       gu.cpu())

    def release(self):
        del self.mesh, self.model

    def counters(self) -> dict:
        return dict(self.ls.launch_counts)

    def steps(self, out) -> int:
        return len(out["losses"])

    def iterations(self, out) -> int:
        return 0

    def work(self, solves) -> dict:
        """Bytes each kernel family's work needs over ``solves``: the two
        history passes and one stencil value-and-grad a step."""
        route, p = self.mesh.lattice, 4 * self.mesh.n_nodes
        hist = roofline.lbfgs_history_bytes(self.m, p)
        masks = sum(t is not None for t in (
            route.sel if route.uniform_sel == "" else None,
            None if route.all_present else route.t1,
            None if route.all_present else route.t2))
        steps = sum(self.steps(o) for o in solves)
        return {"lbfgs_history": steps * (hist["dots"] + hist["combine"]),
                "lattice_vg": steps * roofline.stencil_vg_bytes(
                    route.nx, route.ny, masks)}


def reference(cfg: dict, arrays: dict, case: dict, prec: Precision,
              device) -> P1Plate:
    mat = cfg["material"]
    return P1Plate(arrays["coords"], arrays["connectivity"],
                   arrays["geom_boundary_mask"], arrays["dirichlet_mask"],
                   arrays["neumann_edges"], float(mat["E"]),
                   float(mat["nu"]), traction=case["traction"], prec=prec,
                   device=device)


def _start(ref: P1Plate, mix: dict, case: dict) -> dict:
    """The solve's start: the mesh's float32 coordinates and its u0."""
    c = ref.coords0
    return {"coords": c.float(),
            "u": u0(c.shape[0], case, float(mix["u0_scale"]), c.device)}


def _flat_vg(ref: P1Plate):
    n = ref.coords0.shape[0]

    def vg(x):
        e, gc, gu = ref.value_and_grads(x[:2 * n].view(n, 2),
                                        x[2 * n:].view(n, 2))
        return e, torch.cat([gc.reshape(-1), gu.reshape(-1)])
    return vg


def _replay(ref, start, mix, prec):
    x0 = torch.cat([start["coords"].reshape(-1),
                    start["u"].reshape(-1)]).to(prec.dtype)
    return np.array(ref_lbfgs.replay(_flat_vg(ref), x0,
                                     int(mix["memory_size"]),
                                     int(mix["num_steps"]), prec))


def loss_gaps(got: np.ndarray, want: np.ndarray, opening: int) -> dict:
    """``loss_gap`` and ``final_gap`` (module doc) of a loss history
    against the reference's."""
    gap = np.abs(got.astype(np.float64) - want) / np.abs(want)
    return {"loss_gap": float(np.max(gap[:opening])),
            "final_gap": float(gap[-1])}


def _gaps(got: dict, want: dict, scales: dict) -> dict:
    """The relative gap of the energies, and of each gradient group the
    norm of the difference over the norm of its terms' absolute sums
    (``P1Plate.gradient_scales``), the worst of start and end."""
    egap, ggap = 0.0, 0.0
    for where in ("start", "end"):
        e, gc, gu = got[where]
        re_, rgc, rgu = want[where]
        egap = max(egap, abs(e - float(re_)) / abs(float(re_)))
        for g, rg, sc in zip((gc, gu), (rgc, rgu), scales[where]):
            diff = g.double().cpu() - rg.double().cpu()
            ggap = max(ggap, float(torch.linalg.vector_norm(diff)
                                   / torch.linalg.vector_norm(sc.cpu())))
    return {"energy_gap": egap, "grad_gap": ggap}


def _on(ref, p):
    return p["coords"].to(ref.coords0.device), p["u"].to(ref.coords0.device)


def _readings(ref, points: dict) -> dict:
    return {w: ref.value_and_grads(*_on(ref, p)) for w, p in points.items()}


def judge(cfg: dict, mix: dict, kept: list, device) -> list:
    arrays = mesh_arrays(cfg)
    return [_judge(cfg, arrays, mix, k, device) for k in kept]


def _judge(cfg: dict, arrays: dict, mix: dict, kept: dict, device) -> dict:
    prec = Precision("float64")
    ref = reference(cfg, arrays, kept["case"], prec, device)
    start = _start(ref, mix, kept["case"])
    points = {"start": start, "end": kept["final"]}
    want = _readings(ref, points)
    scales = {w: ref.gradient_scales(*_on(ref, p)) for w, p in points.items()}
    out = loss_gaps(kept["losses"], _replay(ref, start, mix, prec),
                    int(mix["opening_steps"]))
    out.update(_gaps(kept["program"], want, scales))
    return out


def control(cfg: dict, mix: dict, kept: list, device) -> list:
    """``kept`` with the port's readings replaced by the reference's in
    TF32 (its replayed losses, and its energy and gradients at the same
    start and end), for ``judge``."""
    arrays = mesh_arrays(cfg)
    return [_control(cfg, arrays, mix, k, device) for k in kept]


def _control(cfg: dict, arrays: dict, mix: dict, kept: dict,
             device) -> dict:
    prec = Precision("tf32")
    ref = reference(cfg, arrays, kept["case"], prec, device)
    start = _start(ref, mix, kept["case"])
    readings = _readings(ref, {"start": start, "end": kept["final"]})
    return dict(kept, losses=_replay(ref, start, mix, prec),
                program={w: (float(e), gc.cpu(), gu.cpu())
                         for w, (e, gc, gu) in readings.items()})
