"""The r-adaptive plate solve of ``lbfgs_plate`` on a mesh without a
lattice: ``run_lbfgs(energy.total, params, num_steps, memory_size,
loss_args=(mesh,))`` from the mesh's coordinates and u0 = ``u0_scale`` *
N(0, 1), under a traction of the load case's magnitude on the loaded
edge, on the banded energy route (K4, ``csrc/banded_energy.cu``, a
value-and-grad a step).

Set-up: the mesh arrays (``fembench/meshes``, built once a process and
shared with the check), the port's tables (``TriMesh.from_arrays`` with
its banded tables, which it builds by default above 250,000 gather rows),
the energy route asserted to be the banded route on the paired tables.
The solve, what a check keeps, the check (``judge``: the whole-solve
replay by the plain reference, ``loss_gap``, ``final_gap``,
``energy_gap``, ``grad_gap``) and the control are ``lbfgs_plate``'s.
"""

from __future__ import annotations

import importlib
import time

import torch

from .. import banded_bytes, roofline
from ..harness import log
from . import lbfgs_plate as plate


def mesh_arrays(cfg: dict) -> dict:
    """The configuration's mesh arrays, through the module's own import,
    so that a mesh module that keeps what it built serves the set-up and
    the check of one process."""
    kind = cfg["mesh"]["kind"]
    return importlib.import_module(f"fembench.meshes.{kind}").arrays(
        cfg["mesh"])


def banded_mesh(ht, arrays: dict, device):
    """The port's mesh of ``arrays`` with its banded tables, asserted to
    take the banded route on the paired tables."""
    mesh = ht.TriMesh.from_arrays(**arrays, build_banded=True,
                                  device=device)
    if mesh.lattice is not None:
        raise RuntimeError("the mesh took the lattice route, not the "
                           "banded route")
    ba = mesh.banded_paired
    if ba is None or ba.k != 4 or ba.re_own_lo is None:
        raise RuntimeError("the mesh has no paired banded tables with "
                           "ownership intervals (K4's)")
    return mesh


def k4_bytes(mesh) -> int:
    """K4's bytes a launch on the mesh's paired tables (logged)."""
    n = banded_bytes.banded_vg_bytes(
        mesh.n_nodes, banded_bytes.shapes_of(mesh.banded_paired))
    log(f"K4 on {mesh.n_elements} elements, {mesh.n_nodes} nodes: "
        f"{n / 1e6:.2f} MB a launch")
    return n


def build_libraries(device):
    """The kernels' and the native mesh library, built once a checkout."""
    if device.type == "cuda":
        from hidenn_fem_tpu_torch.mesh import native
        from hidenn_fem_tpu_torch.ops.cuda_build import build_kernels
        torch.zeros((), device=device)
        build_kernels()
        native.build(verbose=False)


class Driver(plate.Driver):
    def setup(self, phases):
        with phases("library_load"):
            import hidenn_fem_tpu_torch as ht
            from hidenn_fem_tpu_torch.ops import banded_energy
            build_libraries(self.device)
        self.ht, self.be = ht, banded_energy
        with phases("mesh_arrays"):
            arrays = mesh_arrays(self.cfg)
        with phases("port_tables"):
            self.mesh = banded_mesh(ht, arrays, self.device)
        self.k4_bytes = k4_bytes(self.mesh)
        self.model = ht.TriangleP1()

    def solve(self, case):
        before = self.be.launch_counts["banded_vg"]
        out = super().solve(case)
        out["banded_vg"] = self.be.launch_counts["banded_vg"] - before
        return out

    def counters(self) -> dict:
        return dict(self.be.launch_counts)

    def work(self, solves) -> dict:
        """Bytes of the two history passes a step and of the K4 launches
        the solves made."""
        hist = roofline.lbfgs_history_bytes(self.m, 4 * self.mesh.n_nodes)
        steps = sum(self.steps(o) for o in solves)
        return {"lbfgs_history": steps * (hist["dots"] + hist["combine"]),
                "banded_vg": self.k4_bytes * sum(o["banded_vg"]
                                                 for o in solves)}


def _timed(what: str, fn, kept: list) -> list:
    t0 = time.perf_counter()
    out = [fn(k) for k in kept]
    log(f"{what}: {len(kept)} solves in {time.perf_counter() - t0:.2f} s")
    return out


def judge(cfg: dict, mix: dict, kept: list, device) -> list:
    """``lbfgs_plate``'s numbers, on the arrays the set-up built."""
    arrays = mesh_arrays(cfg)
    return _timed("check", lambda k: plate._judge(cfg, arrays, mix, k,
                                                  device), kept)


def control(cfg: dict, mix: dict, kept: list, device) -> list:
    """``lbfgs_plate``'s control, on the arrays the set-up built."""
    arrays = mesh_arrays(cfg)
    return _timed("control", lambda k: plate._control(cfg, arrays, mix, k,
                                                      device), kept)
