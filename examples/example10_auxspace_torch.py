"""Example 10 through the PyTorch port: auxiliary-space preconditioning at
922K unstructured elements.

The same recipe as ``examples/example10_auxspace.py``: geometric
multigrid (example 9) needs a lattice, and general unstructured meshes
have none, so ``aux_pcg_solve`` preconditions the unstructured system
with a structured background lattice,

    M^{-1} r  =  omega * D^{-1} r  +  P · Vcycle_bg(P^T r)

with D the exact graph-colored Jacobi diagonal, P the bilinear
background -> mesh interpolation (a 4-row gather; its transpose a
precomputed incidence gather) and the V-cycle example 9's multigrid on
the background plane-stress operator, every level operator one launch of
the stencil kernel K6 of ``hidenn_fem_tpu_torch/csrc/lattice_stencil.cu``
on the card.

Two framings of the same solve on the 961x481 proxy plate (921,600
elements), whose lattice topology sends every fine matvec to the lattice
route (K6 too):
* the generic background (``lattice_bg=False``): bilinear transfer
  tables at about half the fine resolution, what a genuinely unstructured
  gmsh mesh sees;
* the lattice-aligned background (the default when the mesh carries a
  lattice or hybrid route): P and P^T become a reshape and the background
  operator runs at the fine resolution.

The initial displacement is 1e-5 N(0, 1) from ``np.random.default_rng(
seed)``, so the JAX package can start from the same numbers.

Run: ``python -m examples.example10_auxspace_torch`` (on the card;
``--device cpu`` for the CPU; ``--nx/--ny`` for another size)
"""

import argparse
import time

import numpy as np
import torch

import hidenn_fem_tpu_torch as ht
from hidenn_fem_tpu_torch.models.structured_grid import StructuredGridP1

FRAMINGS = (("generic bg", False), ("lattice-aligned bg", True))


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def main(nx=961, ny=481, device="cuda", seed=0, framings=FRAMINGS):
    """Both framings' set-up, cold and warm solves; returns {label:
    dict(pre, sol, hist, energy, setup_s, solve_s, warm_s, warm_hist,
    loss, args)}, ``args`` the loss arguments (coordinates, mesh)."""
    mesh = ht.proxy_plate_mesh(nx=nx, ny=ny, device=device)
    model = ht.TriangleP1()
    energy = ht.PlaneStressEnergy(model=model, E=10e9, nu=0.3)
    u0 = 1e-5 * np.random.default_rng(seed).standard_normal(
        (mesh.n_nodes, 2))
    params = ht.params_from_numpy({"coords": mesh.coords.cpu().numpy(),
                                   "u": u0}, device=device)
    coords0 = params["coords"]

    def loss(p, coords, m):
        return energy({"u": p["u"], "coords": coords}, m)

    up = {"u": params["u"]}
    bg = StructuredGridP1(E=10e9, nu=0.3)
    out = {}
    for label, lattice_bg in framings:
        _sync(device)
        t0 = time.perf_counter()
        pre = ht.build_aux_preconditioner(loss, up, (coords0, mesh), mesh,
                                          bg_model=bg, lattice_bg=lattice_bg)
        _sync(device)
        setup_s = time.perf_counter() - t0
        detail = (f"kind={pre.lat_kind!r}" if pre.lat_kind
                  else f"P^T table depth {pre.pt_w.shape[1]}, "
                  + ("windowed" if pre.ptw_rel is not None else "flat"))
        print(f"[{label}] setup: background lattice "
              f"{pre.grid.nx}x{pre.grid.ny}, {detail} ({setup_s:.3f} s)")

        t0 = time.perf_counter()
        sol, hist = ht.aux_pcg_solve(loss, up, (coords0, mesh), pre=pre,
                                     bg_model=bg, max_iters=100, tol=1e-6)
        h = hist.cpu().numpy()
        solve_s = time.perf_counter() - t0
        nz = h[h > 0]
        with torch.no_grad():
            e = float(loss(sol, coords0, mesh))
        print(f"[{label}] aux-PCG: {len(nz)} iterations to rel res "
              f"{nz[-1]:.2e} ({solve_s:.3f} s); energy {e:.6e}")

        _sync(device)
        t0 = time.perf_counter()
        _, warm = ht.aux_pcg_solve(loss, up, (coords0, mesh), pre=pre,
                                   bg_model=bg, max_iters=100, tol=1e-6)
        warm.cpu()            # the history read waits for the device
        warm_s = time.perf_counter() - t0
        print(f"[{label}] warm solve: {warm_s:.3f} s")
        out[label] = dict(pre=pre, sol=sol, hist=hist, energy=e,
                          setup_s=setup_s, solve_s=solve_s, warm_s=warm_s,
                          warm_hist=warm, loss=loss, args=(coords0, mesh))
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (the default) or cpu")
    ap.add_argument("--nx", type=int, default=961)
    ap.add_argument("--ny", type=int, default=481)
    args = ap.parse_args()
    main(nx=args.nx, ny=args.ny, device=torch.device(args.device))
