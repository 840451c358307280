"""Example 9 through the PyTorch port: the geometric multigrid
displacement solve at 922K elements.

The same recipe as ``examples/example9_multigrid.py``: the hole-free
961x481 ``StructuredGridP1`` plate (921,600 elements), whose fixed-mesh
displacement problem is the linear FEM system K u = f, solved by
V-cycle-preconditioned CG (``mg_pcg_solve``).  Coarsening, prolongation
and restriction are lattice slices; every level operator is one
value-and-grad of the structured energy, on the card the stencil kernel
K6 of ``hidenn_fem_tpu_torch/csrc/lattice_stencil.cu``, on lattices from
961x481 down to 31x16 (the coarse quad masks are volume fractions).
``radapt_mg_solve`` optionally alternates exact MG solves with
node-coordinate steps.

The initial displacement is 1e-5 N(0, 1) from ``np.random.default_rng(
seed)``, so the JAX package can start from the same numbers.

Run: ``python -m examples.example9_multigrid_torch`` (on the card;
``--device cpu`` for the CPU)
"""

import argparse
import time

import numpy as np
import torch

import hidenn_fem_tpu_torch as ht
from hidenn_fem_tpu_torch.models.structured_grid import (
    StructuredGridP1, generate_structured_grid)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def main(nx=961, ny=481, radapt_epochs=0, device="cuda", seed=0):
    grid = generate_structured_grid(length=2.0, height=1.0, holes=(),
                                    nx=nx, ny=ny, device=device)
    model = StructuredGridP1(E=10e9, nu=0.3)
    params = model.init(np.random.default_rng(seed), grid, device=device)

    _sync(device)
    t0 = time.perf_counter()
    with torch.no_grad():
        coords = model.coords(params, grid)
    levels = ht.build_hierarchy(model, grid, coords)
    _sync(device)
    setup_s = time.perf_counter() - t0
    print(f"hierarchy: {[(lv.grid.nx, lv.grid.ny) for lv in levels]}, "
          f"lmax {[round(lv.lmax_host, 6) for lv in levels]} "
          f"({setup_s:.3f} s)")

    t0 = time.perf_counter()
    sol, hist = ht.mg_pcg_solve(model, grid, params, max_iters=40,
                                tol=1e-6, levels=levels)
    h = hist.cpu().numpy()
    seconds = time.perf_counter() - t0
    nz = h[h > 0]
    with torch.no_grad():
        energy = float(model(sol, grid))
    print(f"MG-PCG: {len(nz)} iterations to rel res {nz[-1]:.2e} in "
          f"{seconds:.3f} s; energy {energy:.9e}")
    for i, r in enumerate(nz):
        print(f"  iter {i:3d}: rel res {r:.3e}")

    if radapt_epochs:
        _sync(device)
        t0 = time.perf_counter()
        pf, energies = ht.radapt_mg_solve(
            model, grid, params, outer_epochs=radapt_epochs,
            coord_steps=10, coord_lr=1e-7)
        e = energies.cpu().numpy()
        print(f"r-adaptive MG ({radapt_epochs} epochs): energies "
              + ", ".join(f"{v:.9e}" for v in e)
              + f" ({time.perf_counter() - t0:.3f} s)")
        return pf, hist, e, levels
    return sol, hist, None, levels


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (the default) or cpu")
    ap.add_argument("--nx", type=int, default=961)
    ap.add_argument("--ny", type=int, default=481)
    ap.add_argument("--epochs", type=int, default=0,
                    help="r-adaptive epochs after the solve")
    args = ap.parse_args()
    main(nx=args.nx, ny=args.ny, radapt_epochs=args.epochs,
         device=torch.device(args.device))
