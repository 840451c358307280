"""Example 8 through the PyTorch port: the direct FEM displacement solve
by matrix-free CG.

The same recipe as ``examples/example8_linear_solve.py``: at a fixed mesh
the plate energy is quadratic in the nodal values, the linear FEM system
K u = f, and ``cg_solve`` solves it with the stiffness matvec evaluated as
grad(p0 + v) - grad(p0), each iteration one value-and-grad of the
production energy.  ``radapt_cg_solve`` then alternates exact
displacement solves with coordinate (r-adaptivity) steps.  On the card the
81x41 proxy plate takes the lattice route, so every matvec runs the
stencil kernel K6 of ``hidenn_fem_tpu_torch/csrc/lattice_stencil.cu`` and
every energy under ``no_grad`` K7.

The initial displacement is 1e-5 N(0, 1) from ``np.random.default_rng(
seed)``, so the JAX package can start from the same numbers.

Run: ``python -m examples.example8_linear_solve_torch`` (on the card;
``--device cpu`` for the CPU)
"""

import argparse
import time

import numpy as np
import torch

import hidenn_fem_tpu_torch as ht


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def main(nx=81, ny=41, max_iters=600, radapt_epochs=3, device="cuda",
         seed=0):
    mesh = ht.proxy_plate_mesh(nx=nx, ny=ny, device=device)
    model = ht.TriangleP1()
    energy = ht.PlaneStressEnergy(model=model, E=10e9, nu=0.3)
    u0 = 1e-5 * np.random.default_rng(seed).standard_normal(
        (mesh.n_nodes, 2))
    params = ht.params_from_numpy({"coords": mesh.coords.cpu().numpy(),
                                   "u": u0}, device=device)
    coords0 = params["coords"]
    print(f"proxy plate {nx}x{ny}: {mesh.n_nodes} nodes, "
          f"{mesh.n_elements} elements, lattice route "
          f"{mesh.lattice is not None}")

    def u_loss(p, coords, m):
        return energy({"u": p["u"], "coords": coords}, m)

    _sync(device)
    t0 = time.perf_counter()
    sol, hist = ht.cg_solve(u_loss, {"u": params["u"]},
                            loss_args=(coords0, mesh), max_iters=max_iters,
                            tol=1e-6)
    h = hist.cpu().numpy()
    seconds = time.perf_counter() - t0
    iters = int(np.count_nonzero(h))
    with torch.no_grad():
        e_lin = float(u_loss(sol, coords0, mesh))
    print(f"CG displacement solve: {iters} matvecs to rel res "
          f"{h[h > 0][-1]:.2e} in {seconds:.3f} s; energy {e_lin:.6e}")
    for i in range(0, iters, max(1, iters // 6)):
        print(f"  iter {i:4d}: rel res {h[i]:.3e}")

    _sync(device)
    t0 = time.perf_counter()
    pf, energies = ht.radapt_cg_solve(
        energy.total, {"u": sol["u"], "coords": coords0}, loss_args=(mesh,),
        outer_epochs=radapt_epochs, cg_iters=max_iters, coord_steps=20,
        coord_lr=1e-5)
    e = energies.cpu().numpy()
    print(f"r-adaptive CG ({radapt_epochs} epochs): energies "
          + ", ".join(f"{v:.9e}" for v in e)
          + f" ({time.perf_counter() - t0:.3f} s)")
    return pf, e, hist, e_lin


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (the default) or cpu")
    ap.add_argument("--nx", type=int, default=81)
    ap.add_argument("--ny", type=int, default=41)
    ap.add_argument("--iters", type=int, default=600)
    ap.add_argument("--epochs", type=int, default=3)
    args = ap.parse_args()
    main(nx=args.nx, ny=args.ny, max_iters=args.iters,
         radapt_epochs=args.epochs, device=torch.device(args.device))
