"""Example 6 through the PyTorch port: the million-element plate on the
gather-free structured path.

The same recipe as ``examples/example6_structured.py``: a 1000x500 node
lattice over the 2x1 m plate with the three reference holes (922,022
active triangles), ``StructuredGridP1`` with r-adaptivity (nodal
coordinates are parameters), 600 fixed-step L-BFGS iterations with a
history of 10, and the von Mises stress recovered through the equivalent
``TriMesh`` (``to_trimesh``) and the port's ``postproc``.  It prints the
energy history and field extrema in place of the plots.  On a CUDA device
the domain energy runs the stencil kernels K6/K7 of
``hidenn_fem_tpu_torch/csrc/lattice_stencil.cu``.

The initial displacement is 1e-5 N(0, 1) from ``np.random.default_rng(
seed)``, so the JAX package can start from the same numbers.

Run: ``python -m examples.example6_structured_torch`` (on the card;
``--device cpu`` for the CPU)
"""

import argparse
import time

import numpy as np
import torch

import hidenn_fem_tpu_torch as ht
from hidenn_fem_tpu_torch import postproc
from hidenn_fem_tpu_torch.models.structured_grid import (
    StructuredGridP1, generate_structured_grid)

HOLES = ((0.5, 0.7, 0.12), (1.0, 0.3, 0.15), (1.4, 0.6, 0.1))


def main(nx=1000, ny=500, lbfgs_steps=600, device="cuda", seed=0,
         backend="auto"):
    t0 = time.perf_counter()
    grid = generate_structured_grid(length=2.0, height=1.0, holes=HOLES,
                                    nx=nx, ny=ny, device=device)
    print(f"lattice {nx}x{ny}: {grid.n_elements} active elements "
          f"({time.perf_counter() - t0:.1f} s host gen)")

    model = StructuredGridP1(E=10e9, nu=0.3, F_total=100e3,
                             backend=backend)
    params = model.init(np.random.default_rng(seed), grid, device=device)

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, losses = ht.run_lbfgs(model.total, params,
                                  num_steps=lbfgs_steps, memory_size=10,
                                  loss_args=(grid,))
    losses = losses.cpu().numpy()
    seconds = time.perf_counter() - t0
    print(f"LBFGS {lbfgs_steps} iters: {seconds:.3f} s; energy "
          f"{losses[0]:.6e} -> {losses[-1]:.6e}")
    with torch.no_grad():
        final = float(model.total(params, grid))
    print(f"Energy at the solution: {final:.6e}")

    # post-processing through the equivalent TriMesh
    mesh = model.to_trimesh(grid, device=device)
    tparams = {"coords": params["coords"].reshape(-1, 2),
               "u": params["u"].reshape(-1, 2)}
    tmodel = ht.TriangleP1()
    u = tmodel.u_full(tparams, mesh).cpu().numpy()
    print("u_x:", u[:, 0].mean(), u[:, 0].min(), u[:, 0].max())
    vm = postproc.von_mises_per_element(tmodel, tparams, mesh, 10e9, 0.3)
    print(f"Max von Mises stress: {float(vm.max()):.6e}")
    print(f"Solve seconds ({device}): {seconds:.3f}")
    return params, losses, vm, final


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (the default) or cpu")
    ap.add_argument("--nx", type=int, default=1000)
    ap.add_argument("--ny", type=int, default=500)
    ap.add_argument("--steps", type=int, default=600)
    args = ap.parse_args()
    main(nx=args.nx, ny=args.ny, lbfgs_steps=args.steps,
         device=torch.device(args.device))
