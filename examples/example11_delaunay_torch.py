"""Example 11 through the PyTorch port: the gmsh workflow without gmsh,
on a native Delaunay mesh.

The same recipe as ``examples/example11_delaunay.py``: the reference's
example-4 plate (2x1, three circular holes, left face clamped, 100 kN
traction on the right) meshed by ``generate_mesh_delaunay`` (boundary and
rim sampling, hex interior, Delaunay, smoothing, RCM node order).  The
mesh is genuinely irregular, so lattice detection rejects it, and the
displacement solve is auxiliary-space PCG (example 10's machinery, the
solver for a mesh without a lattice): each matvec on the gather route
(K1/K2 and ``incidence_sum``) or, above 250,000 gather rows, the banded
route (K4), and each preconditioner application a V-cycle on a background
lattice (K6).  The JAX example's figures are left out (the port has no
plotting module yet).

The initial displacement is 1e-5 N(0, 1) from ``np.random.default_rng(
seed)``, so the JAX package can start from the same numbers.

Run: ``python -m examples.example11_delaunay_torch [--lc 0.05]`` (on the
card; ``--device cpu`` for the CPU; the default lc, the reference's
example-4 size, gives about 4,400 elements)
"""

import argparse
import time

import numpy as np
import torch

import hidenn_fem_tpu_torch as ht
from hidenn_fem_tpu_torch.models.structured_grid import StructuredGridP1

HOLES = ((0.5, 0.7, 0.12), (1.0, 0.3, 0.15), (1.4, 0.6, 0.1))


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def main(lc=0.05, device="cuda", seed=0):
    t0 = time.perf_counter()
    mesh = ht.generate_mesh_delaunay(holes=HOLES, lc=lc, device=device)
    print(f"mesh: {mesh.n_elements} elements / {mesh.n_nodes} nodes "
          f"(lc={lc:g}, {time.perf_counter() - t0:.2f}s, "
          f"lattice={'yes' if mesh.lattice is not None else 'no'})")

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
    _sync(device)
    t0 = time.perf_counter()
    pre = ht.build_aux_preconditioner(loss, up, (coords0, mesh), mesh,
                                      bg_model=bg)
    sol, hist = ht.aux_pcg_solve(loss, up, (coords0, mesh), pre=pre,
                                 bg_model=bg, max_iters=200, tol=1e-6)
    h = hist.cpu().numpy()
    nz = h[h > 0]
    print(f"aux-PCG: {len(nz)} iterations to rel residual "
          f"{nz[-1]:.2e} ({time.perf_counter() - t0:.2f}s with the set-up)")

    params = dict(params, u=sol["u"])
    with torch.no_grad():
        e = float(energy.total(params, mesh))
        u = model.u_full(params, mesh)
    print(f"energy {e:.4f}, max u_x {float(u[:, 0].max()):.3e} m")
    return e


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (the default) or cpu")
    ap.add_argument("--lc", type=float, default=0.05)
    args = ap.parse_args()
    main(lc=args.lc, device=torch.device(args.device))
