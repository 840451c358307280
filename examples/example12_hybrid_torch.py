"""Example 12 through the PyTorch port: hole geometry at lattice speed,
the hybrid mesh.

The same recipe as ``examples/example12_hybrid.py``: the reference's
example-4 plate (2x1, three circular holes, left face clamped, 100 kN
traction on the right) on a ``generate_mesh_hybrid`` mesh, a structured
triangular lattice wherever the domain is rectangular tied to exact
circle rims by a thin Delaunay collar.  The energy evaluates from
node-lattice slices plus a small collar gather (the hybrid route, plain
torch as the JAX package runs XLA there).  The displacement solve is
auxiliary-space PCG whose background is the mesh's own lattice (kind
"reshape", with bilinear tables for the rim nodes), so each
preconditioner application is a V-cycle on the fine lattice (K6 of
``hidenn_fem_tpu_torch/csrc/lattice_stencil.cu`` on the card).  The JAX
example's figures are left out (the port has no plotting module yet).

The initial displacement is 1e-5 N(0, 1) from ``np.random.default_rng(
seed)``, so the JAX package can start from the same numbers.

Run: ``python -m examples.example12_hybrid_torch [--lc 0.02]`` (on the
card; ``--device cpu`` for the CPU; the default lc gives about 9,400
elements)
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


def main(lc=0.02, device="cuda", seed=0):
    t0 = time.perf_counter()
    mesh = ht.generate_mesh_hybrid(holes=HOLES, lc=lc, device=device)
    k = int(mesh.hybrid.extra_conn.shape[0])
    print(f"mesh: {mesh.n_elements} elements / {mesh.n_nodes} nodes, "
          f"{k} collar triangles ({100.0 * k / mesh.n_elements:.1f}% "
          f"ride gathers; lc={lc:g}, {time.perf_counter() - t0:.2f}s)")

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
    ap.add_argument("--lc", type=float, default=0.02)
    args = ap.parse_args()
    main(lc=args.lc, device=torch.device(args.device))
