"""Example 4 through the PyTorch port: 2D plate with holes under traction,
plane-stress energy minimized with fixed-step L-BFGS, von Mises stress
recovered.

The same recipe as ``examples/example4.py`` (2x1 m plate, three circular
holes, left edge clamped, right edge under a uniform 100 kN traction,
E = 10 GPa, nu = 0.3, 600 L-BFGS iterations), on the structured mesh with
hole-interior nodes kept as pinned dead nodes.  It prints the same lines
as the JAX example, plus the largest von Mises stress in place of the
plots.  On a CUDA device the element energy runs the hand-written
kernels of ``hidenn_fem_tpu_torch/csrc/element_energy.cu``.

Run: ``python -m examples.example4_torch --device cuda``
"""

import argparse
import time

import torch

import hidenn_fem_tpu_torch as ht
from hidenn_fem_tpu_torch import postproc
from hidenn_fem_tpu_torch.config import PlateConfig


def main(cfg: PlateConfig = PlateConfig(), device="cpu"):
    mesh = ht.generate_mesh(cfg.length, cfg.height, list(cfg.holes),
                            cfg.make_boundaries(), cfg.nx, cfg.ny,
                            keep_dead_nodes=True, device=device)

    print("Nodes:", mesh.n_nodes)
    print("Connectivity:", tuple(mesh.connectivity.shape))
    print("Geometric boundary nodes:", int(mesh.geom_boundary_mask.sum()))
    print("Dirichlet BC nodes:", int(mesh.dirichlet_mask.sum()))
    print("Neumann MN nodes:", int(mesh.neumann_mask.sum()))
    print("Neumann edges:", tuple(mesh.neumann_edges.shape))

    model = ht.TriangleP1(u_fixed=0.0)
    params = model.init(torch.Generator().manual_seed(cfg.seed), mesh)
    energy = ht.PlaneStressEnergy(
        model=model, E=cfg.youngs_modulus, nu=cfg.poisson_ratio,
        gauss_order=cfg.gauss_order, gauss_order_1d=cfg.gauss_order_1d,
        F_total=cfg.traction_total, traction_length=cfg.traction_length)

    t0 = time.perf_counter()
    params, losses = ht.run_lbfgs(energy.total, params,
                                  num_steps=cfg.lbfgs_steps,
                                  loss_args=(mesh,))
    losses = losses.cpu().numpy()
    seconds = time.perf_counter() - t0
    for i in range(0, cfg.lbfgs_steps, 100):
        print(f"Iter {i:04d}: Loss = {losses[i]:.6e}")
    print(f"Final energy: {losses[-1]:.6e}")

    print("Training finished.")
    u_vals = model.u_full(params, mesh).cpu().numpy()
    print("Nodal values u", u_vals.shape)
    print("Nodal values u_x:", u_vals[:, 0].mean(), u_vals[:, 0].min(),
          u_vals[:, 0].max())
    print("Nodal values u_y:", u_vals[:, 1].mean(), u_vals[:, 1].min(),
          u_vals[:, 1].max())
    vm = postproc.von_mises_per_element(model, params, mesh,
                                        cfg.youngs_modulus,
                                        cfg.poisson_ratio)
    print(f"Max von Mises stress: {float(vm.max()):.6e}")
    print(f"Solve seconds ({device}): {seconds:.3f}")
    return params, losses


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cpu",
                    help="torch device, e.g. cpu or cuda")
    main(device=torch.device(ap.parse_args().device))
