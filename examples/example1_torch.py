"""Example 1 through the PyTorch port: 1D L2 projection of sin(2 pi x)
onto a piecewise-linear FE space with r-adaptivity.

The recipe of ``examples/example1.py``: 100 nodes on [0, 1], 1000
training samples, Adam lr 5e-3, 500 epochs; the final MSE is about
3.2e-7, as in the JAX package.  It prints the same lines as the JAX
example and draws its two figures into ``outdir`` when matplotlib
imports.

Run: ``python -m examples.example1_torch`` (on the card; ``--device cpu``
for the CPU)
"""

import argparse
import math
import os
import time

import numpy as np
import torch

import hidenn_fem_tpu_torch as ht
from hidenn_fem_tpu_torch.config import Projection1DConfig


def plots_module():
    """``hidenn_fem_tpu_torch.plots``, or None without matplotlib."""
    try:
        from hidenn_fem_tpu_torch import plots
    except ImportError:
        return None
    return plots


def main(cfg: Projection1DConfig = Projection1DConfig(), outdir="out",
         device="cuda"):
    model, params = ht.Linear1D.from_node_coords(
        np.linspace(cfg.x0, cfg.xN, cfg.n_nodes), r_adapt=cfg.r_adapt,
        device=device)
    x_train = torch.linspace(cfg.x0, cfg.xN, cfg.n_train, device=device)
    u_true = torch.sin(2 * math.pi * x_train)

    t0 = time.perf_counter()
    params, losses = ht.minimize(
        lambda p: ht.l2_loss(model, p, x_train, u_true), params,
        method="adam", num_steps=cfg.epochs, learning_rate=cfg.learning_rate)
    losses = losses.cpu().numpy()
    seconds = time.perf_counter() - t0
    for epoch in range(0, cfg.epochs, 100):
        print(f"Epoch {epoch}: loss={losses[epoch]:.6f}")
    print(f"Final MSE: {losses[-1]:.3e}")
    print(f"Training seconds ({device}): {seconds:.3f}")

    plots = plots_module()
    if plots is not None:
        os.makedirs(outdir, exist_ok=True)
        exact = lambda x: np.sin(2 * np.pi * x)  # noqa: E731
        exact_d = lambda x: 2 * np.pi * np.cos(2 * np.pi * x)  # noqa: E731
        plots.plot_fem_solution(model, params, u_exact=exact,
                                title="L2 Projection of sin(2*pi*x)",
                                save_path=f"{outdir}/example1_solution.png")
        plots.plot_fem_derivative(
            model, params, u_exact=exact_d,
            title="Derivative of L2 Projection (du/dx)",
            save_path=f"{outdir}/example1_derivative.png")
    return params, losses


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (the default) or cpu")
    main(device=torch.device(ap.parse_args().device))
