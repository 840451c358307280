"""Example 3 through the PyTorch port: 1D bar under a distributed body
force, total potential energy minimized with r-adaptivity and checked
against the exact solution.

The recipe of ``examples/example3.py``: bar [0, 10], E = 175,
u(0) = u(10) = 0, 89 nodes, 2-point Gauss per element, two Gaussian-bump
body force, Adam lr 1e-4, 4000 epochs; the energy is differentiable
through the integration map (the reference's detach, quirk E5, is
``differentiable_geometry=False``).  It prints the same lines as the JAX
example and draws its two figures into ``outdir`` when matplotlib
imports.

Run: ``python -m examples.example3_torch`` (on the card; ``--device cpu``
for the CPU)
"""

import argparse
import math
import os
import time

import numpy as np
import torch

import hidenn_fem_tpu_torch as ht
from hidenn_fem_tpu_torch.config import Bar1DConfig

from .example1_torch import plots_module


def b_force(x):
    """Two Gaussian-like bumps, as ``-N exp(-pi x^2)`` (the reference's
    ``-N / exp(pi x^2)`` overflows in float32 far from the bumps, and its
    derivative is then inf / inf)."""
    n1 = 4 * math.pi ** 2 * (x - 2.5) ** 2 - 2 * math.pi
    n2 = 8 * math.pi ** 2 * (x - 7.5) ** 2 - 4 * math.pi
    return (-n1 * torch.exp(-math.pi * (x - 2.5) ** 2)
            - n2 * torch.exp(-math.pi * (x - 7.5) ** 2))


def u_true(x, E):
    """Closed-form displacement (host numpy)."""
    pi = np.pi
    term1 = (1 / E) * (np.exp(-pi * (x - 2.5) ** 2) - np.exp(-6.25 * pi))
    term2 = (2 / E) * (np.exp(-pi * (x - 7.5) ** 2) - np.exp(-56.25 * pi))
    constant = np.exp(-6.25 * pi) - np.exp(-56.25 * pi)
    return term1 + term2 - constant * x / (10 * E)


def du_dx_true(x, E):
    """Closed-form derivative (host numpy)."""
    pi = np.pi
    term1 = (2 / E) * (-pi * (x - 2.5) * np.exp(-pi * (x - 2.5) ** 2))
    term2 = (4 / E) * (-pi * (x - 7.5) * np.exp(-pi * (x - 7.5) ** 2))
    constant = np.exp(-6.25 * pi) - np.exp(-56.25 * pi)
    return term1 + term2 - constant * x / (10 * E)


def main(cfg: Bar1DConfig = Bar1DConfig(), outdir="out", device="cuda"):
    model, params = ht.Linear1D.from_node_coords(
        np.linspace(0, cfg.length, cfg.n_nodes), r_adapt=cfg.r_adapt,
        u0=cfg.u0, uN=cfg.uN, device=device)

    t0 = time.perf_counter()
    params, losses = ht.minimize(
        lambda p: ht.bar_energy_1d(model, p, cfg.n_gauss, b_force,
                                   E=cfg.youngs_modulus),
        params, method="adam", num_steps=cfg.epochs,
        learning_rate=cfg.learning_rate)
    losses = losses.cpu().numpy()
    seconds = time.perf_counter() - t0
    for epoch in range(0, cfg.epochs, 500):
        print(f"Epoch {epoch}: loss={losses[epoch]:.6f}")

    # exact-solution validation
    xs = np.linspace(0, cfg.length, 2000)
    with torch.no_grad():
        u_h = model.apply(params, torch.tensor(
            xs, dtype=torch.float32, device=device)).cpu().numpy()
    err = np.sqrt(np.mean((u_h - u_true(xs, cfg.youngs_modulus)) ** 2))
    print(f"Final energy: {losses[-1]:.6f}; RMS error vs exact: {err:.3e}")
    print(f"Training seconds ({device}): {seconds:.3f}")

    plots = plots_module()
    if plots is not None:
        os.makedirs(outdir, exist_ok=True)
        plots.plot_fem_solution(
            model, params, u_exact=lambda x: u_true(x, cfg.youngs_modulus),
            title="FEM Solution (Displacement)",
            save_path=f"{outdir}/example3_solution.png")
        plots.plot_fem_derivative(
            model, params,
            u_exact=lambda x: du_dx_true(x, cfg.youngs_modulus),
            title="FEM Derivative (du/dx)",
            save_path=f"{outdir}/example3_derivative.png")
    return params, losses, err


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (the default) or cpu")
    main(device=torch.device(ap.parse_args().device))
