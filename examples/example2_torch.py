"""Example 2 through the PyTorch port: 2D L2 projection of
sin(2 pi x) cos(2 pi y) onto a structured bilinear FE space with per-axis
r-adaptivity.

The recipe of ``examples/example2.py``: 25x25 grid on [0, 1]^2, 100x100
collocation points, a minibatch of 1000 of them per epoch, Adam lr 5e-3,
5000 epochs.  The minibatch indices come from a ``torch.Generator`` seeded
with ``cfg.seed``, or from ``batches`` ([epochs, batch_size] indices) when
given, so that a run can replay another's.  It prints the same lines as
the JAX example, plus the final MSE over all collocation points, and
draws its two figures into ``outdir`` when matplotlib imports.

Run: ``python -m examples.example2_torch`` (on the card; ``--device cpu``
for the CPU)
"""

import argparse
import math
import os
import time

import numpy as np
import torch

import hidenn_fem_tpu_torch as ht
from hidenn_fem_tpu_torch.config import Projection2DConfig
from hidenn_fem_tpu_torch.solve.optimizers import (ravel_params,
                                                   unravel_params)

from .example1_torch import plots_module


def main(cfg: Projection2DConfig = Projection2DConfig(), outdir="out",
         device="cuda", params=None, batches=None):
    """Trains from ``params`` (the model's own N(0, 1) init from
    ``cfg.seed`` when None); returns (model, params, minibatch losses
    [epochs] as numpy, MSE over all collocation points)."""
    model, init = ht.Bilinear2D.create(
        np.linspace(0, 1, cfg.nx), np.linspace(0, 1, cfg.ny),
        r_adapt=cfg.r_adapt,
        generator=torch.Generator().manual_seed(cfg.seed), device=device)
    params = init if params is None else params

    g = torch.linspace(0, 1, cfg.n_train_1d, device=device)
    XX, YY = torch.meshgrid(g, g, indexing="ij")
    x_train = torch.stack([XX.reshape(-1), YY.reshape(-1)], dim=1)
    u_true = torch.sin(2 * math.pi * x_train[:, 0]) \
        * torch.cos(2 * math.pi * x_train[:, 1])
    if batches is not None:
        batches = torch.as_tensor(batches, device=device).long()
    gen = torch.Generator(device=device).manual_seed(cfg.seed)

    opt = ht.adam(cfg.learning_rate)
    flat = ravel_params(params).detach()
    state = opt.init(flat, like=params)
    losses = []
    t0 = time.perf_counter()
    for epoch in range(cfg.epochs):
        idx = batches[epoch] if batches is not None else torch.randint(
            0, x_train.shape[0], (cfg.batch_size,), generator=gen,
            device=device)
        xg = flat.detach().requires_grad_(True)
        loss = ht.l2_loss(model, unravel_params(xg, params), x_train[idx],
                          u_true[idx])
        (grad,) = torch.autograd.grad(loss, xg)
        step, state = opt.update(grad, state, flat)
        flat = flat + step
        losses.append(loss.detach())
    losses = torch.stack(losses).cpu().numpy()
    seconds = time.perf_counter() - t0
    params = {k: v.clone() for k, v in unravel_params(flat, params).items()}
    for epoch in range(0, cfg.epochs, 500):
        print(f"Epoch {epoch}: loss={losses[epoch]:.6f}")
    print(f"Final minibatch MSE: {losses[-1]:.3e}")
    with torch.no_grad():
        mse = float(ht.l2_loss(model, params, x_train, u_true))
    print(f"Final MSE over all {x_train.shape[0]} points: {mse:.3e}")
    print(f"Training seconds ({device}): {seconds:.3f}")

    plots = plots_module()
    if plots is not None:
        os.makedirs(outdir, exist_ok=True)
        exact2d = lambda X, Y: (np.sin(2 * np.pi * X)  # noqa: E731
                                * np.cos(2 * np.pi * Y))
        plots.plot_2d_solution(model, params, u_exact=exact2d,
                               save_path=f"{outdir}/example2_solution.png")
        plots.plot_2d_derivatives(
            model, params, n_eval=50, title="FEM Derivatives",
            save_path=f"{outdir}/example2_derivatives.png")
    return model, params, losses, mse


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (the default) or cpu")
    main(device=torch.device(ap.parse_args().device))
