"""Solve drivers (port of ``run_optimizer`` and ``run_lbfgs`` from
``hidenn_fem_tpu/solve/drivers.py``).

The JAX package compiles a whole solve into one ``lax.scan``; here it is a
Python loop around one ``torch.autograd.grad`` per step.  The loop reads
nothing back from the device unless ``tol`` is set, so the host runs
ahead and the card stays busy.  The loss history holds the value at the
params *before* each update, as in the JAX drivers.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from .optimizers import lbfgs, ravel_params, unravel_params

__all__ = ["run_optimizer", "run_lbfgs"]


def run_optimizer(loss_fn: Callable, params: dict, optimizer,
                  num_steps: int, loss_args: tuple = (),
                  tol: Optional[float] = None
                  ) -> Tuple[dict, torch.Tensor]:
    """Run ``optimizer`` (``init``/``update`` on flat vectors) for
    ``num_steps`` on ``loss_fn(params, *loss_args)``; returns
    (final params, per-step loss history [num_steps]).

    ``tol``: stop once the gradient's infinity norm drops below it; the
    history is then padded with the last value (one device read per
    step).
    """
    x = ravel_params(params).detach()
    state = optimizer.init(x)
    losses = []
    for _ in range(num_steps):
        xg = x.detach().requires_grad_(True)
        loss = loss_fn(unravel_params(xg, params), *loss_args)
        (g,) = torch.autograd.grad(loss, xg)
        step, state = optimizer.update(g, state, x)
        x = x + step
        losses.append(loss.detach())
        if tol is not None and float(g.abs().max()) < tol:
            break
    history = torch.stack(losses)
    if history.shape[0] < num_steps:
        history = torch.cat([history, history[-1:].expand(
            num_steps - history.shape[0])])
    return {k: v.clone() for k, v in unravel_params(x, params).items()}, \
        history


def run_lbfgs(loss_fn: Callable, params: dict, num_steps: int = 600,
              memory_size: int = 100, tol: Optional[float] = None,
              loss_args: tuple = (), linesearch: str = "none"
              ) -> Tuple[dict, torch.Tensor]:
    """Fixed-step L-BFGS (torch LBFGS's default lr = 1, no line search);
    ``num_steps=600`` matches the reference's 30 epochs x max_iter 20."""
    return run_optimizer(loss_fn, params,
                         lbfgs(memory_size=memory_size,
                               linesearch=linesearch),
                         num_steps, loss_args=loss_args, tol=tol)
