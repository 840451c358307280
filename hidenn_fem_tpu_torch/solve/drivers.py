"""Solve drivers (port of ``run_optimizer``, ``run_lbfgs``, ``minimize``
and ``MinimizeResult`` from ``hidenn_fem_tpu/solve/drivers.py``).

The JAX package compiles a whole solve into one ``lax.scan``; here it is a
Python loop around one ``torch.autograd.grad`` per step.  The loop reads
nothing back from the device unless ``tol`` is set, so the host runs
ahead and the card stays busy.  The loss history holds the value at the
params *before* each update, as in the JAX drivers.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from . import optimizers as _opt
from .optimizers import lbfgs, ravel_params, unravel_params

__all__ = ["minimize", "run_optimizer", "run_lbfgs", "MinimizeResult"]


class MinimizeResult(tuple):
    """Result of :func:`minimize`: unpacks like the 2-tuple
    ``(params, history)`` every driver returns, with a ``kind``
    attribute naming what ``history`` holds: ``"loss"`` (per-step loss,
    methods adam/lbfgs) or ``"relres"`` (per-iteration relative residual
    norms, methods cg/jacobi_cg)."""

    def __new__(cls, params, history, kind):
        obj = super().__new__(cls, (params, history))
        obj.kind = kind
        return obj

    @property
    def params(self):
        return self[0]

    @property
    def history(self):
        return self[1]


def run_optimizer(loss_fn: Callable, params, optimizer,
                  num_steps: int, loss_args: tuple = (),
                  tol: Optional[float] = None):
    """Run ``optimizer`` (``init``/``update`` on flat vectors) for
    ``num_steps`` on ``loss_fn(params, *loss_args)``; returns
    (final params, per-step loss history [num_steps]).  ``params`` is a
    dict of tensors or a bare tensor, and the final params come back in
    the same form.

    ``tol``: stop once the gradient's infinity norm drops below it; the
    history is then padded with the last value (one device read per
    step).
    """
    x = ravel_params(params).detach()
    state = optimizer.init(x, like=params)
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
    final = unravel_params(x, params)
    if isinstance(final, torch.Tensor):
        return final.clone(), history
    return {k: v.clone() for k, v in final.items()}, history


def run_lbfgs(loss_fn: Callable, params, num_steps: int = 600,
              memory_size: int = 100, tol: Optional[float] = None,
              loss_args: tuple = (), linesearch: str = "none"):
    """Fixed-step L-BFGS (torch LBFGS's default lr = 1, no line search);
    ``num_steps=600`` matches the reference's 30 epochs x max_iter 20."""
    return run_optimizer(loss_fn, params,
                         lbfgs(memory_size=memory_size,
                               linesearch=linesearch),
                         num_steps, loss_args=loss_args, tol=tol)


def minimize(loss_fn: Callable, params, method: str = "adam",
             num_steps: int = 1000, learning_rate: float = 1e-3,
             group_lrs: Optional[dict] = None, loss_args: tuple = (),
             **kwargs) -> MinimizeResult:
    """One-call solve front end.

    method: "adam" (with ``group_lrs`` for the two-group scheme,
    ``examples/example4.py:54-57``), "lbfgs", "cg" or "jacobi_cg"
    (matrix-free conjugate gradients, optionally Jacobi-preconditioned by
    colored probing; only for losses quadratic in ``params``, see
    ``solve/linear.py``; "jacobi_cg" needs ``mesh=`` or
    ``node_colors=``; both return relative residual norms, not losses).
    Returns a :class:`MinimizeResult` whose ``.kind`` says which.
    """
    if method == "adam":
        opt = (_opt.adam_per_group(group_lrs) if group_lrs
               else _opt.adam(learning_rate))
        return MinimizeResult(
            *run_optimizer(loss_fn, params, opt, num_steps, loss_args),
            kind="loss")
    if method == "lbfgs":
        return MinimizeResult(
            *run_lbfgs(loss_fn, params, num_steps, loss_args=loss_args,
                       **kwargs), kind="loss")
    if method == "cg":
        from .linear import cg_solve
        return MinimizeResult(
            *cg_solve(loss_fn, params, loss_args=loss_args,
                      max_iters=num_steps, **kwargs), kind="relres")
    if method == "jacobi_cg":
        from .linear import jacobi_pcg_solve
        return MinimizeResult(
            *jacobi_pcg_solve(loss_fn, params, loss_args=loss_args,
                              max_iters=num_steps, **kwargs),
            kind="relres")
    raise ValueError(f"unknown method {method!r}")
