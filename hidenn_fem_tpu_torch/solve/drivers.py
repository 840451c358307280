"""Solve drivers (port of ``hidenn_fem_tpu/solve/drivers.py``):
``run_optimizer``, ``run_lbfgs``, ``minimize`` and ``MinimizeResult``,
and the strategies ``alternating_solve``, ``two_phase_solve`` and
``solve_with_checkpointing``.

The JAX package compiles a whole solve into one ``lax.scan``; here it is a
Python loop around one ``torch.autograd.grad`` per step.  The loop reads
nothing back from the device unless ``tol`` is set, so the host runs
ahead and the card stays busy.  The loss history holds the value at the
params *before* each update, as in the JAX drivers.  The zoom line search
is the exception: it reads every trial point's value and slope, and its
last trial's value and gradient start the next step (the JAX package's
``optax.value_and_grad_from_state``), so a step costs the search's trial
points and no more.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Optional

import torch

from . import optimizers as _opt
from .optimizers import lbfgs, ravel_params, unravel_params

__all__ = ["minimize", "run_optimizer", "run_lbfgs", "MinimizeResult",
           "alternating_solve", "two_phase_solve",
           "solve_with_checkpointing"]


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


def _value_and_grad(loss_fn: Callable, like, loss_args: tuple):
    """x -> (loss, gradient) of ``loss_fn(params, *loss_args)`` on the
    flat vector of params shaped as ``like``."""
    def vg(x):
        xg = x.detach().requires_grad_(True)
        loss = loss_fn(unravel_params(xg, like), *loss_args)
        (g,) = torch.autograd.grad(loss, xg)
        return loss.detach(), g
    return vg


def _steps(vg, optimizer, x, state, num_steps: int,
           tol: Optional[float] = None):
    """``num_steps`` updates of the flat vector ``x``; returns (x, state,
    per-step losses).  ``tol`` stops once the gradient's infinity norm
    drops below it (one device read per step)."""
    losses = []
    for _ in range(num_steps):
        loss, g = vg(x)
        step, state = optimizer.update(g, state, x)
        x = x + step
        losses.append(loss)
        if tol is not None and float(g.abs().max()) < tol:
            break
    return x, state, losses


def _linesearch_steps(vg, optimizer, x, state, num_steps: int,
                      tol: Optional[float] = None):
    """``_steps`` for a line-search optimizer (``ZoomLBFGS``): the value
    and gradient at ``x`` come from the state when the last search left
    finite ones there (optax's ``value_and_grad_from_state``)."""
    losses = []
    for _ in range(num_steps):
        ls = state.linesearch
        if torch.isfinite(ls.value):
            loss, g = ls.value, ls.grad
        else:
            loss, g = vg(x)
        step, state = optimizer.update(g, state, x, value=loss,
                                       value_fn=vg)
        x = x + step
        losses.append(loss)
        if tol is not None and float(g.abs().max()) < tol:
            break
    return x, state, losses


def _history(losses, num_steps: int) -> torch.Tensor:
    """The losses, padded with the last one to ``num_steps``."""
    history = torch.stack(losses)
    if history.shape[0] < num_steps:
        history = torch.cat([history, history[-1:].expand(
            num_steps - history.shape[0])])
    return history


def _params_out(x, like):
    final = unravel_params(x, like)
    if isinstance(final, torch.Tensor):
        return final.clone()
    return {k: v.clone() for k, v in final.items()}


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
    vg = _value_and_grad(loss_fn, params, tuple(loss_args))
    run = (_linesearch_steps if isinstance(optimizer, _opt.ZoomLBFGS)
           else _steps)
    x, _, losses = run(vg, optimizer, x, state, num_steps, tol)
    return _params_out(x, params), _history(losses, num_steps)


def run_lbfgs(loss_fn: Callable, params, num_steps: int = 600,
              memory_size: int = 100, max_linesearch_steps: int = 20,
              tol: Optional[float] = None, loss_args: tuple = (),
              linesearch: str = "none"):
    """Run L-BFGS iterations (one iteration ~ one torch inner step; the
    reference's 30 outer epochs x max_iter=20 correspond to
    ``num_steps=600``).

    ``linesearch="none"`` (default) is torch's LBFGS default, a fixed
    step lr = 1 with no line search, the configuration the measured
    baseline used; ``"zoom"`` is optax's strong-Wolfe zoom search with at
    most ``max_linesearch_steps`` trial points a step, for problems that
    need globalization.

    ``tol``: stop once the gradient's infinity norm drops below it
    (torch LBFGS's ``tolerance_grad``); the loss history is padded with
    the last value.
    """
    return run_optimizer(loss_fn, params,
                         lbfgs(memory_size=memory_size,
                               max_linesearch_steps=max_linesearch_steps,
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


def alternating_solve(loss_fn: Callable, params, outer_epochs: int = 500,
                      u_steps: int = 10, coord_steps: int = 5,
                      u_lr: float = 1e-6, coord_lr: float = 1e-7,
                      u_key: str = "u", coord_key: str = "coords"):
    """Alternating freeze scheme: optimize nodal values with the mesh
    frozen, then node coordinates with values frozen
    (``examples/example4.py:83-112`` as a first-class strategy).

    Each outer epoch runs ``u_steps`` Adam steps (rate ``u_lr``) on
    ``u_key`` with ``coord_key`` frozen, then ``coord_steps`` Adam steps
    (rate ``coord_lr``) on ``coord_key`` with ``u_key`` frozen; each Adam
    keeps its moments across epochs.  Returns (params, the last
    coordinate-step loss of each epoch [outer_epochs]).
    """
    opt_u = _opt.freeze_groups(_opt.adam(u_lr), [coord_key])
    opt_c = _opt.freeze_groups(_opt.adam(coord_lr), [u_key])
    x = ravel_params(params).detach()
    state_u = opt_u.init(x, like=params)
    state_c = opt_c.init(x, like=params)
    vg = _value_and_grad(loss_fn, params, ())
    losses = []
    for _ in range(outer_epochs):
        x, state_u, _ = _steps(vg, opt_u, x, state_u, u_steps)
        x, state_c, lc = _steps(vg, opt_c, x, state_c, coord_steps)
        losses.append(lc[-1])
    return _params_out(x, params), torch.stack(losses)


def solve_with_checkpointing(loss_fn: Callable, params, optimizer,
                             num_steps: int, checkpoint_dir: str,
                             checkpoint_every: int = 1000,
                             metrics_path: Optional[str] = None,
                             resume: bool = True,
                             n_quad_points: Optional[int] = None):
    """Long-run driver: chunked optimization with periodic checkpoints and
    JSONL metrics, resumable after a crash.

    After each chunk of ``checkpoint_every`` steps it writes
    ``ckpt_<step>.pt`` (params and optimizer state, ``utils/checkpoint``)
    into ``checkpoint_dir`` and, with ``metrics_path``, a metrics line
    (loss, wall per step, quadrature-point evaluations per second).  With
    ``resume`` it starts from ``latest_checkpoint(checkpoint_dir)``.
    Returns (params, [per-chunk loss histories]).
    """
    from ..utils import checkpoint as _ckpt
    from ..utils import metrics as _metrics

    x = ravel_params(params).detach()
    opt_state = optimizer.init(x, like=params)
    start_step = 0
    if resume:
        latest = _ckpt.latest_checkpoint(checkpoint_dir)
        if latest is not None:
            params, opt_state, start_step, _ = _ckpt.restore_checkpoint(
                latest, params, opt_state)
            x = ravel_params(params).detach()
    vg = _value_and_grad(loss_fn, params, ())

    os.makedirs(checkpoint_dir, exist_ok=True)
    writer = (_metrics.MetricsWriter(metrics_path) if metrics_path
              else None)
    all_losses = []
    step_i = start_step
    try:
        while step_i < num_steps:
            chunk = min(checkpoint_every, num_steps - step_i)
            t0 = time.perf_counter()
            x, opt_state, losses = _steps(vg, optimizer, x, opt_state,
                                          chunk)
            losses = torch.stack(losses)
            last = float(losses[-1])        # sync
            wall = (time.perf_counter() - t0) / chunk
            step_i += chunk
            all_losses.append(losses)
            _ckpt.save_checkpoint(
                os.path.join(checkpoint_dir, f"ckpt_{step_i}{_ckpt.SUFFIX}"),
                unravel_params(x, params), opt_state, step=step_i)
            if writer:
                writer.write(_metrics.solve_metrics(
                    step_i, last, wall_per_step=wall,
                    n_quad_points=n_quad_points))
    finally:
        if writer:
            writer.close()
    return _params_out(x, params), all_losses


def two_phase_solve(loss_fn: Callable, params, adam_steps: int = 1000,
                    lbfgs_steps: int = 800, u_lr: float = 1e-6,
                    coord_lr: float = 1e-7, u_key: str = "u",
                    coord_key: str = "coords"):
    """Adam warmup then L-BFGS refinement
    (``examples/example4.py:114-138`` as a first-class strategy)."""
    opt = _opt.adam_per_group({u_key: u_lr, coord_key: coord_lr})
    params, adam_losses = run_optimizer(loss_fn, params, opt, adam_steps)
    params, lbfgs_losses = run_lbfgs(loss_fn, params, lbfgs_steps)
    return params, torch.cat([adam_losses, lbfgs_losses])
