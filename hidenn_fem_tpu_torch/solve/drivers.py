"""Solve drivers (port of ``hidenn_fem_tpu/solve/drivers.py``):
``run_optimizer``, ``run_lbfgs``, ``minimize`` and ``MinimizeResult``,
and the strategies ``alternating_solve``, ``two_phase_solve`` and
``solve_with_checkpointing``.

The JAX package compiles a whole solve into one ``lax.scan`` inside one
``jit``.  Here a step (one ``torch.autograd.grad`` through the loss, the
optimizer's update and ``x += step``) is one body, ``_step``, on a static
leaf that holds the flat params, and ``_Stepper`` drives it through
``solve/loop.py``'s ``Replayer``, which the linear solvers' while loops
share.  On the card the optimizer's first call (its ``count == 0``
branch) and one warm-up (on a side stream, under
``torch.cuda.set_sync_debug_mode("error")``) run eagerly; then one step
is recorded in a CUDA graph and replayed for every later step: the host
launches one graph a step instead of the step's hundred-odd kernels.
The loss history is written on the device by the step itself, at the
step's device count, so nothing is read back until the end unless
``tol`` is set; with ``tol`` the step also writes whether the gradient's
infinity norm fell below it, and the host reads that one flag after each
step and stops replaying (the JAX package's ``lax.cond`` mask), padding
the history with the last value.  The loss history holds the value at
the params *before* each update, as in the JAX drivers.  The kernels'
launch counters (and the collective counters of ``parallel.sharding``)
count each replay: the launches recorded at capture, times the replays.

Not captured, each decided before the first step from a stated fact:
* what ``solve/loop.py`` does not capture: tensors on the CPU (the same
  body runs eagerly there) and a process whose default
  ``torch.distributed`` group runs on gloo (one rank on NCCL is
  captured);
* an optimizer without ``capturable = True``: the zoom line search
  (``ZoomLBFGS``) reads every trial point's value and slope on the host,
  and its last trial's value and gradient start the next step (the JAX
  package's ``optax.value_and_grad_from_state``), so it stays a loop
  (``_linesearch_steps``) whose step costs the search's trial points and
  no more;
* fewer than three steps in all (the first call and the warm-up are
  eager, so nothing would be replayed).
A step that makes a host sync, or a capture that fails, raises: no path
falls back to the loop.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Optional

import torch

from ..utils.profiling import annotate
from . import loop as _loop
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
    flat vector of params shaped as ``like``; ``x`` is differentiated
    in place when it is a leaf that requires grad (the static leaf of
    ``_Stepper``), else through a fresh leaf."""
    def vg(x):
        xg = x if x.is_leaf and x.requires_grad else \
            x.detach().requires_grad_(True)
        loss = loss_fn(unravel_params(xg, like), *loss_args)
        (g,) = torch.autograd.grad(loss, xg)
        return loss.detach(), g
    return vg


def _leaf(params) -> torch.Tensor:
    """The static leaf of a solve: a copy of the flat params that the
    steps update in place."""
    return ravel_params(params).detach().clone().requires_grad_(True)


def _step(vg, optimizer, leaf, state):
    """One step on the static ``leaf``, updated in place; returns (loss,
    gradient, state)."""
    loss, g = vg(leaf)
    x = leaf.detach()
    step, state = optimizer.update(g, state, x)
    x.add_(step)
    return loss, g, state


def _capturable(optimizer, device: torch.device) -> bool:
    """Whether the steps of ``optimizer`` on ``device`` are captured (the
    module doc's list of what is not)."""
    return getattr(optimizer, "capturable", False) and _loop.capturable(
        device)


class _Stepper:
    """The steps of ``optimizer`` on the static ``leaf``: eager, or on the
    card captured once and replayed (module doc; ``solve/loop.py``).

    The body writes the step's loss into ``hist[t // every]`` (``t``: the
    stepper's device count of steps; ``every > 1`` keeps the last loss of
    each run of ``every`` steps, as ``alternating_solve`` records them)
    when ``n_hist`` is given, and with ``tol`` whether max|g| < tol into
    ``stop``.  ``state`` is the optimizer's state with its host count
    current after every ``run``."""

    def __init__(self, vg, optimizer, leaf, state, n_hist=None, every=1,
                 tol=None, capture=None):
        self.vg, self.optimizer, self.leaf, self.state = (vg, optimizer,
                                                          leaf, state)
        self.n_hist, self.every, self.tol = n_hist, every, tol
        self.hist = None
        dev = leaf.device
        self.t = torch.zeros((), dtype=torch.int64, device=dev)
        self.stop = torch.zeros((), dtype=torch.bool, device=dev)
        if capture is None:
            capture = _capturable(optimizer, dev)
        # the optimizer's first call and the warm-up run eagerly
        self.loop = _loop.Replayer(self._body, dev, capture, eager=2)

    def _body(self):
        loss, g, state = _step(self.vg, self.optimizer, self.leaf,
                               self.state)
        if self.n_hist is not None:
            if self.hist is None:
                self.hist = torch.empty(self.n_hist, dtype=loss.dtype,
                                        device=loss.device)
            i = self.t if self.every == 1 else torch.div(
                self.t, self.every, rounding_mode="floor")
            self.hist.index_copy_(0, i.view(1), loss.view(1))
        self.t.add_(1)
        if self.tol is not None:
            self.stop.copy_(g.abs().max() < self.tol)
        return state

    def run(self, n: int) -> int:
        """Up to ``n`` steps (fewer when ``tol`` stops them); returns how
        many ran."""
        done = 0
        while done < n:
            state = self.loop()
            if state is not None:           # an eager step
                self.state = state
            done += 1
            if self.tol is not None and _loop.read_flag(self.stop):
                break
        replays = self.loop.settle()
        if replays:
            self.state = self.optimizer.advance(self.state, replays)
        return done

    def history(self, done: int) -> torch.Tensor:
        """The losses of ``done`` steps, padded with the last one to
        ``n_hist`` (the JAX ``tol`` drivers' history)."""
        if self.hist is None:
            return torch.empty(0)
        if done < self.n_hist:
            self.hist[done:] = self.hist[done - 1]
        return self.hist


def _linesearch_steps(vg, optimizer, x, state, num_steps: int,
                      tol: Optional[float] = None):
    """``num_steps`` updates of ``x`` by a line-search optimizer
    (``ZoomLBFGS``), an eager loop; returns (x, state, per-step losses).
    The value and gradient at ``x`` come from the state when the last
    search left finite ones there (optax's ``value_and_grad_from_state``);
    ``tol`` stops once the gradient's infinity norm drops below it."""
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
    the same form.  On the card the steady-state step is captured in a
    CUDA graph and replayed (module doc).

    ``tol``: stop once the gradient's infinity norm drops below it; the
    history is then padded with the last value (one device read per
    step).
    """
    return _solve(loss_fn, params, optimizer, num_steps, loss_args, tol)


def _solve(loss_fn, params, optimizer, num_steps, loss_args=(), tol=None,
           capture=None):
    """``run_optimizer``; ``capture=False`` runs the same steps eagerly on
    the card (how ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` hold
    a captured solve to the loop).  Spans (``utils/profiling.annotate``):
    the solve is one ``hidenn.run_optimizer``, and the static leaf and
    the optimizer's state (the L-BFGS history's allocation) one
    ``hidenn.optimizer.init`` in it."""
    with annotate("hidenn.run_optimizer"):
        vg = _value_and_grad(loss_fn, params, tuple(loss_args))
        if isinstance(optimizer, _opt.ZoomLBFGS):
            x = ravel_params(params).detach()
            state = optimizer.init(x, like=params)
            x, _, losses = _linesearch_steps(vg, optimizer, x, state,
                                             num_steps, tol)
            history = torch.stack(losses)
            if history.shape[0] < num_steps:
                history = torch.cat([history, history[-1:].expand(
                    num_steps - history.shape[0])])
            return _params_out(x, params), history
        with annotate("hidenn.optimizer.init"):
            leaf = _leaf(params)
            state = optimizer.init(leaf.detach(), like=params)
        stepper = _Stepper(vg, optimizer, leaf, state, n_hist=num_steps,
                           tol=tol, capture=capture)
        done = stepper.run(num_steps)
        return _params_out(leaf.detach(), params), stepper.history(done)


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
    coordinate-step loss of each epoch [outer_epochs]).  On the card the
    u-step and the coordinate step are each captured once and replayed
    (two graphs on one static leaf).
    """
    opt_u = _opt.freeze_groups(_opt.adam(u_lr), [coord_key])
    opt_c = _opt.freeze_groups(_opt.adam(coord_lr), [u_key])
    leaf = _leaf(params)
    x = leaf.detach()
    vg = _value_and_grad(loss_fn, params, ())
    u_phase = _Stepper(vg, opt_u, leaf, opt_u.init(x, like=params))
    c_phase = _Stepper(vg, opt_c, leaf, opt_c.init(x, like=params),
                       n_hist=outer_epochs, every=coord_steps)
    for _ in range(outer_epochs):
        u_phase.run(u_steps)
        c_phase.run(coord_steps)
    return _params_out(x, params), c_phase.history(outer_epochs)


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
    Returns (params, [per-chunk loss histories]).  On the card the step
    captured in the first chunk is replayed in every later one; the
    optimizer state's host count stays current, so each checkpoint
    records it.
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
    leaf = _leaf(params)
    vg = _value_and_grad(loss_fn, params, ())
    stepper = _Stepper(vg, optimizer, leaf, opt_state,
                       n_hist=max(num_steps - start_step, 0))

    os.makedirs(checkpoint_dir, exist_ok=True)
    writer = (_metrics.MetricsWriter(metrics_path) if metrics_path
              else None)
    all_losses = []
    step_i = start_step
    try:
        while step_i < num_steps:
            chunk = min(checkpoint_every, num_steps - step_i)
            t0 = time.perf_counter()
            stepper.run(chunk)
            a = step_i - start_step
            losses = stepper.hist[a:a + chunk]
            last = float(losses[-1])        # sync
            wall = (time.perf_counter() - t0) / chunk
            step_i += chunk
            all_losses.append(losses)
            _ckpt.save_checkpoint(
                os.path.join(checkpoint_dir, f"ckpt_{step_i}{_ckpt.SUFFIX}"),
                unravel_params(leaf.detach(), params), stepper.state,
                step=step_i)
            if writer:
                writer.write(_metrics.solve_metrics(
                    step_i, last, wall_per_step=wall,
                    n_quad_points=n_quad_points))
    finally:
        if writer:
            writer.close()
    return _params_out(leaf.detach(), params), all_losses


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
