"""Matrix-free conjugate-gradient solve of quadratic energies (port of
``hidenn_fem_tpu/solve/linear.py``).

At fixed node coordinates the plate energy is quadratic in the nodal
values: minimizing it is the classic displacement FEM solve K u = f, and
CG is the Krylov method for it.  The stiffness matvec needs neither K nor
forward-mode AD:

    K v = grad(p0 + v) - grad(p0)

which is exact for quadratic losses (the gradient is affine).  It uses
reverse mode only, which is all the kernels' autograd Functions (K1/K2,
K4, K6) offer, so every CG iteration is one value-and-grad of the
production energy on whatever route the mesh takes.  Each gradient is
taken with ``torch.autograd.grad`` on a fresh graph, which frees it.

Fixed (Dirichlet) degrees of freedom need no special casing: the masked
parameter reconstruction gives them exactly-zero gradients, so every
Krylov vector stays in the free subspace.

The JAX package runs the iterations inside a ``while_loop``.  Here one
iteration is one body, ``_pcg``'s, that updates static tensors in place
and masks itself: it computes JAX's condition (``i < max_iters``,
``rs > tol^2 rs0``, ``rs > atol^2``, on the device in the residual's
dtype) into a device flag, and once the flag is false a call changes no
carried tensor and no history entry, bit for bit.  ``solve/loop.py``
runs it: on the card one iteration is recorded in a CUDA graph after an
eager warm-up and replayed, and the host reads the flag once every
``loop.READ_EVERY`` iterations (the CPU runs the same body eagerly, with
the same reads); a solve allowed fewer than ``loop.MIN_CAPTURED``
iterations stays eager.  The calls past the stop are masked device work
and launch their kernels like any other (the launch counters count
them).  The carried tensors, the start and the iteration make a
``PCGLoop``: a solve makes one and drops it, except where a solver keeps
one as its plan (a loop with a key) on a holder for the next solve,
which then records the start once too and only replays.  The multigrid
solver keeps its plan on a hierarchy and the auxiliary-space solver on
its preconditioner, both through ``take_plan`` and ``hold_plan``.
The Jacobi diagonal's colored probing is set-up and stays eager.  The
history has ``max_iters`` entries and holds zeros for iterations never
run.  Params are dicts of tensors; leaves are taken in sorted-key order,
as ``jax.tree.leaves`` orders a dict.
"""

from __future__ import annotations

import functools
from typing import Callable, Tuple

import torch

from ..utils.profiling import annotate
from . import loop as _loop

__all__ = ["cg_solve", "radapt_cg_solve", "jacobi_diagonal",
           "jacobi_pcg_solve"]

_TINY = 1e-30


def _tree_dot(a: dict, b: dict) -> torch.Tensor:
    out = None
    for k in sorted(a):
        d = torch.dot(a[k].reshape(-1), b[k].reshape(-1))
        out = d if out is None else out + d
    return out


def _tree_axpy(alpha, x: dict, y: dict) -> dict:
    """y + alpha * x, leafwise."""
    return {k: y[k] + alpha * x[k] for k in y}


def _grad(loss_fn: Callable, params: dict, loss_args: tuple) -> dict:
    """d loss / d params (zeros for leaves the loss does not use)."""
    keys = sorted(params)
    leaves = [params[k].detach().requires_grad_(True) for k in keys]
    loss = loss_fn(dict(zip(keys, leaves)), *loss_args)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return {k: torch.zeros_like(leaf) if g is None else g
            for k, leaf, g in zip(keys, leaves, grads)}


class _Carried:
    """The carried tensors of one PCG loop: ``r`` as given (dicts of
    leaves), x and p shaped like it, the 0-dim dots, the history
    [max_iters + 1], the counter and the stop flag."""

    def __init__(self, r: dict, max_iters: int):
        # the dots' dtype: ``dot`` sums products of the leaves
        dt = functools.reduce(torch.promote_types,
                              (v.dtype for v in r.values()))
        dev = next(iter(r.values())).device
        self.r = r
        self.x = {k: torch.empty_like(v) for k, v in r.items()}
        self.p = {k: torch.empty_like(v) for k, v in r.items()}
        self.rs0, self.rz, self.rs, self.thresh = (
            torch.empty((), dtype=dt, device=dev) for _ in range(4))
        # hist[max_iters] takes the masked iterations' writes
        self.hist = torch.empty((max_iters + 1,), dtype=dt, device=dev)
        self.i = torch.empty((), dtype=torch.int64, device=dev)
        self.active = torch.empty((), dtype=torch.bool, device=dev)


def _bodies(matvec, precond, dot, c: _Carried, max_iters: int, tol: float,
            atol: float):
    """(start, body) of the PCG loop on the carried tensors ``c``, each
    updating them in place.  ``start``: the first preconditioner
    application, p = z, x = 0, the dots, the history and counter cleared,
    the flag; ``body``: one masked iteration."""
    x, r, p, rs0, rz, rs = c.x, c.r, c.p, c.rs0, c.rz, c.rs
    hist, thresh, i, active = c.hist, c.thresh, c.i, c.active

    def cond():
        return (i < max_iters) & (rs > thresh) & (rs > atol * atol)

    def start():
        z = precond(r)
        for k in r:
            # p must not share storage with r (precond may be the identity)
            p[k].copy_(z[k])
            x[k].zero_()
        rs0.copy_(dot(r, r))
        rz.copy_(dot(r, z))
        rs.copy_(rs0)
        hist.zero_()
        torch.mul(rs0, tol * tol, out=thresh)
        i.zero_()
        active.copy_(cond())

    def body():
        Ap = matvec(p)
        pAp = dot(p, Ap)
        alpha = torch.where(pAp > 0, rz / torch.clamp_min(pAp, _TINY),
                            torch.zeros_like(pAp))
        x_new = _tree_axpy(alpha, p, x)
        r_new = _tree_axpy(-alpha, Ap, r)
        z = precond(r_new)
        rz_new = dot(r_new, z)
        beta = rz_new / torch.clamp_min(rz, _TINY)
        p_new = {k: z[k] + beta * p[k] for k in z}
        rs_new = dot(r_new, r_new)
        # past the stop every carried tensor keeps its bits
        for old, new in ((x, x_new), (r, r_new), (p, p_new)):
            for k in old:
                torch.where(active, new[k], old[k], out=old[k])
        for old, new in ((rz, rz_new), (rs, rs_new)):
            torch.where(active, new, old, out=old)
        hist.index_copy_(0, torch.where(active, i, max_iters).view(1),
                         torch.sqrt(rs_new / torch.clamp_min(rs0, _TINY)
                                    ).view(1))
        i.add_(active.to(i.dtype))
        active.copy_(cond())

    return start, body


class PCGLoop:
    """The JAX package's PCG ``while_loop`` of one system (``matvec``,
    ``precond``, ``dot``, ``max_iters``, ``tol``, ``atol``; module doc),
    run from x = 0 by calls on a residual: its carried tensors (the first
    call's ``r`` becomes the carried residual), its start and its masked
    iteration, which a ``loop.Replayer`` runs through ``loop.while_loop``.
    A loop with a ``key`` is a kept plan, which serves repeated solves of
    that key: a ``Replayer`` runs the start too and both are kept, so on
    the card the first call warms up both bodies and records the
    iteration, the second records the start, and every later call copies
    its residual in and replays the two graphs.  Without a key the start
    runs eagerly and the loop serves one call.  The closures hold the
    carried tensors, never the loop, so dropping the loop frees its
    graphs without a collection."""

    def __init__(self, matvec, precond, dot, r: dict, max_iters: int,
                 tol: float, atol: float = 0.0, key=None):
        self.matvec, self.precond, self.dot = matvec, precond, dot
        self.max_iters, self.tol, self.key = max_iters, tol, key
        self.carried = _Carried(r, max_iters)
        start, body = _bodies(matvec, precond, dot, self.carried, max_iters,
                              tol, atol)
        self.device = self.carried.rs0.device
        capture = (_loop.capturable(self.device)
                   and max_iters >= _loop.MIN_CAPTURED)
        self.body = _loop.Replayer(body, self.device, capture)
        self.start = (start if key is None
                      else _loop.Replayer(start, self.device, capture))

    def __call__(self, r: dict):
        """One solve from x = 0 and the residual ``r``: (x, relres history
        [max_iters]).  x is the carried tensor; on a kept loop the history
        is a copy, so a later call changes neither what an earlier one
        returned nor what its caller made of x."""
        c, kept = self.carried, self.key is not None
        for k, v in r.items():
            if v is not c.r[k]:
                c.r[k].copy_(v)
        with annotate("hidenn.pcg.start"):
            self.start()
            if kept:
                self.start.settle()
        _loop.while_loop(self.body, c.active, self.max_iters, self.device)
        hist = c.hist[:self.max_iters]
        return c.x, hist.clone() if kept else hist


def take_plan(holder, key):
    """The kept ``PCGLoop`` on ``holder`` (a ``plan`` attribute, frozen or
    not) if its key is ``key``, else None.  The holder keeps none: a solve
    that raises leaves none, and a plan of another key is dropped here,
    before a new plan records its graphs."""
    plan = holder.plan
    object.__setattr__(holder, "plan", None)
    return plan if plan is not None and plan.key == key else None


def hold_plan(holder, plan: PCGLoop):
    """Keep ``plan`` on ``holder`` for its next solve (``take_plan``)."""
    object.__setattr__(holder, "plan", plan)


def _pcg(matvec, precond, dot, r: dict, max_iters: int, tol: float,
         atol: float = 0.0, loop: "PCGLoop | None" = None):
    """The JAX package's PCG ``while_loop`` from x = 0 and the residual
    ``r`` (a dict of tensors; ``matvec``, ``precond`` map such dicts and
    ``dot`` two of them to a 0-dim tensor), one masked body run by
    ``loop.while_loop`` (module doc).  Returns (x, relres history
    [max_iters]).  ``loop``: a ``PCGLoop`` of these same arguments (bar
    ``r``), run from ``r``; None runs a ``PCGLoop`` made for this call.
    What comes before the iterations (the first preconditioner
    application, the dots, the carried tensors) is a ``hidenn.pcg.start``
    span."""
    if loop is None:
        loop = PCGLoop(matvec, precond, dot, r, max_iters, tol, atol)
    return loop(r)


def _cg(loss_fn, max_iters: int, tol: float, params: dict,
        loss_args: tuple, dinv=None, atol: float = 0.0):
    params = {k: v.detach() for k, v in params.items()}
    g0 = _grad(loss_fn, params, loss_args)

    def matvec(v):
        gv = _grad(loss_fn, _tree_axpy(1.0, v, params), loss_args)
        return {k: gv[k] - g0[k] for k in gv}

    def precond(r):
        return r if dinv is None else {k: dinv[k] * r[k] for k in r}

    x, hist = _pcg(matvec, precond, _tree_dot,
                   {k: -g for k, g in g0.items()}, max_iters, tol, atol)
    return {k: params[k] + x[k] for k in params}, hist


def _jacobi_diag(loss_fn, n_colors: int, params: dict, loss_args: tuple,
                 colors: torch.Tensor) -> dict:
    """Exact diag(K) by colored probing (``mesh/coloring.py``): one
    matvec per (color, leaf, component).  Leafwise probing is exact for
    multi-leaf params too: the probed positions of the probed leaf's
    gradient rows see only same-leaf, same-component, same-color
    couplings, that is the diagonal."""
    params = {k: v.detach() for k, v in params.items()}
    g0 = _grad(loss_fn, params, loss_args)
    keys = sorted(params)
    diags = {k: torch.zeros_like(params[k]) for k in keys}
    for c in range(n_colors):
        for k in keys:
            leaf = params[k]
            mask = (colors == c).to(leaf.dtype)
            for comp in range(leaf.shape[-1]):
                zl = torch.zeros_like(leaf)
                zl[..., comp] = mask
                zs = {kk: torch.zeros_like(params[kk]) for kk in keys}
                zs[k] = zl
                gz = _grad(loss_fn, _tree_axpy(1.0, zs, params), loss_args)
                diags[k] = diags[k] + zl * (gz[k] - g0[k])
    return diags


def jacobi_diagonal(loss_fn: Callable, params, loss_args: tuple,
                    node_colors) -> dict:
    """Exact stiffness diagonal of a quadratic ``loss_fn`` at ``params``
    (matrix-free; ``n_colors * n_components`` gradient evaluations).
    ``node_colors`` is a proper coloring of the stiffness sparsity graph
    (``mesh.coloring.color_nodes``; an array or a tensor); every leaf of
    ``params`` must be node-indexed ``[N, C]``."""
    leaf = params[sorted(params)[0]]
    colors = torch.as_tensor(node_colors, device=leaf.device)
    n_colors = int(colors.max()) + 1 if colors.numel() else 1
    return _jacobi_diag(loss_fn, n_colors, params, tuple(loss_args), colors)


def jacobi_pcg_solve(loss_fn: Callable, params, loss_args: tuple = (),
                     mesh=None, node_colors=None, max_iters: int = 500,
                     tol: float = 1e-6, atol: float = 0.0
                     ) -> Tuple[dict, torch.Tensor]:
    """Jacobi-preconditioned CG: ``cg_solve`` with ``M = diag(K)``
    extracted exactly by colored probing.  Pass either a ``TriMesh``
    (colors computed from its connectivity) or a precomputed
    ``node_colors``.  Plain CG is already well-scaled on uniform meshes;
    Jacobi pays off when element sizes vary (r-adapted or graded meshes)
    or materials are heterogeneous."""
    with annotate("hidenn.jacobi_pcg_solve"):
        if node_colors is None:
            from ..mesh.coloring import color_nodes
            node_colors = color_nodes(mesh.connectivity, mesh.n_nodes)
        diag = jacobi_diagonal(loss_fn, params, loss_args, node_colors)
        dinv = {k: torch.where(d > _TINY, 1.0 / torch.clamp_min(d, _TINY),
                               torch.zeros_like(d))
                for k, d in diag.items()}
        return _cg(loss_fn, int(max_iters), float(tol), params,
                   tuple(loss_args), dinv=dinv, atol=float(atol))


def cg_solve(loss_fn: Callable, params, loss_args: tuple = (),
             max_iters: int = 500, tol: float = 1e-6, atol: float = 0.0
             ) -> Tuple[dict, torch.Tensor]:
    """Minimize a quadratic loss by conjugate gradients (module doc): the
    direct FEM solve of the fixed-mesh displacement problem.

    Args:
      loss_fn: ``loss_fn(params, *loss_args) -> scalar``, quadratic in
        every leaf of ``params``.  Freeze non-quadratic parameter groups
        by threading them through ``loss_args`` (e.g.
        ``lambda p, coords, mesh: energy({"u": p["u"],
        "coords": coords}, mesh)``).
      params: initial guess, a dict of tensors (the solve returns
        params + K^{-1} r).
      max_iters: Krylov iteration cap; the loop exits at convergence.
      tol: relative-residual stop, ||r|| <= tol * ||r0||.
      atol: absolute-residual floor (also stops when ||r|| <= atol).
        float32 residuals stall around 1e-6 relative on these problems,
        so a tighter ``tol`` alone burns the whole iteration cap on
        noise; set ``atol`` to the noise floor to exit instead.

    Returns:
      (solution dict, per-iteration relative residual norms [max_iters],
      zero for iterations never run).
    """
    with annotate("hidenn.cg_solve"):
        return _cg(loss_fn, int(max_iters), float(tol), params,
                   tuple(loss_args), atol=float(atol))


def radapt_cg_solve(loss_fn: Callable, params, loss_args: tuple = (),
                    outer_epochs: int = 10, cg_iters: int = 400,
                    cg_tol: float = 1e-6, coord_steps: int = 20,
                    coord_lr: float = 1e-7, u_key: str = "u",
                    coord_key: str = "coords"
                    ) -> Tuple[dict, torch.Tensor]:
    """r-adaptivity with exact inner displacement solves: each outer
    epoch (1) CG-solves the displacement system at the current mesh
    (``cg_solve``), then (2) takes ``coord_steps`` Adam steps on the node
    coordinates at the solved displacements (the reference's alternating
    scheme, ``examples/example4.py:83-112``, with the value phase solved
    exactly).  ``loss_fn(params, *loss_args)`` must be quadratic in
    ``params[u_key]`` at fixed ``params[coord_key]``.

    Returns (params, per-epoch energies at the equilibrated states).
    """
    from . import optimizers as _opt
    from .drivers import run_optimizer

    opt_c = _opt.freeze_groups(_opt.adam(coord_lr), [u_key])

    def u_loss(pu, coords, *a):
        return loss_fn({u_key: pu[u_key], coord_key: coords}, *a)

    energies = []
    for _ in range(outer_epochs):
        coords0 = params[coord_key]
        pu, _ = cg_solve(u_loss, {u_key: params[u_key]},
                         loss_args=(coords0,) + tuple(loss_args),
                         max_iters=cg_iters, tol=cg_tol)
        params = {u_key: pu[u_key], coord_key: coords0}
        with torch.no_grad():
            energies.append(loss_fn(params, *loss_args))
        params, _ = run_optimizer(loss_fn, params, opt_c, coord_steps,
                                  tuple(loss_args))
    return params, torch.stack(energies)
