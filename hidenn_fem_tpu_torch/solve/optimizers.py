"""Optimizers on a flat parameter vector (port of
``hidenn_fem_tpu/solve/optimizers.py``): compact L-BFGS
(``scale_by_compact_lbfgs``, ``lbfgs(linesearch="none")``) and Adam
(``adam``, ``adam_per_group``, ``freeze_groups``).

An optimizer here is an object with ``init(x, like=None) -> state`` and
``update(g, state, x) -> (step, state)`` on flat [P] vectors; the driver
applies ``x + step``.  Parameters are flattened in ``ravel_pytree`` order
(sorted keys: ``coords`` then ``u``) by ``ravel_params``; a bare tensor
(the [N, 4] node table of the node-space solves) is its own flat view.
``like`` is the params template the flat vector came from (a dict of
tensors, or a bare tensor): the optax transformations that label
parameter groups by top-level key (``multi_transform``) see the pytree,
and the flat interface needs it to find a group's entries.  L-BFGS
ignores it.

The direction H g comes from the compact representation (Byrd, Nocedal &
Schnabel 1994, Thm 2.2):

    H g = gamma g + [S  gamma Y] M [S^T g; gamma Y^T g],
    M   = [[R^{-T} (D + gamma Y^T Y) R^{-1},  -R^{-T}],
           [-R^{-1},                           0     ]],

with R = triu(S^T Y) and D = diag(S^T Y): two [2m, P] matrix products
and two m-by-m triangular solves per step.  ``update`` writes the new
pair into the state's history tensors in place (the [2m, P] history is the
solve's largest buffer: 740 MB at the 922K-element plate), so a state is
consumed by the update that takes it.  The (s, y) pair goes to slot
(count-1) % m and is zero on the first call; gamma is s.y / y.y of the
newest pair, or min(1, 1/|g|) on the first call (gamma is 1 throughout
with ``scale_init_precond=False``); a pair with s.y <= 1e-10
(torch LBFGS's curvature guard) is stored as zeros, its R diagonal is
patched to 1 and gamma keeps its last accepted value.  The products run
in full float32: TF32 is off package-wide (``hidenn_fem_tpu_torch``).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

__all__ = ["CompactLBFGSState", "CompactLBFGS", "scale_by_compact_lbfgs",
           "lbfgs", "adam", "adam_per_group", "freeze_groups", "AdamState",
           "Adam", "FreezeGroups", "ravel_params", "unravel_params"]


def ravel_params(params) -> torch.Tensor:
    """Flat [P] vector of a params dict, keys in sorted order, or of a
    bare tensor."""
    if isinstance(params, torch.Tensor):
        return params.reshape(-1)
    return torch.cat([params[k].reshape(-1) for k in sorted(params)])


def unravel_params(flat: torch.Tensor, like):
    """Inverse of ``ravel_params``: views of ``flat`` shaped as ``like``
    (a dict, or a bare tensor)."""
    if isinstance(like, torch.Tensor):
        return flat.view(like.shape)
    out, i = {}, 0
    for k in sorted(like):
        n = like[k].numel()
        out[k] = flat[i:i + n].view(like[k].shape)
        i += n
    return out


class CompactLBFGSState(NamedTuple):
    count: int                 # update calls so far
    prev_flat: torch.Tensor    # [P] previous flat params
    prev_grad: torch.Tensor    # [P] previous flat gradient
    SY: torch.Tensor           # [2m, P]: rows 0..m-1 = s_i, m..2m-1 = y_i
    STY: torch.Tensor          # [m, m]: s_i . y_j
    YTY: torch.Tensor          # [m, m]: y_i . y_j
    gamma: torch.Tensor        # last accepted identity scale


class CompactLBFGS:
    """The L-BFGS direction H g (``scale_by_compact_lbfgs``), optionally
    followed by a fixed step ``-learning_rate * H g``."""

    def __init__(self, memory_size: int = 100,
                 learning_rate: float | None = None,
                 scale_init_precond: bool = True):
        if memory_size < 1:
            raise ValueError("memory_size must be >= 1")
        self.m = memory_size
        self.learning_rate = learning_rate
        self.scale_init_precond = scale_init_precond

    def init(self, x: torch.Tensor, like=None) -> CompactLBFGSState:
        m, p = self.m, x.numel()
        z = torch.zeros((p,), dtype=x.dtype, device=x.device)
        return CompactLBFGSState(
            count=0, prev_flat=z, prev_grad=z,
            SY=torch.zeros((2 * m, p), dtype=x.dtype, device=x.device),
            STY=torch.zeros((m, m), dtype=x.dtype, device=x.device),
            YTY=torch.zeros((m, m), dtype=x.dtype, device=x.device),
            gamma=torch.ones((), dtype=x.dtype, device=x.device))

    def update(self, g: torch.Tensor, state: CompactLBFGSState,
               x: torch.Tensor) -> Tuple[torch.Tensor, CompactLBFGSState]:
        m = self.m
        c = state.count
        slot = (c - 1) % m
        if c == 0:
            s = torch.zeros_like(x)
            y = torch.zeros_like(g)
        else:
            s = x - state.prev_flat
            y = g - state.prev_grad
        # torch's curvature guard: reject non-positive-curvature pairs
        accept = torch.dot(s, y) > 1e-10
        s = torch.where(accept, s, 0.0)
        y = torch.where(accept, y, 0.0)
        SY = state.SY                   # history updated in place
        SY[slot] = s
        SY[m + slot] = y

        # one pass over the history: columns are (.y, .s, .g) products
        B = SY @ torch.stack([y, s, g], dim=1)              # [2m, 3]
        s_dot_y, u = B[:m, 0], B[:m, 2]                     # S.y, S.g
        y_dot_y, y_dot_s, v = B[m:, 0], B[m:, 1], B[m:, 2]
        STY = state.STY
        STY[:, slot] = s_dot_y
        STY[slot, :] = y_dot_s
        YTY = state.YTY
        YTY[:, slot] = y_dot_y
        YTY[slot, :] = y_dot_y

        sy = torch.dot(s, y)
        yy = torch.dot(y, y)
        if not self.scale_init_precond:
            gamma = torch.ones((), dtype=g.dtype, device=g.device)
        elif c == 0:
            # first step: the capped reciprocal gradient norm
            gnorm = torch.linalg.vector_norm(g)
            gamma = torch.clamp(1.0 / torch.where(gnorm > 0, gnorm, 1.0),
                                max=1.0)
        else:
            gamma = torch.where(accept & (yy > 0.0),
                                sy / torch.where(yy > 0, yy, 1.0),
                                state.gamma)

        # chronological (oldest-first) view of the circular buffer
        order = (c + torch.arange(m, device=g.device)) % m
        A = STY[order][:, order]
        YY = YTY[order][:, order]
        d = torch.diagonal(A)
        # inert rows for empty / zero-curvature pairs (rho = 0 analog)
        R = torch.triu(A, diagonal=1) + torch.diag(
            torch.where(d == 0.0, 1.0, d))
        u_o = u[order]
        v_o = v[order]
        w1 = torch.linalg.solve_triangular(R, u_o[:, None],
                                           upper=True)[:, 0]
        t = d * w1 + gamma * (YY @ w1) - gamma * v_o
        w2 = torch.linalg.solve_triangular(R.T, t[:, None],
                                           upper=False)[:, 0]

        coef = torch.zeros((2 * m,), dtype=g.dtype, device=g.device)
        coef[order] = w2
        coef[m + order] = -gamma * w1
        hg = gamma * g + coef @ SY                          # one pass
        step = hg if self.learning_rate is None else \
            -self.learning_rate * hg
        return step, CompactLBFGSState(
            count=c + 1, prev_flat=x, prev_grad=g, SY=SY, STY=STY,
            YTY=YTY, gamma=gamma)


def scale_by_compact_lbfgs(memory_size: int = 100,
                           scale_init_precond: bool = True) -> CompactLBFGS:
    """The L-BFGS direction H g (no step size, no sign); with
    ``scale_init_precond=False`` the identity scale gamma stays 1."""
    return CompactLBFGS(memory_size, scale_init_precond=scale_init_precond)


def lbfgs(memory_size: int = 100, linesearch: str = "none",
          learning_rate: float = 1.0) -> CompactLBFGS:
    """L-BFGS with torch LBFGS's default fixed step (lr = 1, no line
    search), the reference's flagship solve."""
    if linesearch != "none":
        raise ValueError(f"linesearch {linesearch!r} is not ported yet; "
                         "only 'none' is available")
    return CompactLBFGS(memory_size, learning_rate=learning_rate)


# ------------------------------------------------------------------ Adam
def _key_ranges(like) -> dict:
    """Top-level key -> (start, end) of its entries in the flat vector of
    ``like`` (sorted-key order, as ``ravel_params``)."""
    if not isinstance(like, dict):
        raise ValueError("parameter groups need the params dict as "
                         "``like`` (keys label the groups)")
    out, i = {}, 0
    for k in sorted(like):
        n = like[k].numel()
        out[k] = (i, i + n)
        i += n
    return out


class AdamState(NamedTuple):
    count: int                 # update calls so far
    mu: torch.Tensor           # [P] first moment
    nu: torch.Tensor           # [P] second moment
    lr: torch.Tensor | float   # learning rate: a scalar or a [P] vector


class Adam:
    """optax's ``adam``: b1 0.9, b2 0.999, eps 1e-8, eps_root 0,
    bias-corrected moments, step ``-lr * mu_hat / (sqrt(nu_hat) + eps)``
    in optax's order of operations (the bias corrections ``1 - b**count``
    in the moments' precision, as optax computes them).  With
    ``group_lrs`` each top-level key of the params takes its own rate,
    which for an elementwise method is exactly optax's
    ``multi_transform`` of one Adam per group."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, learning_rate: float = 1e-3, group_lrs=None):
        self.learning_rate = learning_rate
        self.group_lrs = None if group_lrs is None else dict(group_lrs)

    def init(self, x: torch.Tensor, like=None) -> AdamState:
        lr = self.learning_rate
        if self.group_lrs is not None:
            lr = torch.empty_like(x)
            for k, (a, b) in _key_ranges(like).items():
                if k not in self.group_lrs:
                    raise KeyError(f"no learning rate for group {k!r}")
                lr[a:b] = self.group_lrs[k]
        return AdamState(count=0, mu=torch.zeros_like(x),
                         nu=torch.zeros_like(x), lr=lr)

    def update(self, g: torch.Tensor, state: AdamState, x: torch.Tensor
               ) -> Tuple[torch.Tensor, AdamState]:
        b1, b2 = self.b1, self.b2
        mu = (1 - b1) * g + b1 * state.mu
        nu = (1 - b2) * (g * g) + b2 * state.nu
        count = state.count + 1
        # optax's bias corrections 1 - b**count, in the moments' precision
        f = np.float64 if g.dtype == torch.float64 else np.float32
        mu_hat = mu / float(f(1) - f(b1) ** f(count))
        nu_hat = nu / float(f(1) - f(b2) ** f(count))
        lr = state.lr
        step = (mu_hat / (torch.sqrt(nu_hat) + self.eps)) * (-lr)
        return step, AdamState(count=count, mu=mu, nu=nu, lr=lr)


class FreezeGroups:
    """``inner`` on the entries of the params keys not in ``frozen`` (the
    inner optimizer sees only those, as optax's ``multi_transform`` gives
    them), and a zero step on the frozen keys' entries."""

    def __init__(self, inner, frozen_keys):
        self.inner = inner
        self.frozen = set(frozen_keys)

    def init(self, x: torch.Tensor, like=None):
        ranges = [r for k, r in _key_ranges(like).items()
                  if k not in self.frozen]
        active = {k: like[k] for k in sorted(like) if k not in self.frozen}
        return ranges, self.inner.init(self._take(x, ranges), like=active)

    @staticmethod
    def _take(v, ranges):
        return torch.cat([v[a:b] for a, b in ranges]) if ranges \
            else v[:0]

    def update(self, g: torch.Tensor, state, x: torch.Tensor):
        ranges, inner_state = state
        step_a, inner_state = self.inner.update(
            self._take(g, ranges), inner_state, self._take(x, ranges))
        step = torch.zeros_like(x)
        i = 0
        for a, b in ranges:
            step[a:b] = step_a[i:i + b - a]
            i += b - a
        return step, (ranges, inner_state)


def adam(learning_rate: float = 1e-3) -> Adam:
    """optax's ``adam(learning_rate)``."""
    return Adam(learning_rate)


def adam_per_group(group_lrs) -> Adam:
    """Adam with a separate learning rate per top-level parameter key:
    ``adam_per_group({"u": 1e-4, "coords": 1e-5})`` is the reference's
    two-group configuration (``examples/example4.py:54-57``)."""
    return Adam(group_lrs=group_lrs)


def freeze_groups(inner, frozen_keys) -> FreezeGroups:
    """Wrap an optimizer so that the given top-level keys receive zero
    updates (the reference's alternating freeze scheme,
    ``examples/example4.py:83-109``, as a first-class optimizer)."""
    return FreezeGroups(inner, frozen_keys)
