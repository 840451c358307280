"""Compact L-BFGS on a flat parameter vector (port of
``scale_by_compact_lbfgs`` and ``lbfgs(linesearch="none")`` from
``hidenn_fem_tpu/solve/optimizers.py``).

An optimizer here is an object with ``init(x) -> state`` and
``update(g, state, x) -> (step, state)`` on flat [P] vectors; the driver
applies ``x + step``.  Parameters are flattened in ``ravel_pytree`` order
(sorted keys: ``coords`` then ``u``) by ``ravel_params``.

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
newest pair, or min(1, 1/|g|) on the first call; a pair with s.y <= 1e-10
(torch LBFGS's curvature guard) is stored as zeros, its R diagonal is
patched to 1 and gamma keeps its last accepted value.  The products run
in full float32: TF32 is off package-wide (``hidenn_fem_tpu_torch``).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

__all__ = ["CompactLBFGSState", "CompactLBFGS", "scale_by_compact_lbfgs",
           "lbfgs", "ravel_params", "unravel_params"]


def ravel_params(params: dict) -> torch.Tensor:
    """Flat [P] vector of a params dict, keys in sorted order."""
    return torch.cat([params[k].reshape(-1) for k in sorted(params)])


def unravel_params(flat: torch.Tensor, like: dict) -> dict:
    """Inverse of ``ravel_params``: views of ``flat`` shaped as ``like``."""
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
                 learning_rate: float | None = None):
        if memory_size < 1:
            raise ValueError("memory_size must be >= 1")
        self.m = memory_size
        self.learning_rate = learning_rate

    def init(self, x: torch.Tensor) -> CompactLBFGSState:
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
        if c == 0:
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


def scale_by_compact_lbfgs(memory_size: int = 100) -> CompactLBFGS:
    """The L-BFGS direction H g (no step size, no sign)."""
    return CompactLBFGS(memory_size)


def lbfgs(memory_size: int = 100, linesearch: str = "none",
          learning_rate: float = 1.0) -> CompactLBFGS:
    """L-BFGS with torch LBFGS's default fixed step (lr = 1, no line
    search), the reference's flagship solve."""
    if linesearch != "none":
        raise ValueError(f"linesearch {linesearch!r} is not ported yet; "
                         "only 'none' is available")
    return CompactLBFGS(memory_size, learning_rate=learning_rate)
