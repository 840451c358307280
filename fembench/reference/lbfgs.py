"""Plain L-BFGS with a fixed step of 1 and no line search, the direction
from the compact representation (Byrd, Nocedal & Schnabel 1994, Thm 2.2).

The configuration's stated semantics (torch's LBFGS default, as the
reference example runs it): at step k with gradient g_k, the pair
(s, y) = (x_k - x_{k-1}, g_k - g_{k-1}) enters a memory of the last m
pairs, oldest first (the first step enters a zero pair); a pair with
s . y <= 1e-10 is kept as a zero pair.  gamma is min(1, 1/|g_0|) at the
first step, then s . y / y . y of the newest accepted pair.  With S and Y
the memory's nonzero pairs as rows (zero pairs add nothing),
R = triu(S Y^T), D = diag(S Y^T):

    H g = gamma g + S^T w2 - gamma Y^T w1,
    w1  = R^{-1} S g,
    w2  = R^{-T} ((D + gamma Y Y^T) w1 - gamma Y g),

and x_{k+1} = x_k - H g.  Products run through ``prec.mm``.  The memory
is a ring of m rows: the k-th pair goes to row k mod m, and the products
run over the whole ring, so a zero row (empty, or a zero pair) adds
nothing; the m-by-m solves take the live rows, oldest first.
"""

from __future__ import annotations

import torch


class CompactLBFGS:
    def __init__(self, memory_size: int, prec):
        self.m, self.prec = memory_size, prec
        self.S = self.Y = None
        self.live = [False] * memory_size
        self.n = 0                  # pairs entered so far
        self.prev = None
        self.gamma = None

    def _enter(self, s, y, accepted: bool):
        if self.S is None:
            self.S = s.new_zeros((self.m, s.numel()))
            self.Y = s.new_zeros((self.m, s.numel()))
        row = self.n % self.m
        self.S[row], self.Y[row] = s, y
        self.live[row] = accepted
        self.n += 1

    def _rows(self) -> list:
        """The live rows, oldest pair first."""
        first = max(0, self.n - self.m)
        return [k % self.m for k in range(first, self.n)
                if self.live[k % self.m]]

    def step(self, x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        """The new iterate from ``x`` and its gradient ``g``."""
        mm = self.prec.mm
        if self.prev is None:
            zero = torch.zeros_like(x)
            self._enter(zero, zero, False)
            self.gamma = torch.clamp(1.0 / torch.linalg.vector_norm(g),
                                     max=1.0)
        else:
            s, y = x - self.prev[0], g - self.prev[1]
            sy, yy = torch.dot(s, y), torch.dot(y, y)
            ok = float(sy) > 1e-10 and float(yy) > 0.0
            if ok:
                self.gamma = sy / yy
                self._enter(s, y, True)
            else:
                zero = torch.zeros_like(x)
                self._enter(zero, zero, False)
        self.prev = (x, g)
        rows = self._rows()
        hg = self.gamma * g
        if rows:
            S, Y = self.S, self.Y
            idx = torch.tensor(rows, device=x.device)
            SYt = mm(S, Y.T)[idx][:, idx]
            YYt = mm(Y, Y.T)[idx][:, idx]
            R = torch.triu(SYt)
            Sg = mm(S, g[:, None])[idx]
            Yg = mm(Y, g[:, None])[idx]
            w1 = torch.linalg.solve_triangular(R, Sg, upper=True)
            t = (torch.diagonal(SYt)[:, None] * w1
                 + self.gamma * mm(YYt, w1) - self.gamma * Yg)
            w2 = torch.linalg.solve_triangular(R.T, t, upper=False)
            c2 = torch.zeros((self.m, 1), dtype=x.dtype, device=x.device)
            c1 = torch.zeros_like(c2)
            c2[idx], c1[idx] = w2, w1
            hg = hg + mm(S.T, c2)[:, 0] - self.gamma * mm(Y.T, c1)[:, 0]
        return x - hg


def replay(value_and_grad, x0: torch.Tensor, memory_size: int,
           steps: int, prec):
    """The losses at the first ``steps`` iterates from ``x0`` (the loss at
    each iterate before its update, as the solve's history holds it)."""
    opt = CompactLBFGS(memory_size, prec)
    x, losses = x0, []
    for _ in range(steps):
        v, g = value_and_grad(x)
        losses.append(v.detach())
        x = opt.step(x, g)
    return [float(v) for v in torch.stack(losses).cpu()]
