"""Plain conjugate gradients for K u = f, K given by its action."""

from __future__ import annotations

import torch


READ_EVERY = 50


def cg(apply_k, f: torch.Tensor, tol: float, max_iters: int):
    """u from 0 until ||f - K u|| <= tol ||f|| by the recursive residual
    (read on the host every ``READ_EVERY`` iterations), or after
    ``max_iters``; returns (u, iterations run)."""
    u = torch.zeros_like(f)
    r = f.clone()
    p = r.clone()
    rs = torch.dot(r, r)
    stop = tol * tol * float(rs)
    it = 0
    while it < max_iters:
        if it % READ_EVERY == 0 and float(rs) <= stop:
            break
        kp = apply_k(p)
        alpha = rs / torch.dot(p, kp)
        u = u + alpha * p
        r = r - alpha * kp
        rs_new = torch.dot(r, r)
        p = r + (rs_new / rs) * p
        rs = rs_new
        it += 1
    return u, it
