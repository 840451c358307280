"""Structured per-step metrics (port of
``hidenn_fem_tpu/utils/metrics.py``): a metrics dict per step (loss,
per-group gradient norms, min |detJ|, wall per step, quadrature-point
evaluations per second) and a JSONL writer, so runs are machine-readable.
"""

from __future__ import annotations

import json
import time
from typing import Any, Dict, Optional

import torch

from .profiling import _sync

__all__ = ["grad_norms", "solve_metrics", "MetricsWriter", "StepTimer"]


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = [tree[k] for k in sorted(tree)]
    return [leaf for t in tree for leaf in _leaves(t)]


def grad_norms(grads: Any) -> Dict[str, float]:
    """Global L2 norm per top-level parameter group."""
    return {k: float(torch.sqrt(sum(torch.sum(x * x)
                                    for x in _leaves(v))))
            for k, v in grads.items()}


def solve_metrics(step: int, loss, grads=None, model=None, params=None,
                  mesh=None, wall_per_step: Optional[float] = None,
                  n_quad_points: Optional[int] = None) -> Dict[str, Any]:
    """Assemble the standard metrics dict for one optimization step."""
    if isinstance(loss, torch.Tensor):
        loss = loss.detach()
    m: Dict[str, Any] = {"step": step, "loss": float(loss)}
    if grads is not None:
        for k, v in grad_norms(grads).items():
            m[f"grad_norm/{k}"] = v
    if model is not None and params is not None and mesh is not None \
            and hasattr(model, "min_abs_detJ"):
        with torch.no_grad():
            m["min_abs_detJ"] = float(model.min_abs_detJ(params, mesh))
    if wall_per_step is not None:
        m["wall_per_step_s"] = wall_per_step
        if n_quad_points:
            m["qp_evals_per_sec"] = n_quad_points / wall_per_step
    return m


class MetricsWriter:
    """Append-only JSONL metrics log."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "a", buffering=1)

    def write(self, metrics: Dict[str, Any]) -> None:
        self._f.write(json.dumps(metrics) + "\n")

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class StepTimer:
    """Wall-clock per block of steps (device-synchronized)."""

    def __init__(self):
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()
        return self

    def stop(self, result=None, n_steps: int = 1) -> float:
        """Seconds per step since ``start``, after waiting for
        ``result`` (its device synchronized, one scalar fetched)."""
        if result is not None:
            _sync(result)
        dt = time.perf_counter() - self._t0
        return dt / max(n_steps, 1)
