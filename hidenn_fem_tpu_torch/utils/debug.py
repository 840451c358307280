"""Numerical-sanity utilities (port of ``hidenn_fem_tpu/utils/debug.py``):
autograd's anomaly mode for NaN production, a finite-check over nested
params, and a gradient smoke check that mirrors the reference helper
(``src/utils.py:83-96`` ``test_gradients``).
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from .metrics import grad_norms

__all__ = ["enable_nan_debugging", "assert_all_finite", "check_gradients"]


def enable_nan_debugging(enable: bool = True) -> None:
    """Trap NaN production in backward passes
    (``torch.autograd.set_detect_anomaly``, the counterpart of
    ``jax_debug_nans``)."""
    torch.autograd.set_detect_anomaly(enable)


def _flatten_with_path(tree, path=""):
    """(key path, leaf) pairs, the path spelled as ``jax.tree_util
    .keystr`` spells it: ``['key']``, ``[0]`` and ``.field``."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten_with_path(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k in tree._fields:
            yield from _flatten_with_path(getattr(tree, k), f"{path}.{k}")
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from _flatten_with_path(t, f"{path}[{i}]")
    elif tree is not None:
        yield path, tree


def assert_all_finite(pytree: Any, name: str = "pytree") -> None:
    """Raise if any leaf contains NaN/Inf."""
    for path, leaf in _flatten_with_path(pytree):
        if not bool(torch.isfinite(torch.as_tensor(leaf)).all()):
            raise FloatingPointError(f"non-finite values in {name}{path}")


def check_gradients(loss_fn: Callable, params, verbose: bool = True
                    ) -> dict:
    """One value-and-grad pass; asserts a finite loss and finite
    gradients for every parameter group and returns their norms."""
    p = {k: v.detach().clone().requires_grad_(True)
         for k, v in params.items()}
    value = loss_fn(p)
    keys = sorted(p)
    grads = torch.autograd.grad(value, [p[k] for k in keys],
                                allow_unused=True)
    # a group the loss does not use has a zero gradient, as in JAX
    grads = {k: torch.zeros_like(p[k]) if g is None else g
             for k, g in zip(keys, grads)}
    if not bool(torch.isfinite(value.detach())):
        raise FloatingPointError(
            f"loss is non-finite: {float(value.detach())}")
    assert_all_finite(grads, "grads")
    norms = grad_norms(grads)
    if verbose:
        print("Gradient magnitudes:")
        for k, v in norms.items():
            print(f"  {k}: {v:.6e}")
    return norms
