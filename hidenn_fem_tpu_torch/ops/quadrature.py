"""Gaussian quadrature tables (port of ``hidenn_fem_tpu/ops/quadrature.py``).

The tables are computed in float64 on the host with the same formulas as
the JAX package and cast once, so both packages hold bit-equal tables.

* ``interval_gauss_points(order)``: Gauss-Legendre on [0, 1].
* ``interval_gauss_points_m11(order)``: the raw [-1, 1] rule (quirk E3).
* ``triangle_gauss_points(order)``: symmetric rules on the unit reference
  triangle, weights scaled by its area 1/2.

Each goes to the card unless ``device`` names another device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..device import resolve_device

__all__ = [
    "interval_gauss_points",
    "interval_gauss_points_m11",
    "gauss_legendre_points_weights",
    "triangle_gauss_points",
    "triangle_weight_sum",
    "TRIANGLE_RULE_DEGREE",
]

# polynomial degree integrated exactly by each supported triangle rule
TRIANGLE_RULE_DEGREE = {1: 1, 3: 2, 4: 3, 6: 4, 7: 5}


@functools.lru_cache(maxsize=None)
def _leggauss(order: int):
    return np.polynomial.legendre.leggauss(order)


def _tensor(a, dtype, device):
    return torch.as_tensor(np.asarray(a), dtype=dtype,
                           device=resolve_device(device))


def interval_gauss_points(order: int = 1, dtype=torch.float32, device=None):
    """Gauss-Legendre points/weights on [0, 1] (weights sum to 1)."""
    x, w = _leggauss(order)
    return (_tensor(0.5 * (x + 1.0), dtype, device),
            _tensor(0.5 * w, dtype, device))


def interval_gauss_points_m11(order: int = 1, dtype=torch.float32,
                              device=None):
    """Raw Gauss-Legendre points/weights on [-1, 1] (weights sum to 2)."""
    x, w = _leggauss(order)
    return _tensor(x, dtype, device), _tensor(w, dtype, device)


# the name the reference's examples import for the raw [-1, 1] rule
gauss_legendre_points_weights = interval_gauss_points_m11


def _triangle_rule_f64(order: int):
    """Points (r, s) on {r, s >= 0, r + s <= 1} and weights summing to the
    reference-triangle area 0.5 (same literals as the JAX package)."""
    if order == 1:
        pts = np.array([[1.0 / 3.0, 1.0 / 3.0]])
        w = np.array([1.0])
    elif order == 3:
        a = 1.0 / 6.0
        b = 2.0 / 3.0
        pts = np.array([[a, a], [b, a], [a, b]])
        w = np.array([1.0, 1.0, 1.0]) / 3.0
    elif order == 4:
        pts = np.array([[1.0 / 3.0, 1.0 / 3.0], [0.6, 0.2], [0.2, 0.6],
                        [0.2, 0.2]])
        w = np.array([-27.0, 25.0, 25.0, 25.0]) / 48.0
    elif order == 6:
        a = 0.445948490915965
        b = 0.091576213509771
        wa = 0.223381589678011
        wb = 0.109951743655322
        pts = np.array([[a, a], [1.0 - 2.0 * a, a], [a, 1.0 - 2.0 * a],
                        [b, b], [1.0 - 2.0 * b, b], [b, 1.0 - 2.0 * b]])
        w = np.array([wa, wa, wa, wb, wb, wb])
    elif order == 7:
        a = 0.470142064105115
        b = 0.101286507323456
        wa = 0.132394152788506
        wb = 0.125939180544827
        pts = np.array([[1.0 / 3.0, 1.0 / 3.0], [1.0 - 2.0 * a, a],
                        [a, 1.0 - 2.0 * a], [a, a], [1.0 - 2.0 * b, b],
                        [b, 1.0 - 2.0 * b], [b, b]])
        w = np.array([0.225, wa, wa, wa, wb, wb, wb])
    else:
        raise NotImplementedError(
            f"triangle quadrature order {order} not supported; "
            f"supported orders: {sorted(TRIANGLE_RULE_DEGREE)}")
    return pts, 0.5 * w


def triangle_gauss_points(order: int = 1, dtype=torch.float32, device=None):
    """Quadrature (points [n, 2], weights [n]) on the unit triangle."""
    pts, w = _triangle_rule_f64(order)
    return _tensor(pts, dtype, device), _tensor(w, dtype, device)


def triangle_weight_sum(order: int = 1) -> float:
    """Host-side sum of the triangle rule weights (the area 0.5)."""
    _, w = _triangle_rule_f64(order)
    return float(np.sum(w))
