"""Problem configuration (port of ``PlateConfig`` from
``hidenn_fem_tpu/config.py``): the example-4 recipe with the reference's
values as defaults."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

__all__ = ["PlateConfig"]


@dataclasses.dataclass
class PlateConfig:
    """Example-4 recipe: 2x1 plate, three holes, left edge clamped, right
    edge under a uniform 100 kN traction, E = 10 GPa, nu = 0.3."""
    length: float = 2.0
    height: float = 1.0
    holes: Sequence[Tuple[float, float, float]] = (
        (0.5, 0.7, 0.12), (1.0, 0.3, 0.15), (1.4, 0.6, 0.1))
    boundaries: Optional[Dict[str, int]] = None   # None -> reference default
    nx: int = 200
    ny: int = 100
    lc: float = 0.05                               # gmsh mesh size
    youngs_modulus: float = 10e9
    poisson_ratio: float = 0.3
    gauss_order: int = 4
    gauss_order_1d: int = 2
    traction_total: float = 100e3
    traction_length: float = 1.0
    lbfgs_steps: int = 600                         # = 30 epochs x max_iter 20
    seed: int = 0

    def make_boundaries(self) -> Dict[str, int]:
        return self.boundaries or {"up": 0, "down": 0, "right": 2,
                                   "left": 1}
