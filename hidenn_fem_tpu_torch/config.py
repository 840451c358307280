"""Problem configuration (port of ``hidenn_fem_tpu/config.py``): each
example's recipe as a small dataclass with the reference's values as
defaults."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

__all__ = ["Projection1DConfig", "Projection2DConfig", "Bar1DConfig",
           "PlateConfig"]


@dataclasses.dataclass
class Projection1DConfig:
    """Example-1 recipe: L2 projection of sin(2 pi x) on 100 nodes."""
    n_nodes: int = 100
    n_train: int = 1000
    x0: float = 0.0
    xN: float = 1.0
    r_adapt: bool = True
    learning_rate: float = 5e-3
    epochs: int = 500


@dataclasses.dataclass
class Projection2DConfig:
    """Example-2 recipe: L2 projection of sin(2 pi x) cos(2 pi y) on a
    25x25 bilinear grid, minibatches of 1000 points."""
    nx: int = 25
    ny: int = 25
    n_train_1d: int = 100
    batch_size: int = 1000
    r_adapt: bool = True
    learning_rate: float = 5e-3
    epochs: int = 5000
    seed: int = 0


@dataclasses.dataclass
class Bar1DConfig:
    """Example-3 recipe: the 1D bar [0, 10] under two body-force bumps."""
    length: float = 10.0
    youngs_modulus: float = 175.0
    u0: float = 0.0
    uN: float = 0.0
    n_nodes: int = 89
    n_gauss: int = 2
    r_adapt: bool = True
    learning_rate: float = 1e-4
    epochs: int = 4000


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
