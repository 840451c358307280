"""models layer of the PyTorch port: the names ``hidenn_fem_tpu.models``
exports."""

from .linear1d import Linear1D
from .bilinear2d import Bilinear2D
from .triangle_p1 import TriangleP1
from .structured_grid import (StructuredGrid, StructuredGridP1,
                              generate_structured_grid)
