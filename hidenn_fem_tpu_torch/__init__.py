"""HiDeNN-FEM on PyTorch and CUDA: the port of ``hidenn_fem_tpu``.

Differentiable P1 finite elements whose parameters are nodal values and
nodal coordinates (r-adaptivity by gradient descent on the mesh), on
PyTorch with hand-written CUDA kernels for the H100.  The JAX package
``hidenn_fem_tpu`` is the reference this package is held against; this
package never imports it or JAX.

Precision policy, set once here: float32 is the default dtype and float64
is allowed; TF32 is off for matmuls and cuDNN, because the compact L-BFGS
algebra needs full-float32 products (TF32 keeps about three decimal
digits, the same failure as the TPU's bf16 matmul default).
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .config import PlateConfig  # noqa: E402
from .convert import mesh_from_numpy, params_from_numpy  # noqa: E402
from .mesh.structured import (generate_mesh, proxy_plate_mesh,  # noqa: E402
                              rectangle_tri_zigzag)
from .mesh.types import TriMesh  # noqa: E402
from .models.triangle_p1 import TriangleP1  # noqa: E402
from .ops.elasticity import plane_stress_C, \
    von_mises_plane_stress  # noqa: E402
from .ops.losses import PlaneStressEnergy  # noqa: E402
from .ops.quadrature import (interval_gauss_points,  # noqa: E402
                             interval_gauss_points_m11,
                             triangle_gauss_points)
from .solve.drivers import run_lbfgs, run_optimizer  # noqa: E402
from .solve.optimizers import lbfgs  # noqa: E402

__version__ = "0.1.0"
