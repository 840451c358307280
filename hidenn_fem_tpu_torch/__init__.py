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
from .convert import (aux_from_numpy, grid_from_numpy,  # noqa: E402
                      levels_from_numpy, mesh_from_numpy,
                      params_from_numpy)
from .mesh.banded import reorder_mesh  # noqa: E402
from .mesh.delaunay import (generate_mesh_delaunay,  # noqa: E402
                            generate_mesh_unstructured)
from .mesh.gmsh_backend import generate_mesh_gmsh, have_gmsh  # noqa: E402
from .mesh.hybrid import (generate_mesh_hybrid,  # noqa: E402
                          hybrid_mesh_from_arrays)
from .mesh.structured import (generate_mesh, proxy_plate_mesh,  # noqa: E402
                              rectangle_tri_zigzag)
from .mesh.types import TriMesh  # noqa: E402
from .models.bilinear2d import Bilinear2D  # noqa: E402
from .models.linear1d import Linear1D  # noqa: E402
from .models.structured_grid import (StructuredGrid,  # noqa: E402
                                     StructuredGridP1,
                                     generate_structured_grid)
from .models.triangle_p1 import TriangleP1  # noqa: E402
from .ops.elasticity import plane_stress_C, \
    von_mises_plane_stress  # noqa: E402
from .ops.losses import (PlaneStressEnergy, bar_energy_1d,  # noqa: E402
                         l2_loss)
from .ops.quadrature import (interval_gauss_points,  # noqa: E402
                             interval_gauss_points_m11,
                             triangle_gauss_points)
from .solve.auxspace import (aux_pcg_solve,  # noqa: E402
                             build_aux_preconditioner, radapt_aux_solve)
from .solve.drivers import (MinimizeResult,  # noqa: E402
                            alternating_solve, minimize, run_lbfgs,
                            run_optimizer, two_phase_solve)
from .solve.linear import (cg_solve, jacobi_diagonal,  # noqa: E402
                           jacobi_pcg_solve, radapt_cg_solve)
from .solve.multigrid import (build_hierarchy, mg_pcg_solve,  # noqa: E402
                              radapt_mg_solve)
from .solve.nodespace import lbfgs_node_space  # noqa: E402
from .solve.optimizers import (adam, adam_per_group,  # noqa: E402
                               freeze_groups, lbfgs)

__version__ = "0.1.0"
