"""solve layer of the PyTorch port."""

from .optimizers import adam, adam_per_group, lbfgs, freeze_groups
from .drivers import (minimize, run_optimizer, run_lbfgs, MinimizeResult,
                      alternating_solve, two_phase_solve,
                      solve_with_checkpointing)
from .linear import (cg_solve, radapt_cg_solve, jacobi_diagonal,
                     jacobi_pcg_solve)
from .multigrid import mg_pcg_solve, build_hierarchy, radapt_mg_solve
from .auxspace import (build_aux_preconditioner, aux_pcg_solve,
                       radapt_aux_solve)
from .nodespace import lbfgs_node_space
