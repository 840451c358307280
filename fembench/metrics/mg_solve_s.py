"""Time to a solution of the multigrid cell, read as ``solve_s`` is: the
window's host seconds over the solves completed in it.  A metric of its
own, with its own bound: these solves are host-bound (each records a CUDA
graph) and spread more between runs than the L-BFGS cells' solves."""

from fembench.metrics.solve_s import read  # noqa: F401
