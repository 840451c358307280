"""The plain reference that decides ``correct``: plain PyTorch, written
from the textbook formulas and the configuration's stated semantics.

It imports neither JAX, nor the JAX package, nor anything of the port
(``hidenn_fem_tpu_torch``), and takes nothing the port made: it builds
its own tensors from the benchmark's numpy arrays.  It runs in float64
to judge, and in TF32 (``precision.Precision("tf32")``) as the control.
"""
