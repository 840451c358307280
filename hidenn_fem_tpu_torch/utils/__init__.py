"""Checkpoints, metrics, profiling and debugging helpers of the PyTorch
port (port of ``hidenn_fem_tpu/utils``)."""

from .checkpoint import save_checkpoint, restore_checkpoint, latest_checkpoint
from .metrics import grad_norms, solve_metrics, MetricsWriter, StepTimer
from .profiling import annotate, trace_to, slope_time_scan, sync_time
from .debug import enable_nan_debugging, assert_all_finite, check_gradients
