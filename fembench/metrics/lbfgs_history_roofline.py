"""The compact L-BFGS history passes' share of their roofline: the least
time the two passes over the [2m, P] history need a step (their bytes,
``roofline.lbfgs_history_bytes``, at the card's HBM rate), summed over the
traced steps, over the device time of the kernels that do that work
(``csrc/lbfgs_history.cu``).  A change that fuses or renames them
repoints ``KERNELS``."""

from fembench import roofline

KERNELS = ("dots_kernel", "dots_finish_kernel", "combine_kernel")


def read(run):
    return roofline.share(run, "lbfgs_history", KERNELS)
