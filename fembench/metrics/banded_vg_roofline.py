"""``banded_vg_roofline.lbfgs`` and ``.mg``: the banded energy's
value-and-grad share of its roofline, the least time the K4 launches of
the traced solves need (their bytes a launch, ``banded_bytes``, times the
launches the port counted), over the device time of the kernel that does
it (K4, ``csrc/banded_energy.cu``).  A change that fuses or renames it
repoints ``KERNELS``."""

from fembench import roofline

KERNELS = ("banded_vg_kernel",)


def read(run):
    return roofline.share(run, "banded_vg", KERNELS)
