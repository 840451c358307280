"""``lattice_vg_roofline.lbfgs`` and ``.mg``: the lattice stencil's
value-and-grad share of its roofline, the least time the stencil work of
the traced solves needs (its bytes a launch, ``roofline.stencil_vg_bytes``,
over every level and launch the solves need), over the device time of the
kernel that does it (K6, ``csrc/lattice_stencil.cu``).  A change that
fuses or renames it repoints ``KERNELS``."""

from fembench import roofline

KERNELS = ("stencil_vg_kernel",)


def read(run):
    return roofline.share(run, "lattice_vg", KERNELS)
