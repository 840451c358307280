"""The stencil kernels' launches (K6 and K7, the port's
``ops/lattice_slab.launch_counts``) in the traced L-BFGS solves, over
their steps."""

NAMES = ("lattice_stencil_vg", "lattice_stencil_fwd")


def read(run):
    launches = sum(run.counters.get(n, 0) for n in NAMES)
    if not run.steps or not launches:
        return None
    return launches / run.steps
