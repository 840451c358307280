"""The multigrid level kernels' launches (``lattice_level_step``,
``lattice_restrict`` and ``lattice_bottom_cycle`` in the port's
``ops/lattice_slab.launch_counts``: K6's level epilogues, the restriction
and the bottom levels' one-CTA cycle) in the traced PCG solves, over
their iterations: a V-cycle and K p each call of the loop body, a
V-cycle each solve's start, and the masked calls past the stop.  A
program without the level kernels counts none, and the metric is left
out."""

NAMES = ("lattice_level_step", "lattice_restrict", "lattice_bottom_cycle")


def read(run):
    launches = sum(run.counters.get(n, 0) for n in NAMES)
    if not run.iterations or not launches:
        return None
    return launches / run.iterations
