"""K4's launches (``banded_vg`` in the port's
``ops/banded_energy.launch_counts``) in the traced PCG solves, over their
iterations: a matvec an iteration, the right-hand side's gradient, and
the loop's masked calls past the stop."""


def read(run):
    launches = run.counters.get("banded_vg", 0)
    if not run.iterations or not launches:
        return None
    return launches / run.iterations
