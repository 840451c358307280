"""K4's launches (``banded_vg`` in the port's
``ops/banded_energy.launch_counts``) in the traced L-BFGS solves, over
their steps."""


def read(run):
    launches = run.counters.get("banded_vg", 0)
    if not run.steps or not launches:
        return None
    return launches / run.steps
