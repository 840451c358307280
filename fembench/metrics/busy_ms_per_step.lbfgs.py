"""Device busy ms a step of the traced L-BFGS solves: the union of the
device's kernel intervals over the traced solves, over their steps."""


def read(run):
    if not run.steps or run.trace.busy_s <= 0:
        return None
    return 1e3 * run.trace.busy_s / run.steps
