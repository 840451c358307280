"""Device operations the profiler saw in the traced L-BFGS solves, over
their steps."""


def read(run):
    if not run.steps or not run.trace.n_device_ops:
        return None
    return run.trace.n_device_ops / run.steps
