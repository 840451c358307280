"""Device busy ms an iteration of the traced multigrid solves: the union
of the device's kernel intervals over the traced solves (their set-up,
warm-up and recording included), over the iterations they needed."""


def read(run):
    if not run.iterations or run.trace.busy_s <= 0:
        return None
    return 1e3 * run.trace.busy_s / run.iterations
