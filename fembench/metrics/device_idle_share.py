"""``device_idle_share.lbfgs`` and ``.mg``: the share of the traced
solves' wall time in which no device operation ran: 100 (1 - busy /
window)."""


def read(run):
    return run.trace.idle_share()
