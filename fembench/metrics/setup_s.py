"""Process start to the first timed solve (imports, the card's context,
the kernels' libraries, mesh arrays, the port's tables, hierarchy,
warm-up solves)."""


def read(run):
    return run.setup_s
