"""Iterations a traced multigrid solve needed: the nonzero entries of
each solve's residual history."""


def read(run):
    if not run.iterations:
        return None
    return run.iterations / len(run.solves)
