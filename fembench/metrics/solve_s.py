"""Time to a solution: the window's host seconds over the solves
completed in it (each solve's set-up, entry call and read included)."""


def read(run):
    return run.window_s / len(run.times)
