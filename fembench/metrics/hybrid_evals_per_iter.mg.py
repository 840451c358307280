"""The hybrid energy route's evaluations (``route_counts["hybrid"]`` in
the port's ``ops/losses.py``: each energy ``_hybrid_total`` returns, a
replay counted as the captured call) in the traced PCG solves, over their
iterations: a matvec each call of the loop body (the iterations and the
masked calls past the stop), the right-hand side's gradient, and the kept
plan's check's two gradients.  A program without the counter counts
none, and the metric is left out."""


def read(run):
    evals = run.counters.get("hybrid", 0)
    if not run.iterations or not evals:
        return None
    return evals / run.iterations
