"""``graphs_per_solve.lbfgs`` and ``.mg``: the port's
``hidenn.loop.record`` spans a traced solve, the CUDA graphs a solve
records: 1 where each solve records its own, 0 where solves reuse one
(``fembench/program_spans.py``)."""

from fembench import program_spans


def read(run):
    return program_spans.graphs(run.trace)
