"""Host ms a traced solve spends in the port's ``hidenn.aux.level_ops``
span: the right-hand side's gradient and the background levels'
operators, built before the loop on every aux-space PCG solve; the mean
over the traced solves (``fembench/program_spans.py``), or None where no
solve recorded the span (a program without it)."""

from fembench import program_spans

SPAN = "hidenn.aux.level_ops"


def read(run):
    solves = program_spans.by_solve(run.trace)
    spans = [[sp for sp in spans if sp[2] == SPAN] for spans in solves]
    if not any(spans):
        return None
    return 1e-6 * sum(e - s for each in spans
                      for s, e, _ in each) / len(solves)
