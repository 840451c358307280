"""``prologue_ms_per_solve.lbfgs`` and ``.mg``: host ms from a traced
solve's root span (``hidenn.run_optimizer``, ``hidenn.mg_pcg_solve``) to
its first ``hidenn.loop.replay``: the optimizer's init or the level
operators, the first call, the warm-up and the recording, before the
steady state (``fembench/program_spans.py``); the mean over the traced
solves."""

from fembench import program_spans


def read(run):
    return program_spans.prologue_ms(run.trace)
