"""``replay_idle_share.lbfgs`` and ``.mg``: the device's idle share of
the steady state, each solve's prologue left out: 100 x the device's idle
time inside the port's ``hidenn.loop.replay`` spans, over those spans'
length (``fembench/program_spans.py``)."""

from fembench import program_spans


def read(run):
    return program_spans.replay_idle_share(run.trace)
