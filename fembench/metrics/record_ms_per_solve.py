"""``record_ms_per_solve.lbfgs`` and ``.mg``: host ms in the port's
``hidenn.loop.record`` spans (a CUDA graph's recording, its pool's
allocation in it) a traced solve (``fembench/program_spans.py``)."""

from fembench import program_spans


def read(run):
    return program_spans.record_ms(run.trace)
