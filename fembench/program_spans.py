"""The port's own spans in the traced run: the ``hidenn.*`` ranges that
the program records through ``utils/profiling.annotate`` (the solve's
root, ``hidenn.optimizer.init``, ``hidenn.mg.level_ops``,
``hidenn.pcg.start``, and ``solve/loop.py``'s ``hidenn.loop.eager``,
``.record``, ``.replay`` and ``.flag_read``), on the clock of the
device's activities.  ``trace.Summary`` keeps them with the host's
events (its ``_cpu``); here they are grouped by the benchmark's
``fembench.solve`` span that holds them (``_spans``), and the replay
spans are intersected with the device's idle gaps (``_gaps``).

Every function returns None where the traced solves recorded no replay
span: a program without these spans, or a run with nothing captured
(the CPU).
"""

from __future__ import annotations

from fembench.trace import SOLVE_SPAN

PREFIX = "hidenn."
ROOTS = ("hidenn.run_optimizer", "hidenn.mg_pcg_solve", "hidenn.cg_solve",
         "hidenn.jacobi_pcg_solve", "hidenn.aux_pcg_solve")
RECORD = "hidenn.loop.record"
REPLAY = "hidenn.loop.replay"


def by_solve(trace) -> list:
    """For each ``fembench.solve`` span, in order, the program's spans
    inside it: (start ns, end ns, name), by start."""
    spans = [c for c in trace._cpu if c[2].startswith(PREFIX)]
    return [[c for c in spans if s0 <= c[0] and c[1] <= s1]
            for s0, s1, name in trace._spans if name == SOLVE_SPAN]


def _named(spans: list, name: str) -> list:
    return [sp for sp in spans if sp[2] == name]


def _captured(solves: list) -> bool:
    return any(_named(spans, REPLAY) for spans in solves)


def prologue_ms(trace):
    """Host ms from a solve's first root span to its first replay span,
    the mean over the solves that have both."""
    ms = []
    for spans in by_solve(trace):
        roots = [sp for sp in spans if sp[2] in ROOTS]
        replays = _named(spans, REPLAY)
        if roots and replays:
            ms.append(1e-6 * (replays[0][0] - roots[0][0]))
    return sum(ms) / len(ms) if ms else None


def record_ms(trace):
    """Host ms in recording spans a traced solve."""
    solves = by_solve(trace)
    if not _captured(solves):
        return None
    return 1e-6 * sum(e - s for spans in solves
                      for s, e, _ in _named(spans, RECORD)) / len(solves)


def graphs(trace):
    """Recording spans a traced solve: the graphs each solve records."""
    solves = by_solve(trace)
    if not _captured(solves):
        return None
    return sum(len(_named(spans, RECORD)) for spans in solves) / len(solves)


def _overlap(a: list, b: list) -> int:
    """The length of the intersection of two sorted lists of disjoint
    intervals."""
    total = i = j = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(hi - lo, 0)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def replay_idle_share(trace):
    """100 x the device's idle time inside the replay spans, over their
    length.  (A replay span closes before the next opens: one loop's
    ``settle`` comes before another loop's first replay.)"""
    replays = [sp[:2] for spans in by_solve(trace)
               for sp in _named(spans, REPLAY)]
    length = sum(e - s for s, e in replays)
    if length <= 0:
        return None
    return 100.0 * _overlap(replays, trace._gaps) / length
