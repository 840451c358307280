"""The readers of the port's spans (``fembench/program_spans.py`` and
``fembench/metrics/{prologue_ms_per_solve,record_ms_per_solve,
graphs_per_solve,replay_idle_share}.py``) on a synthetic trace summary
whose device intervals, ``fembench.solve`` spans and ``hidenn.*`` spans
are known, and their eight entries in ``BENCHMARK.json``."""

from __future__ import annotations

import types

import pytest

import test_fembench_units as units
from fembench import spec
from fembench.trace import Summary

MS = 1_000_000      # ns
LBFGS = ["plate3h_922k.lbfgs_m100", "plate3h_922k.lbfgs_m10"]
MG = ["grid_961x481.mg_loadcases"]
BASES = ("prologue_ms_per_solve", "record_ms_per_solve", "graphs_per_solve",
         "replay_idle_share")


def _ms(*spans):
    return [(int(s * MS), int(e * MS), name) for s, e, name in spans]


def _summary(program, device, solves=((0, 100), (100, 200))):
    """Two traced solves of 100 ms each, the host's runtime calls, the
    program's spans and the device's intervals (all in ms)."""
    bench = []
    for s, e in solves:
        bench += [(s, e, "fembench.solve"), (s + 1, e - 2, "fembench.entry")]
    host = [(5, 6, "cudaMalloc"), (150, 151, "cudaGraphLaunch")]
    return Summary(_ms(*device), _ms(*host, *program), _ms(*bench),
                   solves[0][0] * MS, solves[-1][1] * MS)


# solve 1: root at 2, record 20-30, replays 40-90; solve 2: root at 101,
# record 115-120, replays 130-192; a span outside both solves is ignored
PROGRAM = [
    (2, 95, "hidenn.run_optimizer"), (3, 8, "hidenn.optimizer.init"),
    (9, 19, "hidenn.loop.eager"), (20, 30, "hidenn.loop.record"),
    (40, 90, "hidenn.loop.replay"),
    (101, 195, "hidenn.run_optimizer"), (102, 104, "hidenn.optimizer.init"),
    (105, 114, "hidenn.loop.eager"), (115, 120, "hidenn.loop.record"),
    (130, 192, "hidenn.loop.replay"),
    (300, 400, "hidenn.loop.record"),
]
# idle inside the replays: 60-70 (10 ms) in the first, 129-135 (5 of it
# inside) and 180-200 (12 of it inside) in the second
DEVICE = [(0, 60, "k"), (70, 129, "k"), (135, 180, "k")]


def _read(name, summary):
    return spec.module("metrics", name).read(
        types.SimpleNamespace(trace=summary))


@pytest.mark.parametrize("kind", ["lbfgs", "mg"])
def test_the_readers_read_the_known_spans(kind):
    s = _summary(PROGRAM, DEVICE)
    assert _read(f"prologue_ms_per_solve.{kind}", s) == \
        pytest.approx((38 + 29) / 2)
    assert _read(f"record_ms_per_solve.{kind}", s) == \
        pytest.approx((10 + 5) / 2)
    assert _read(f"graphs_per_solve.{kind}", s) == 1.0
    assert _read(f"replay_idle_share.{kind}", s) == \
        pytest.approx(100 * (10 + 5 + 12) / (50 + 62))


def test_no_replay_span_reads_nothing():
    eager_only = [sp for sp in PROGRAM
                  if sp[2] not in ("hidenn.loop.record",
                                   "hidenn.loop.replay")]
    for program in (eager_only, []):
        s = _summary(program, DEVICE)
        for base in BASES:
            assert _read(f"{base}.lbfgs", s) is None


def test_solves_that_reuse_a_graph_read_no_recording():
    reuse = [sp for sp in PROGRAM if sp[2] != "hidenn.loop.record"]
    s = _summary(reuse, DEVICE)
    assert _read("graphs_per_solve.mg", s) == 0.0
    assert _read("record_ms_per_solve.mg", s) == 0.0
    assert _read("prologue_ms_per_solve.mg", s) == pytest.approx(33.5)


def test_a_device_busy_through_the_replays_reads_no_idle():
    s = _summary(PROGRAM, [(0, 200, "k")])
    assert _read("replay_idle_share.lbfgs", s) == 0.0


def test_the_program_spans_name_the_host_gaps():
    """Where no runtime call runs, the breakdown names the program's
    phase in place of "no host op": the three gaps whose middles lie in
    a replay span, 36 ms."""
    gaps = dict(_summary(PROGRAM, DEVICE).breakdown()["idle_gaps"])
    assert gaps == {"fembench.entry / hidenn.loop.replay":
                    pytest.approx(0.036)}


def test_the_span_metrics_keep_the_contract():
    units.test_benchmark_json_keeps_the_contract()
    entries = {m["name"]: m for m in units.BENCH["per_layer"]}
    for base in BASES:
        for kind, moves, cells in (("lbfgs", "solve_s", LBFGS),
                                   ("mg", "mg_solve_s", MG)):
            m = entries[f"{base}.{kind}"]
            assert m["source"] == "program_span"
            assert m["moves"] == moves and m["workloads"] == cells
            assert m["better"] == "lower"
            assert spec.module("metrics", m["name"]).__file__.endswith(
                f"metrics/{base}.py")
    names = [m["name"] for m in units.BENCH["per_layer"]]
    assert names[-8:] == [f"{b}.{k}" for b in BASES for k in ("lbfgs", "mg")]
