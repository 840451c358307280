"""The port's spans (``utils/profiling.annotate`` and ``Span``) inside its
solves, and the gauge of CUDA graphs still alive (``solve/loop.py``'s
``captures``).

* With no profiler running a span enters no ``record_function``: a
  solve then pays one flag read a span.
* Under ``torch.profiler`` each public solve records its root span
  (``hidenn.run_optimizer``, ``hidenn.mg_pcg_solve``, ``hidenn.cg_solve``,
  ``hidenn.jacobi_pcg_solve``, ``hidenn.aux_pcg_solve``), with the
  solve's phases nested in it by time; on the CPU nothing is captured,
  so there is no recording and no replay span.
* An aux-space PCG solve builds its right-hand side and its background
  levels' operators in ``hidenn.aux.level_ops``, inside its root span and
  before the loop's first span.
* A ``Replayer`` whose graph is stood in for on the CPU opens one replay
  span at its first replay and closes it in ``settle``: every replay and
  the stop-flag reads between lie inside it.
* On the card (marked ``cuda``): a traced captured solve records one
  graph, and every ``cudaGraphLaunch`` of the solve lies inside a replay
  span (the spans and the runtime's events share one clock); the gauge
  of graphs recorded minus freed matches the graphs alive, before and
  after a collection.  Load cases on one hierarchy (``mg_pcg_solve``
  with ``levels``) record two graphs in all, the plan's start and
  iteration; they move the launch counters as solves on fresh
  hierarchies do, less the level operators' gradients at zero that only
  the first plan computes, answer bit for bit as those do, record
  nothing from the third solve on, and give both graphs back when the
  hierarchy goes, with the collector off.  A captured aux-space PCG
  solve on a mesh with banded tables moves K4's launch counter as the
  eager solve does, and answers as it does; on a hybrid mesh it moves
  the hybrid route's counter (``losses.route_counts``) as the eager
  solve does.  Load cases on one aux preconditioner (``aux_pcg_solve``
  with ``pre``) record two graphs in all and none from the third solve
  on; a replay moves K4's counter as the eager solve does plus the
  check's two gradients (``hidenn.aux.check``, after the replays),
  answers one loss object bit for bit as the eager solve does and
  another load within 1e-5, and both graphs go when the preconditioner
  does, with the collector off.

This file imports neither JAX nor the JAX package, so it also runs on the
card: ``python -m pytest --noconftest -m cuda tests/test_torch_spans.py``.
"""

import dataclasses
import gc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import hidenn_fem_tpu_torch as pt
from hidenn_fem_tpu_torch.models.structured_grid import (
    StructuredGridP1, generate_structured_grid)
from hidenn_fem_tpu_torch.solve import loop
from hidenn_fem_tpu_torch.utils import profiling

CPU = torch.device("cpu")
ROOTS = {"lbfgs": "hidenn.run_optimizer", "mg": "hidenn.mg_pcg_solve",
         "cg": "hidenn.cg_solve", "jacobi": "hidenn.jacobi_pcg_solve",
         "aux": "hidenn.aux_pcg_solve"}
# the phases each solve records before its loop, besides the eager calls
PHASES = {"lbfgs": ["hidenn.optimizer.init"],
          "mg": ["hidenn.mg.level_ops", "hidenn.pcg.start"],
          "cg": ["hidenn.pcg.start"], "jacobi": ["hidenn.pcg.start"],
          "aux": ["hidenn.aux.level_ops", "hidenn.pcg.start"]}


@pytest.fixture
def dev():
    """The card; skips where there is none (decided at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (runs on the card)")
    return torch.device("cuda", 0)


def _plate(device):
    mesh = pt.proxy_plate_mesh(nx=9, ny=5, device=device)
    u0 = 1e-5 * np.random.default_rng(0).standard_normal((mesh.n_nodes, 2))
    params = pt.params_from_numpy({"coords": mesh.coords.cpu().numpy(),
                                   "u": u0}, device=device)
    return mesh, pt.PlaneStressEnergy(model=pt.TriangleP1()), params


def _solve(kind, device):
    """One small solve of ``kind`` through its public entry point."""
    if kind == "mg":
        grid = generate_structured_grid(nx=9, ny=5, split="zigzag",
                                        holes=(), device=device)
        model = StructuredGridP1(E=10e9, nu=0.3)
        params = model.init(np.random.default_rng(0), grid, device=device)
        params["u"] = torch.zeros_like(params["u"])
        return pt.mg_pcg_solve(model, grid, params, max_iters=8, nu=1,
                               coarse_degree=4)
    mesh, energy, params = _plate(device)
    if kind == "lbfgs":
        return pt.run_lbfgs(energy.total, params, num_steps=6,
                            memory_size=3, loss_args=(mesh,))

    def u_loss(p, coords, m):
        return energy.total({"coords": coords, "u": p["u"]}, m)

    up, args = {"u": params["u"]}, (params["coords"], mesh)
    if kind == "cg":
        return pt.cg_solve(u_loss, up, args, max_iters=12)
    if kind == "jacobi":
        return pt.jacobi_pcg_solve(u_loss, up, args, mesh=mesh, max_iters=12)
    return pt.aux_pcg_solve(u_loss, up, args, mesh=mesh, bg_shape=(9, 5),
                            max_iters=8)


def _spans(prof):
    """The program's spans of a profile, on the host: (start ns, end ns,
    name).  (kineto mirrors a range that launched device work on the
    device's timeline too, as an annotation of the same name.)"""
    return sorted((e.start_ns(), e.end_ns(), e.name())
                  for e in prof.profiler.kineto_results.events()
                  if e.name().startswith("hidenn.")
                  and e.device_type() == torch.autograd.DeviceType.CPU)


def _named(spans, name):
    return [s for s in spans if s[2] == name]


def _inside(inner, outer):
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def test_no_profiler_enters_no_record_function(monkeypatch):
    entered = []
    real = profiling.record_function

    def counted(name, *args):
        entered.append(name)
        return real(name, *args)

    monkeypatch.setattr(profiling, "record_function", counted)
    with profiling.annotate("hidenn.test.block"):
        pass
    span = profiling.Span("hidenn.test.open")
    span.open()
    span.close()
    span.close()
    _solve("lbfgs", CPU)
    _solve("mg", CPU)
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.annotate("hidenn.test.block"):
            pass
    assert entered == ["hidenn.test.block"]


@pytest.mark.parametrize("kind", list(ROOTS))
def test_a_solve_records_its_phases_inside_its_root_span(kind):
    torch.manual_seed(0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _solve(kind, CPU)
    spans = _spans(prof)
    (root,) = _named(spans, ROOTS[kind])
    assert root == spans[0]
    eager = _named(spans, "hidenn.loop.eager")
    assert eager
    for name in PHASES[kind]:
        (phase,) = _named(spans, name)
        assert _inside(phase, root)
        assert phase[1] <= eager[0][0]
    for s in spans:
        assert _inside(s, root), s
    # nothing is captured on the CPU
    assert not _named(spans, "hidenn.loop.record")
    assert not _named(spans, "hidenn.loop.replay")
    if kind != "lbfgs":         # a while loop reads its stop flag
        assert _named(spans, "hidenn.loop.flag_read")


def test_the_aux_level_ops_come_before_the_loop():
    torch.manual_seed(0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _solve("aux", CPU)
    spans = _spans(prof)
    (root,) = _named(spans, ROOTS["aux"])
    (ops,) = _named(spans, "hidenn.aux.level_ops")
    assert _inside(ops, root)
    first_loop = min(s[0] for s in spans if s[2].startswith("hidenn.loop."))
    assert ops[1] <= first_loop


class _StandInGraph:
    """A recorded graph stood in for on the CPU: a replay runs the body."""

    def __init__(self, body):
        self.replay = body


def test_one_replay_span_covers_the_replays_and_their_flag_reads(
        monkeypatch):
    def capture(self):
        self.graph = _StandInGraph(self.body)
        self.per_replay = [dict.fromkeys(c, 0) for c in loop._counters()]

    monkeypatch.setattr(loop.Replayer, "_capture", capture)
    monkeypatch.setattr(loop.Replayer, "_warm_up", lambda self: self.body())
    monkeypatch.setattr(loop, "capturable", lambda device: True)
    calls = torch.zeros((), dtype=torch.int64)
    active = torch.ones((), dtype=torch.bool)

    def body():
        calls.add_(1)
        active.copy_(calls < 10)

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        loop.while_loop(body, active, 40, CPU)
    assert int(calls) == 12     # three batches of READ_EVERY = 4 calls
    spans = _spans(prof)
    (eager,) = _named(spans, "hidenn.loop.eager")
    (replay,) = _named(spans, "hidenn.loop.replay")
    assert eager[1] <= replay[0]
    reads = _named(spans, "hidenn.loop.flag_read")
    assert len(reads) == 4
    assert reads[0][1] <= eager[0]
    assert all(_inside(r, replay) for r in reads[1:])
    adds = [e.start_ns() for e in prof.profiler.kineto_results.events()
            if e.name() == "aten::add_"]
    assert len(adds) == 12
    assert sum(replay[0] <= t <= replay[1] for t in adds) == 11


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["lbfgs", "mg"])
def test_a_captured_solve_replays_inside_its_replay_span(dev, kind):
    _solve(kind, dev)           # kernels built and loaded outside the trace
    torch.cuda.synchronize()
    graphs = loop.captures["graphs"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _solve(kind, dev)
        torch.cuda.synchronize()
    assert loop.captures["graphs"] - graphs == 1
    spans = _spans(prof)
    (root,) = _named(spans, ROOTS[kind])
    (record,) = _named(spans, "hidenn.loop.record")
    (replay,) = _named(spans, "hidenn.loop.replay")
    assert _inside(record, root) and _inside(replay, root)
    assert record[1] <= replay[0]
    launches = [(e.start_ns(), e.end_ns())
                for e in prof.profiler.kineto_results.events()
                if e.name() == "cudaGraphLaunch"]
    assert launches
    assert all(_inside(iv, replay) for iv in launches)


@pytest.mark.cuda
def test_the_gauge_of_graphs_alive_matches_the_graphs_alive(dev):
    """Graphs recorded minus graphs freed is the number of the loop's
    graphs alive: with the collector off, after three solves, whatever
    reference cycle holds their graphs; after a collection, none."""
    def alive():
        return sum(isinstance(o, torch.cuda.CUDAGraph)
                   for o in gc.get_objects())

    def gauge():
        return loop.captures["graphs"] - loop.captures["freed"]

    _solve("lbfgs", dev)
    gc.collect()
    torch.cuda.synchronize()
    alive0, gauge0 = alive(), gauge()
    gc.disable()
    try:
        for _ in range(3):
            _solve("lbfgs", dev)
        torch.cuda.synchronize()
        held = gauge() - gauge0
        assert 0 <= held <= 3
        assert held == alive() - alive0
    finally:
        gc.enable()
    gc.collect()
    assert gauge() == gauge0
    assert alive() == alive0


@pytest.mark.cuda
def test_load_cases_on_one_hierarchy_replay_its_two_graphs(dev):
    from hidenn_fem_tpu_torch.solve import multigrid

    grid = generate_structured_grid(nx=33, ny=17, split="zigzag",
                                    holes=(), device=dev)
    model = StructuredGridP1(E=10e9, nu=0.3)
    params = {"coords": grid.coords,
              "u": torch.zeros_like(grid.coords)}
    loads = [(5e4 + 2e4 * k, 1e4 * (k - 3)) for k in range(6)]
    kw = dict(max_iters=12, tol=1e-6, nu=1, coarse_degree=4)

    def hierarchy():
        with torch.no_grad():
            return multigrid.build_hierarchy(model, grid, grid.coords)

    def solve(load, levels):
        loaded = StructuredGridP1(E=10e9, nu=0.3,
                                  tractions={"right": load})
        before = [dict(c) for c in loop._counters()]
        sol, hist = pt.mg_pcg_solve(loaded, grid, params, levels=levels,
                                    **kw)
        torch.cuda.synchronize()
        return sol["u"], hist, [{k: c[k] - b.get(k, 0) for k in c}
                                for c, b in zip(loop._counters(), before)]

    fresh = [solve(load, hierarchy()) for load in loads]
    held = hierarchy()
    gc.collect()
    graphs0, freed0 = loop.captures["graphs"], loop.captures["freed"]
    kept, recorded = [], []
    for i, load in enumerate(loads):
        if i == 3:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                kept.append(solve(load, held))
        else:
            kept.append(solve(load, held))
        recorded.append(loop.captures["graphs"] - graphs0)
    assert recorded == [1, 2, 2, 2, 2, 2]
    spans = _spans(prof)
    assert not _named(spans, "hidenn.loop.record")
    assert _named(spans, "hidenn.loop.replay")
    # the levels take the level steps on the card, so a fresh plan
    # launches no more than a kept one (no gradients at zero)
    for i, ((u, h, moved), (fu, fh, fmoved)) in enumerate(zip(kept, fresh)):
        assert torch.equal(u, fu) and torch.equal(h, fh), i
        assert moved == fmoved, (i, moved, fmoved)
    assert moved[1]["lattice_stencil_vg"] > 0
    gc.disable()
    try:
        del held
        assert loop.captures["freed"] - freed0 == 2
    finally:
        gc.enable()


def _banded_delaunay(device):
    """A small Delaunay plate with its banded tables (built by default
    only above 250,000 gather rows), on ``device``."""
    m = pt.generate_mesh_delaunay(lc=0.05, device=CPU)
    arrays = {k: getattr(m, k).numpy() for k in (
        "coords", "connectivity", "geom_boundary_mask", "dirichlet_mask",
        "neumann_mask", "neumann_edges")}
    return pt.TriMesh.from_arrays(**arrays, build_banded=True,
                                  device=device)


@pytest.mark.cuda
def test_a_captured_aux_solve_counts_k4_as_an_eager_one(dev, monkeypatch):
    from hidenn_fem_tpu_torch.ops import banded_energy

    mesh = _banded_delaunay(dev)
    assert mesh.banded_paired is not None and mesh.lattice is None
    energy = pt.PlaneStressEnergy(model=pt.TriangleP1())

    def u_loss(p, coords, m):
        return energy.total({"coords": coords, "u": p["u"]}, m)

    up = {"u": torch.zeros((mesh.n_nodes, 2), device=dev)}
    args = (mesh.coords, mesh)
    bg = StructuredGridP1(E=10e9, nu=0.3)
    pre = pt.build_aux_preconditioner(u_loss, up, args, mesh, bg_model=bg)

    def solve():
        before = banded_energy.launch_counts["banded_vg"]
        sol, hist = pt.aux_pcg_solve(u_loss, up, args, pre=pre, bg_model=bg,
                                     max_iters=60, tol=1e-6)
        torch.cuda.synchronize()
        return (sol["u"], hist,
                banded_energy.launch_counts["banded_vg"] - before)

    graphs = loop.captures["graphs"]
    u, hist, launches = solve()
    assert loop.captures["graphs"] - graphs == 1
    monkeypatch.setattr(loop, "capturable", lambda device: False)
    eu, ehist, elaunches = solve()
    assert loop.captures["graphs"] - graphs == 1
    assert launches == elaunches > 0
    assert torch.equal(hist, ehist) and torch.equal(u, eu)


@pytest.mark.cuda
def test_a_captured_aux_solve_counts_the_hybrid_route_as_an_eager_one(
        dev, monkeypatch):
    """The hybrid route launches no kernel of the port; its counter moves
    on every replay of the captured iteration as the eager calls move it:
    the right-hand side and one matvec each call of the loop body."""
    from hidenn_fem_tpu_torch.ops import losses

    mesh = pt.generate_mesh_hybrid(lc=0.05, device=dev)
    assert mesh.hybrid is not None
    energy = pt.PlaneStressEnergy(model=pt.TriangleP1())

    def u_loss(p, coords, m):
        return energy.total({"coords": coords, "u": p["u"]}, m)

    up = {"u": torch.zeros((mesh.n_nodes, 2), device=dev)}
    args = (mesh.coords, mesh)
    bg = StructuredGridP1(E=10e9, nu=0.3)
    pre = pt.build_aux_preconditioner(u_loss, up, args, mesh, bg_model=bg)
    assert pre.lat_kind == "reshape" and pre.rim_corners is not None

    def solve():
        before = losses.route_counts["hybrid"]
        sol, hist = pt.aux_pcg_solve(u_loss, up, args, pre=pre, bg_model=bg,
                                     max_iters=60, tol=1e-6)
        torch.cuda.synchronize()
        return (sol["u"], hist, losses.route_counts["hybrid"] - before)

    graphs = loop.captures["graphs"]
    u, hist, evals = solve()
    assert loop.captures["graphs"] - graphs == 1
    monkeypatch.setattr(loop, "capturable", lambda device: False)
    eu, ehist, eevals = solve()
    assert loop.captures["graphs"] - graphs == 1
    iters = int(torch.count_nonzero(hist))
    calls = min(-(-iters // loop.READ_EVERY) * loop.READ_EVERY, 60)
    assert evals == eevals == 1 + calls
    assert torch.equal(hist, ehist) and torch.equal(u, eu)


@pytest.mark.cuda
def test_load_cases_on_one_aux_preconditioner_replay_its_two_graphs(
        dev, monkeypatch):
    from hidenn_fem_tpu_torch.ops import banded_energy
    from hidenn_fem_tpu_torch.solve import auxspace

    mesh = _banded_delaunay(dev)
    bg = StructuredGridP1(E=10e9, nu=0.3)
    up = {"u": torch.zeros((mesh.n_nodes, 2), device=dev)}
    args = (mesh.coords, mesh)

    def loss_of(magnitude):
        energy = pt.PlaneStressEnergy(model=pt.TriangleP1(),
                                      F_total=magnitude)

        def u_loss(p, coords, m):
            return energy.total({"coords": coords, "u": p["u"]}, m)
        return u_loss

    loss = loss_of(1e5)
    pre = pt.build_aux_preconditioner(loss, up, args, mesh, bg_model=bg)

    def solve(u_loss, p):
        before = banded_energy.launch_counts["banded_vg"]
        sol, hist = pt.aux_pcg_solve(u_loss, up, args, pre=p, bg_model=bg,
                                     max_iters=60, tol=1e-6)
        torch.cuda.synchronize()
        return (sol["u"], hist,
                banded_energy.launch_counts["banded_vg"] - before)

    held = dataclasses.replace(pre)
    gc.collect()
    graphs0, freed0 = loop.captures["graphs"], loop.captures["freed"]
    counts0 = dict(auxspace.plan_counts)
    cases = [loss, loss, loss, loss_of(6e4), loss]
    kept, recorded = [], []
    for i, u_loss in enumerate(cases):
        if i == 3:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                kept.append(solve(u_loss, held))
        else:
            kept.append(solve(u_loss, held))
        recorded.append(loop.captures["graphs"] - graphs0)
    assert recorded == [1, 2, 2, 2, 2]
    assert {k: auxspace.plan_counts[k] - counts0[k] for k in counts0} == {
        "built": 1, "reused": 4, "refused": 0}
    spans = _spans(prof)
    assert not _named(spans, "hidenn.loop.record")
    assert _named(spans, "hidenn.loop.replay")
    (check,) = _named(spans, "hidenn.aux.check")
    assert _named(spans, "hidenn.loop.replay")[-1][1] <= check[0]
    monkeypatch.setattr(loop, "capturable", lambda device: False)
    eager = [solve(u_loss, dataclasses.replace(pre))
             for u_loss in (loss, cases[3])]
    # a replay's K4 launches are the eager solve's, and the check's two
    # gradients (the plan's first solve has no check)
    assert kept[0][2] == eager[0][2] > 0
    for i, (u, hist, launches) in enumerate(kept):
        eu, eh, elaunches = eager[1 if i == 3 else 0]
        assert launches == elaunches + (2 if i else 0), i
        if i != 3:
            assert torch.equal(u, eu) and torch.equal(hist, eh), i
        else:
            assert float((u - eu).norm()) <= 1e-5 * float(eu.norm())
    gc.disable()
    try:
        del held
        assert loop.captures["freed"] - freed0 == 2
    finally:
        gc.enable()
