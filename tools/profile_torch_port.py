"""Where the time of the PyTorch port's solve goes, on a CUDA card.

Profiles (``torch.profiler``, CPU and CUDA activities) windows of energy
value-and-grad calls and of L-BFGS steps in a solve's steady state,
eager and captured (``*_lbfgs10_eager``, ``*_lbfgs10_captured``: the
drivers' step run eagerly, or recorded once in a CUDA graph and
replayed; ``steady_steps``), after a warm-up, on: the
example-4 plate on its default route (the lattice route, stencil kernel
K6) and on the gather route (lattice stripped: K1, K2, incidence_sum);
the 922K-class plate on the lattice route; example 6's 1000x500
``StructuredGridP1`` (K6); and the 898K Delaunay plate
(``generate_mesh_delaunay(lc=0.00218)``) on its banded route (K4 each
value-and-grad) and, banded tables stripped, on the flat gather route
(K1, K2, incidence_sum).  Two more windows profile the linear solvers
per iteration: ``cg_solve`` on the 898K Delaunay plate from u = 0 (K4
each matvec) and ``mg_pcg_solve`` on example 9's hole-free 961x481
``StructuredGridP1`` on a prebuilt hierarchy (K6 each level operator),
each a 10-iteration solve that runs to its cap; on the card each solve
records its own CUDA graph (``solve/loop.py``), so these windows hold one
eager warm-up and one recording a solve besides the replays
(``chip_smoke.py`` phase 23 times the steady-state iteration alone).  Three windows profile auxiliary-space PCG per iteration on a
preconditioner built once: example 10's 961x481 proxy plate on the
lattice-aligned background (``961x481_aux_lattice_bg``: K6 each matvec
and each level operator) and on the generic background
(``961x481_aux_generic``: windowed P^T), and the 898K Delaunay plate from
u = 0 (``898k_delaunay_aux``: K4 each matvec, flat P^T, K6 in the
V-cycle).  For each window it prints the wall time per call (per
iteration for the solver windows, with each kernel's launches per
iteration), the device-busy time likewise (the union of kernel
intervals), the idle share, the kernel launches per call (all CUDA
kernels the profiler saw), each kernel's device µs per call by name
(``key_averages()``), and the top operators by device and by host time.
Two windows take the steady-state MG-PCG iteration on example 9's plate
apart from the set-up, by the difference between tol-0 solves of 5 and
25 iterations (``steady_profile``), captured: ``961x481_mg_pcg_steady``
(``mg_pcg_solve`` on a hierarchy built once) and
``961x481_sharded_mg_1rank`` (the sharded MG "all" on a one-rank NCCL
group: K6 over a row window on every level); each prints device busy,
device kernels and the port's launches an iteration.
The ``pt_layouts`` window times the generic background's P^T alone in
both layouts, flat and windowed (device µs per call), on the 922K proxy
plate and the 898K Delaunay plate.  Each window's Chrome trace goes to
``<out>/<window>/`` (``utils.profiling.trace_to``); ``--cases`` picks
windows by name.  The ``ex1_epoch``, ``ex2_epoch`` and ``ex3_epoch``
windows profile examples 1-3 at their own sizes per training epoch
(plain torch: the kernel launches an epoch and the idle share are what
they show).

With ``--kernels`` it profiles the redesigned kernels alone instead, at
full size: K4, K3 and K5 (over the recompute windows, and over the
two-pass windows) on the 898K Delaunay plate's paired tables, K4 and
both kinds of K5 on its triangle tables, K4 at ``row_start`` on slice 1
of its paired tables rebanded for 4 ranks (and K5 there), K6 and K7 on
the 922K-class zigzag plate (and K6 and K7 over its row window 1 of 4,
and an empty kernel with K7's grid there: the launch floor) and on the
hole-free 961x481 "up" grid, 20 calls each, and prints each kernel's
device µs per call by name.  With
``--grads DIR`` as well it saves K4's energy and gradient and K5's
gradient on both kinds of window, for the 898K paired, triangle and strip
tables, and every kernel case's outputs, to ``DIR/banded_grads.pt``;
``--compare-grads A B`` then holds two such directories equal bit for bit
(``torch.equal``).  It passes every
device explicitly, so run as a script it also drives an older checkout of
the package for an A/B in one call:

    PYTHONPATH=<checkout> python tools/profile_torch_port.py --kernels

Run from the repository root:  ``python -m tools.profile_torch_port``
"""

import argparse
import contextlib
import dataclasses
import os
import re
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

import hidenn_fem_tpu_torch as ht
from hidenn_fem_tpu_torch.utils.profiling import trace_to


# kineto keeps only the device activities whose timestamps fall inside
# the profiling window by the host's clock, and the card's timestamps can
# lie off the host's (a kernel can seem to start before its launch): the
# first or last kernels of a short window, or all of them, are then
# dropped.  So each counting window opens and closes with WINDOW_PAD_S of
# host time in which nothing is launched.
WINDOW_PAD_S = 0.02


@contextlib.contextmanager
def device_window():
    """A torch.profiler window (CPU and CUDA activities) padded at both
    ends by WINDOW_PAD_S; the card is synchronized before the end pad."""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(WINDOW_PAD_S)
        yield prof
        torch.cuda.synchronize()
        time.sleep(WINDOW_PAD_S)


def _busy_ms(prof):
    """Union of device kernel intervals in the profile, in ms."""
    iv = sorted((e.time_range.start, e.time_range.end)
                for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in iv:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy / 1e3


def _kernel_events(prof):
    """(short kernel name, event) of each CUDA kernel in the profile."""
    return [(re.sub(r"^void\s+|\(anonymous namespace\)::|hdnn::", "",
                    evt.key).split("(")[0].strip(), evt)
            for evt in prof.key_averages()
            if evt.device_type == torch.autograd.DeviceType.CUDA]


def kernel_us(prof, calls):
    """Device µs per call of each kernel in the profile, by short name
    (from ``key_averages()``), largest first."""
    out = {}
    for name, evt in _kernel_events(prof):
        out[name] = out.get(name, 0.0) + evt.self_device_time_total / calls
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def _whole_windows(fn, calls, tries):
    """The kernel events of ``calls`` calls of ``fn()`` (after one warm-up
    call) in a padded window, profiled again (up to ``tries`` windows)
    while some kernel's count is no whole multiple of ``calls`` or no
    kernel was seen (a dropped event); the window that saw the most
    kernel events if none was whole."""
    fn()
    torch.cuda.synchronize()
    best = []
    for _ in range(tries):
        with device_window() as prof:
            for _ in range(calls):
                fn()
        events = _kernel_events(prof)
        if events and all(e.count % calls == 0 for _, e in events):
            return events
        if sum(e.count for _, e in events) > sum(e.count for _, e in best):
            best = events
    return best


def kernel_profile(fn, calls=20, tries=3):
    """Device µs per call of each kernel that ``fn()`` launches, by short
    name, over ``calls`` calls after one warm-up call.  The profiler can
    drop kernel events (it does on the H100), so a window in which some
    kernel's event count is no whole multiple of ``calls`` is profiled
    again, up to ``tries`` times; each kernel's time per call is its mean
    time per recorded launch times its launches per call (its count over
    ``calls``, rounded, at least 1), which a lost event does not bias."""
    events = _whole_windows(fn, calls, tries)
    out = {}
    for name, evt in events:
        per_call = max(1, round(evt.count / calls))
        out[name] = (out.get(name, 0.0) + per_call
                     * evt.self_device_time_total / max(evt.count, 1))
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def kernel_launches(fn, calls=20, tries=6):
    """Device kernels launched per call of ``fn()``, by short name: the
    profiler's event counts over ``calls`` calls after one warm-up call,
    profiled again (up to ``tries`` times) while some count is no whole
    multiple of ``calls`` (a dropped event)."""
    out = {}
    for name, evt in _whole_windows(fn, calls, tries):
        out[name] = out.get(name, 0) + evt.count / calls
    return out


def steady_profile(solve, caps):
    """One iteration of a solver's steady state from the profiler: the
    difference between ``solve(caps[0])`` and ``solve(caps[1])`` (tol-0
    solves that run to their caps, set-up alike in both), over the
    iterations between: (device busy ms, device kernels, {kernel: device
    µs}) an iteration."""
    out = []
    for m in caps:
        with device_window() as prof:
            solve(m)
        out.append((_busy_ms(prof),
                    sum(e.count for _, e in _kernel_events(prof)),
                    kernel_us(prof, 1)))
    d = caps[1] - caps[0]
    by_name = {k: (v - out[0][2].get(k, 0.0)) / d
               for k, v in out[1][2].items()}
    return ((out[1][0] - out[0][0]) / d, (out[1][1] - out[0][1]) / d,
            dict(sorted(by_name.items(), key=lambda kv: -kv[1])))


def _launch_counts():
    """The launch counters of every kernel module, summed by name."""
    from hidenn_fem_tpu_torch.ops import (banded_energy, element_energy,
                                          lattice_slab)
    out = {}
    for m in (banded_energy, element_energy, lattice_slab):
        out.update(m.launch_counts)
    return out


def _window(name, fn, calls, out_dir, card, iters=1):
    """Profile ``calls`` calls of ``fn`` after one warm-up call; times are
    per call, or per iteration (with the kernels' launches per iteration)
    when each call runs ``iters``."""
    fn()
    torch.cuda.synchronize()
    before = _launch_counts()
    with trace_to(os.path.join(out_dir, name)) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / (calls * iters)
    busy = _busy_ms(prof) / (calls * iters)
    unit = "call" if iters == 1 else "iteration"
    launched = sum(e.count for _, e in _kernel_events(prof))
    print(f"== {name}: {wall:.4f} ms/{unit} wall, {busy:.4f} ms/{unit} "
          f"device busy, idle share {1 - busy / wall:.3f}, "
          f"{launched / (calls * iters):.1f} kernel launches/{unit} "
          f"[{card}]")
    if iters > 1:
        launched = {k: (v - before[k]) / (calls * iters)
                    for k, v in _launch_counts().items() if v > before[k]}
        print("   launches per iteration: " + ", ".join(
            f"{k} {v:.2f}" for k, v in launched.items()))
    for kernel, us in kernel_us(prof, calls * iters).items():
        print(f"   device {us:9.2f} us/{unit}  {kernel}")
    ka = prof.key_averages()
    print(ka.table(sort_by="self_cuda_time_total", row_limit=15))
    print(ka.table(sort_by="self_cpu_time_total", row_limit=12))


def steady_steps(loss, params, loss_args, optimizer, capture, steps=10):
    """A closure that runs ``steps`` steps of ``optimizer`` on ``loss`` from
    ``params`` through the drivers' stepper (``solve/drivers.py``), the
    steps of one solve carried on from call to call: on the card its
    first call runs the optimizer's first call and the warm-up eagerly
    and, with ``capture``, records the step and replays it; every later
    call is the steady state alone (replays, or eager steps)."""
    from hidenn_fem_tpu_torch.solve import drivers

    vg = drivers._value_and_grad(loss, params, tuple(loss_args))
    leaf = drivers._leaf(params)
    stepper = drivers._Stepper(
        vg, optimizer, leaf, optimizer.init(leaf.detach(), like=params),
        capture=capture)
    return lambda: stepper.run(steps)


def _case(loss, params, data, memory_size=100):
    def vg():
        p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        v = loss(p, data)
        torch.autograd.grad(v, [p["coords"], p["u"]])

    def steps(capture):
        return steady_steps(loss, params, (data,),
                            ht.lbfgs(memory_size=memory_size), capture)
    return vg, steps


def _plate(mesh, dev):
    energy = ht.PlaneStressEnergy(model=ht.TriangleP1())
    u0 = 1e-5 * np.random.default_rng(0).standard_normal((mesh.n_nodes, 2))
    params = ht.params_from_numpy(
        {"coords": mesh.coords.cpu().numpy(), "u": u0}, device=dev)
    return _case(energy.total, params, mesh)


def _example6(dev):
    grid = ht.generate_structured_grid(
        holes=((0.5, 0.7, 0.12), (1.0, 0.3, 0.15), (1.4, 0.6, 0.1)),
        nx=1000, ny=500, device=dev)
    model = ht.StructuredGridP1()
    return _case(model.total,
                 model.init(np.random.default_rng(0), grid, device=dev),
                 grid, memory_size=10)


def _cg_898k(mesh, dev, iters=10):
    """A cg_solve of ``iters`` iterations from u = 0 (tol 0: it runs to
    its cap) on ``mesh``'s default route."""
    energy = ht.PlaneStressEnergy(model=ht.TriangleP1())

    def loss(p, coords, m):
        return energy({"u": p["u"], "coords": coords}, m)
    u0 = {"u": torch.zeros((mesh.n_nodes, 2), device=dev)}
    return lambda: ht.cg_solve(loss, u0, (mesh.coords, mesh),
                               max_iters=iters, tol=0.0)


def _mg_961(dev, iters=10):
    """An mg_pcg_solve of ``iters`` iterations (tol 0) on example 9's
    plate, on a hierarchy built once."""
    grid = ht.generate_structured_grid(nx=961, ny=481, device=dev)
    model = ht.StructuredGridP1(E=10e9, nu=0.3)
    params = model.init(np.random.default_rng(0), grid, device=dev)
    with torch.no_grad():
        levels = ht.build_hierarchy(model, grid, model.coords(params, grid))
    return lambda: ht.mg_pcg_solve(model, grid, params, max_iters=iters,
                                   tol=0.0, levels=levels)


def _mg_steady(dev, card, sharded, caps=(5, 25), host_caps=(10, 210)):
    """The steady-state MG-PCG iteration on example 9's plate, captured:
    device busy and kernels from the difference between tol-0 solves at
    ``caps`` (``steady_profile``), the host clock's from the least of
    three solves at each of ``host_caps`` (a solve's set-up varies by tens
    of ms), after a warm-up solve: ``mg_pcg_solve`` on a hierarchy built
    once, or (``sharded``) the sharded MG "all" on a one-rank NCCL group,
    set-up included in every solve; the port's launches an iteration by
    its counters."""
    import socket

    from hidenn_fem_tpu_torch.parallel import (device_mesh,
                                               initialize_multihost,
                                               sharded_mg)

    grid = ht.generate_structured_grid(nx=961, ny=481, device=dev)
    model = ht.StructuredGridP1(E=10e9, nu=0.3)
    params = model.init(np.random.default_rng(0), grid, device=dev)
    if sharded:
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        initialize_multihost(f"localhost:{port}", 1, 0, backend="nccl")
        dmesh = device_mesh(device=dev)

        def solve(m):
            return sharded_mg.mg_pcg_solve_sharded(
                model, grid, params, dmesh=dmesh, max_iters=m, tol=0.0,
                engine="all")
    else:
        with torch.no_grad():
            levels = ht.build_hierarchy(model, grid,
                                        model.coords(params, grid))

        def solve(m):
            return ht.mg_pcg_solve(model, grid, params, max_iters=m,
                                   tol=0.0, levels=levels)
    try:
        solve(caps[0])
        counts, host = [], []
        for m in caps:
            before = _launch_counts()
            solve(m)
            torch.cuda.synchronize()
            counts.append({k: v - before[k]
                           for k, v in _launch_counts().items()})
        for m in host_caps:     # host clock, the least of three solves
            runs = []
            for _ in range(3):
                t0 = time.perf_counter()
                solve(m)
                torch.cuda.synchronize()
                runs.append(time.perf_counter() - t0)
            host.append(1e3 * min(runs))
        busy, kernels, by_name = steady_profile(solve, caps)
    finally:
        if sharded:
            torch.distributed.destroy_process_group()
    d = caps[1] - caps[0]
    launched = {k: (counts[1][k] - counts[0][k]) / d for k in counts[0]
                if counts[1][k] != counts[0][k]}
    name = ("961x481_sharded_mg_1rank (engine all, one NCCL rank)"
            if sharded else "961x481_mg_pcg_steady")
    wall = (host[1] - host[0]) / (host_caps[1] - host_caps[0])
    print(f"== {name}, captured: {wall:.4f} ms on the host clock, "
          f"{busy:.4f} ms device busy (idle share {1 - busy / wall:.3f}) "
          f"and {kernels:.1f} device kernels an iteration (tol-0 solves of "
          f"{caps[0]} and {caps[1]} iterations profiled, {host_caps[0]} and "
          f"{host_caps[1]} on the host clock) [{card}]")
    print("   launches per iteration: " + ", ".join(
        f"{k} {v:.2f}" for k, v in launched.items()))
    for kernel, us in list(by_name.items())[:12]:
        print(f"   device {us:9.2f} us/iteration  {kernel}")


def _aux_setup(mesh, dev, lattice_bg):
    """(loss, u = 0 params, loss args, preconditioner built once) of
    aux-PCG on ``mesh``'s default route."""
    energy = ht.PlaneStressEnergy(model=ht.TriangleP1())

    def loss(p, coords, m):
        return energy({"u": p["u"], "coords": coords}, m)
    u0 = {"u": torch.zeros((mesh.n_nodes, 2), device=dev)}
    args = (mesh.coords, mesh)
    pre = ht.build_aux_preconditioner(
        loss, u0, args, mesh, bg_model=ht.StructuredGridP1(E=10e9, nu=0.3),
        lattice_bg=lattice_bg)
    return loss, u0, args, pre


def _aux(mesh, dev, lattice_bg, iters=10):
    """An aux_pcg_solve of ``iters`` iterations (tol 0) from u = 0 on a
    preconditioner built once."""
    loss, u0, args, pre = _aux_setup(mesh, dev, lattice_bg)
    return lambda: ht.aux_pcg_solve(loss, u0, args, pre=pre,
                                    max_iters=iters, tol=0.0)


def _example_epochs(which, dev, epochs=20):
    """``epochs`` training epochs of example 1, 2 or 3 at its own size
    (plain torch, no kernel): example 2 as the example runs them (its own
    eager loop over minibatches), examples 1 and 3 as ``minimize``'s Adam
    steps in the steady state of one solve (``steady_steps``: captured
    and replayed)."""
    from hidenn_fem_tpu_torch.config import Projection2DConfig

    if which == 2:
        from examples.example2_torch import main
        return lambda: main(Projection2DConfig(epochs=epochs), device=dev)
    if which == 1:
        model, params = ht.Linear1D.from_node_coords(
            np.linspace(0, 1, 100), r_adapt=True, device=dev)
        x = torch.linspace(0, 1, 1000, device=dev)
        u = torch.sin(2 * np.pi * x)
        loss = lambda p: ht.l2_loss(model, p, x, u)  # noqa: E731
        lr = 5e-3
    else:
        from examples.example3_torch import b_force
        model, params = ht.Linear1D.from_node_coords(
            np.linspace(0, 10, 89), r_adapt=True, u0=0.0, uN=0.0,
            device=dev)
        loss = lambda p: ht.bar_energy_1d(  # noqa: E731
            model, p, 2, b_force, E=175.0)
        lr = 1e-4
    return steady_steps(loss, params, (), ht.adam(lr), capture=True,
                        steps=epochs)


def _pt_layouts(meshes, dev, card, calls=20):
    """The generic background's P^T alone, flat and windowed, on each
    mesh: device µs per call (the windowed tables built without JAX's
    64K window limit where the set-up chose the flat ones)."""
    from hidenn_fem_tpu_torch.solve import auxspace as aux

    for tag, mesh in meshes:
        _, _, _, pre = _aux_setup(mesh, dev, lattice_bg=False)
        n = mesh.n_nodes
        chosen = "windowed" if pre.ptw_rel is not None else "flat"
        if pre.ptw_rel is None:
            rel, w, starts, width = aux._windowed_pt(
                pre.pt_idx.reshape(pre.pt_w.shape).cpu().numpy(),
                pre.pt_w.cpu().numpy(), n, pre.grid.nx, pre.grid.ny,
                window_limit=n)
            windowed = dataclasses.replace(
                pre, ptw_rel=torch.tensor(rel, device=dev),
                ptw_w=torch.tensor(w, device=dev),
                ptw_starts=torch.tensor(starts, device=dev).long(),
                ptw_width=width)
        else:
            windowed = pre
        flat = dataclasses.replace(pre, ptw_rel=None, ptw_w=None,
                                   ptw_starts=None, ptw_width=0)
        rf = torch.tensor(np.random.default_rng(1).standard_normal((n, 2)),
                          dtype=torch.float32, device=dev) * pre.free
        a = aux._generic_pt(flat, rf)
        b = aux._generic_pt(windowed, rf)
        err = float((a - b).abs().max() / a.abs().max())
        res = {}
        for layout, p in (("flat", flat), ("windowed", windowed)):
            per = kernel_profile(lambda: aux._generic_pt(p, rf), calls,
                                 tries=6)
            res[layout] = sum(per.values())
        print(f"== P^T at {tag} ({n} fine nodes, background "
              f"{pre.grid.nx}x{pre.grid.ny}, flat depth "
              f"{pre.pt_w.shape[1]}, window width {windowed.ptw_width}; "
              f"the set-up chose {chosen}): flat {res['flat']:.2f} us, "
              f"windowed {res['windowed']:.2f} us device per call; "
              f"max|flat - windowed| / max|flat| {err:.3e} [{card}]")


def _node(coords, seed):
    """[N, 4] node table: the coordinates and u ~ 1e-4 N(0, 1)."""
    xy = coords.reshape(-1, 2).float()
    u = 1e-4 * np.random.default_rng(seed).standard_normal(xy.shape)
    return torch.cat([xy, torch.tensor(u, dtype=torch.float32,
                                       device=xy.device)], 1).contiguous()


def _kernel_cases(dev):
    from hidenn_fem_tpu_torch.ops import banded_energy as be
    from hidenn_fem_tpu_torch.ops import lattice_slab as ls
    from hidenn_fem_tpu_torch.parallel.sharded_slab import row_window
    from hidenn_fem_tpu_torch.parallel.sharding import (rank_tables,
                                                        reband_for_shards)

    E, nu, w = 10e9, 0.3, 0.5
    plate = ht.generate_mesh(nx=961, ny=481, keep_dead_nodes=True,
                             device=dev)
    node = _node(plate.coords, 0)
    kw = ls.route_stencil(plate.lattice)
    grid = ht.generate_structured_grid(nx=961, ny=481, split="up",
                                       device=dev)
    gnode = _node(grid.coords, 1)
    gkw = dict(diag=ls.UP, t1=grid.quad_mask, t2=grid.quad_mask)
    mesh = ht.generate_mesh_delaunay(lc=0.00218, device=dev)
    bnode = _node(mesh.coords, 2)
    ba = mesh.banded_paired
    ba5 = without_recompute(ba, keep_tables=True)
    ba5b = without_recompute(ba, keep_tables=False)
    tri = mesh.banded
    ct = torch.tensor(0.75, device=dev)
    lo, hi = row_window(961, 1, 4)
    ba4 = reband_for_shards(mesh, 4).banded_paired
    loc, rs = rank_tables(ba4, 1, 4)
    loc5 = without_recompute(loc, keep_tables=True)
    cases = {
        "922k_zigzag_K6": lambda: ls.lattice_stencil_vg(
            node, 961, 481, E, nu, w, **kw),
        "922k_zigzag_K7": lambda: ls.lattice_stencil_fwd(
            node, 961, 481, E, nu, w, **kw),
        "922k_zigzag_K6_rows_1_of_4": lambda: ls.lattice_stencil_vg_rows(
            node, 961, 481, E, nu, w, lo, hi, **kw),
        "922k_zigzag_K7_rows_1_of_4": lambda: ls.lattice_stencil_fwd_rows(
            node, 961, 481, E, nu, w, lo, hi, **kw),
        "961x481_up_K6": lambda: ls.lattice_stencil_vg(
            gnode, 961, 481, E, nu, w, **gkw),
        "961x481_up_K7": lambda: ls.lattice_stencil_fwd(
            gnode, 961, 481, E, nu, w, **gkw),
        "898k_paired_K4": lambda: be.banded_vg(bnode, ba, E, nu, w),
        "898k_paired_K4_rows_1_of_4": lambda: be.banded_vg_rows(
            bnode, loc, E, nu, w, rs),
        "898k_paired_K5_rows_1_of_4": lambda: be.banded_bwd_rows(
            bnode, loc5, ct, E, nu, w, rs),
        "898k_paired_K3": lambda: be.banded_fwd(bnode, ba, E, nu, w),
        "898k_paired_K5": lambda: be.banded_bwd(bnode, ba5, ct, E, nu, w),
        "898k_paired_K5_two_pass": lambda: be.banded_bwd(bnode, ba5b, ct, E,
                                                         nu, w),
        "898k_triangle_K4": lambda: be.banded_vg(bnode, tri, E, nu, w),
        "898k_triangle_K5": lambda: be.banded_bwd(
            bnode, without_recompute(tri, True), ct, E, nu, w),
        "898k_triangle_K5_two_pass": lambda: be.banded_bwd(
            bnode, without_recompute(tri, False), ct, E, nu, w),
    }
    return cases, mesh, bnode


def without_recompute(ba, keep_tables):
    """The tables with the ownership intervals (and, unless keep_tables,
    every recompute table) removed: K5's two kinds of window."""
    drop = dict(re_own_lo=None, re_own_hi=None)
    if not keep_tables:
        drop.update(re_nstarts=None, re_estarts=None, re_conn_rel=None,
                    re_inc_rel=None)
    return dataclasses.replace(ba, **drop)


def _banded_grads(cases, mesh, node, dev, out_dir):
    """K4's energy and gradient and K5's gradient (ct 0.75) on both kinds
    of window, for the paired, triangle and strip tables, and the outputs
    of every kernel case (energies and gradients), saved to
    ``out_dir/banded_grads.pt``."""
    from hidenn_fem_tpu_torch.mesh import banded as mb
    from hidenn_fem_tpu_torch.ops import banded_energy as be

    E, nu, w = 10e9, 0.3, 0.5
    ct = torch.tensor(0.75, device=dev)
    strip = mb.build_striped_assembly(mesh.connectivity.cpu().numpy(),
                                      mesh.n_nodes, device=dev)
    out = {}
    for tag, ba in (("paired", mesh.banded_paired),
                    ("triangle", mesh.banded), ("strip", strip)):
        e4, g4 = be.banded_vg(node, ba, E, nu, w)
        out[f"{tag}_K4_energy"] = e4
        out[f"{tag}_K4_grad"] = g4
        for kind, keep in (("recompute", True), ("two_pass", False)):
            out[f"{tag}_K5_{kind}"] = be.banded_bwd(
                node, without_recompute(ba, keep), ct, E, nu, w)
    for name, fn in cases.items():
        got = fn()
        for i, t in enumerate(got if isinstance(got, tuple) else (got,)):
            out[f"{name}_{i}"] = t
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "banded_grads.pt")
    torch.save({k: v.cpu() for k, v in out.items()}, path)
    print(f"saved {len(out)} tensors to {path}")


def _compare_grads(a, b):
    """Holds two ``--grads`` directories equal bit for bit."""
    ga = torch.load(os.path.join(a, "banded_grads.pt"))
    gb = torch.load(os.path.join(b, "banded_grads.pt"))
    if sorted(ga) != sorted(gb):
        raise SystemExit(f"different tensors: {sorted(ga)} vs {sorted(gb)}")
    differ = [k for k in sorted(ga) if not torch.equal(ga[k], gb[k])]
    for k in sorted(ga):
        print(f"   {k}: {'differs' if k in differ else 'equal bit for bit'}")
    if differ:
        raise SystemExit(f"{len(differ)} of {len(ga)} tensors differ")


def graph_us(fn, calls=20, replays=20):
    """µs per call of ``fn()`` recorded ``calls`` times in one CUDA graph
    and replayed (CUDA events around ``replays`` replays, after one): the
    calls' launches as a captured path runs them, the gaps between its
    kernel nodes included and no host work."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            for _ in range(calls):
                fn()
    torch.cuda.current_stream().wait_stream(side)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return 1e3 * start.elapsed_time(end) / (replays * calls)


def _kernels(dev, card, grads_dir=None, calls=20):
    from hidenn_fem_tpu_torch.ops import lattice_slab as ls
    from hidenn_fem_tpu_torch.parallel.sharded_slab import row_window

    cases, mesh, bnode = _kernel_cases(dev)
    if grads_dir:
        _banded_grads(cases, mesh, bnode, dev, grads_dir)
    lib = ls._library()
    if hasattr(lib, "hdnn_lattice_launch_floor"):
        lo, hi = row_window(961, 1, 4)
        stream = torch.cuda.current_stream(dev).cuda_stream
        cases["922k_K7_rows_1_of_4_launch_floor"] = (
            lambda: lib.hdnn_lattice_launch_floor(dev.index, hi - lo, 481,
                                                  stream))
    for name, fn in cases.items():
        per = kernel_profile(fn, calls)
        print(f"== {name}: {sum(per.values()):.2f} us/call device, "
              f"{graph_us(fn):.2f} us/call in a CUDA graph [{card}]")
        for kernel, us in per.items():
            print(f"   device {us:9.2f} us/call  {kernel}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="chiprun_out")
    ap.add_argument("--kernels", action="store_true",
                    help="profile the redesigned kernels alone")
    ap.add_argument("--grads", metavar="DIR",
                    help="with --kernels: save the banded gradients here")
    ap.add_argument("--compare-grads", nargs=2, metavar=("A", "B"),
                    help="hold two --grads directories equal bit for bit")
    ap.add_argument("--cases", nargs="+", metavar="NAME",
                    help="profile only these windows (default: all)")
    args = ap.parse_args()
    if args.compare_grads:
        _compare_grads(*args.compare_grads)
        return
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_port: needs a CUDA device")
    dev = torch.device("cuda", 0)
    card = torch.cuda.get_device_name(0)
    if args.kernels:
        _kernels(dev, card, args.grads)
        return
    os.makedirs(args.out, exist_ok=True)
    ex4 = ht.generate_mesh(nx=200, ny=100, keep_dead_nodes=True,
                           device=dev)
    delaunay = []                     # built once, by the first window

    def _delaunay():
        if not delaunay:
            delaunay.append(ht.generate_mesh_delaunay(lc=0.00218,
                                                      device=dev))
        return delaunay[0]

    cases = {
        "ex4_lattice": lambda: _plate(ex4, dev),
        # lattice and banded tables stripped, so the gather route runs
        "ex4_gather": lambda: _plate(dataclasses.replace(
            ex4, lattice=None, banded=None, banded_paired=None), dev),
        "922k_lattice": lambda: _plate(ht.generate_mesh(
            nx=961, ny=481, keep_dead_nodes=True, device=dev), dev),
        "ex6_structured": lambda: _example6(dev),
        "898k_delaunay_banded": lambda: _plate(_delaunay(), dev),
        "898k_delaunay_flat": lambda: _plate(dataclasses.replace(
            _delaunay(), banded=None, banded_paired=None), dev),
    }
    proxy = []                        # example 10's plate, built once

    def _proxy():
        if not proxy:
            proxy.append(ht.proxy_plate_mesh(nx=961, ny=481, device=dev))
        return proxy[0]

    solvers = {
        "898k_delaunay_cg": lambda: _cg_898k(_delaunay(), dev),
        "961x481_mg_pcg": lambda: _mg_961(dev),
        "961x481_aux_lattice_bg": lambda: _aux(_proxy(), dev, True),
        "961x481_aux_generic": lambda: _aux(_proxy(), dev, False),
        "898k_delaunay_aux": lambda: _aux(_delaunay(), dev, True),
    }
    for name, make in cases.items():
        if args.cases and name not in args.cases:
            continue
        vg, steps = make()
        _window(f"{name}_value_and_grad", vg, 20, args.out, card)
        _window(f"{name}_lbfgs10_eager", steps(False), 2, args.out, card,
                iters=10)
        _window(f"{name}_lbfgs10_captured", steps(True), 2, args.out, card,
                iters=10)
    for name, make in solvers.items():
        if args.cases and name not in args.cases:
            continue
        _window(f"{name}_iteration", make(), 3, args.out, card, iters=10)
    for which in (1, 2, 3):
        name = f"ex{which}_epoch"
        if args.cases and name not in args.cases:
            continue
        _window(name, _example_epochs(which, dev), 3, args.out, card,
                iters=20)
    for name, sharded in (("961x481_mg_pcg_steady", False),
                          ("961x481_sharded_mg_1rank", True)):
        if args.cases and name in args.cases:
            _mg_steady(dev, card, sharded)
    if not args.cases or "pt_layouts" in args.cases:
        _pt_layouts((("922K proxy plate", _proxy()),
                     ("898K Delaunay plate", _delaunay())), dev, card)


if __name__ == "__main__":
    main()
