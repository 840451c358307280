"""Where the time of the PyTorch port's solve goes, on a CUDA card.

Profiles (``torch.profiler``, CPU and CUDA activities) a window of L-BFGS
steps and of energy value-and-grad calls, after a warm-up, on: the
example-4 plate on its default route (the lattice route, stencil kernel
K6) and on the gather route (lattice stripped: K1, K2, incidence_sum);
the 922K-class plate on the lattice route; example 6's 1000x500
``StructuredGridP1`` (K6); and the 898K Delaunay plate
(``generate_mesh_delaunay(lc=0.00218)``) on its banded route (K4 each
value-and-grad) and, banded tables stripped, on the flat gather route
(K1, K2, incidence_sum).  For each window it prints the wall time per
call, the device-busy time per call (the union of kernel intervals), the
idle share, each kernel's device µs per call by name (``key_averages()``),
and the top operators by device and by host time.  Chrome traces go to
the ``--out`` directory.

With ``--kernels`` it profiles the redesigned kernels alone instead, at
full size: K4 (and K3, K5) on the 898K Delaunay plate's paired tables,
K6 and K7 on the 922K-class zigzag plate and on the hole-free 961x481
"up" grid, 20 calls each, and prints each kernel's device µs per call by
name.  It passes every device explicitly, so it also drives an older
checkout of the package (``PYTHONPATH=<checkout>``) for an A/B in one
call.

Run from the repository root:  ``python -m tools.profile_torch_port``
"""

import argparse
import dataclasses
import os
import re
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

import hidenn_fem_tpu_torch as ht


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


def kernel_us(prof, calls):
    """Device µs per call of each kernel in the profile, by short name
    (from ``key_averages()``), largest first."""
    out = {}
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = re.sub(r"^void\s+|\(anonymous namespace\)::|hdnn::", "",
                      evt.key).split("(")[0].strip()
        out[name] = out.get(name, 0.0) + evt.self_device_time_total / calls
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def _window(name, fn, calls, out_dir, card):
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / calls
    busy = _busy_ms(prof) / calls
    print(f"== {name}: {wall:.4f} ms/call wall, {busy:.4f} ms/call device "
          f"busy, idle share {1 - busy / wall:.3f} [{card}]")
    for kernel, us in kernel_us(prof, calls).items():
        print(f"   device {us:9.2f} us/call  {kernel}")
    ka = prof.key_averages()
    print(ka.table(sort_by="self_cuda_time_total", row_limit=15))
    print(ka.table(sort_by="self_cpu_time_total", row_limit=12))
    prof.export_chrome_trace(os.path.join(out_dir, f"trace_{name}.json"))


def _case(loss, params, data, memory_size=100):
    def vg():
        p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        v = loss(p, data)
        torch.autograd.grad(v, [p["coords"], p["u"]])

    def steps():
        ht.run_lbfgs(loss, params, num_steps=10, memory_size=memory_size,
                     loss_args=(data,))
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


def _node(coords, seed):
    """[N, 4] node table: the coordinates and u ~ 1e-4 N(0, 1)."""
    xy = coords.reshape(-1, 2).float()
    u = 1e-4 * np.random.default_rng(seed).standard_normal(xy.shape)
    return torch.cat([xy, torch.tensor(u, dtype=torch.float32,
                                       device=xy.device)], 1).contiguous()


def _kernel_cases(dev):
    from hidenn_fem_tpu_torch.ops import banded_energy as be
    from hidenn_fem_tpu_torch.ops import lattice_slab as ls

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
    ba5 = dataclasses.replace(ba, re_own_lo=None, re_own_hi=None)
    ct = torch.tensor(0.75, device=dev)
    return {
        "922k_zigzag_K6": lambda: ls.lattice_stencil_vg(
            node, 961, 481, E, nu, w, **kw),
        "922k_zigzag_K7": lambda: ls.lattice_stencil_fwd(
            node, 961, 481, E, nu, w, **kw),
        "961x481_up_K6": lambda: ls.lattice_stencil_vg(
            gnode, 961, 481, E, nu, w, **gkw),
        "961x481_up_K7": lambda: ls.lattice_stencil_fwd(
            gnode, 961, 481, E, nu, w, **gkw),
        "898k_paired_K4": lambda: be.banded_vg(bnode, ba, E, nu, w),
        "898k_paired_K3": lambda: be.banded_fwd(bnode, ba, E, nu, w),
        "898k_paired_K5": lambda: be.banded_bwd(bnode, ba5, ct, E, nu, w),
    }


def _kernels(dev, card, calls=20):
    for name, fn in _kernel_cases(dev).items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        per = kernel_us(prof, calls)
        print(f"== {name}: {sum(per.values()):.2f} us/call device [{card}]")
        for kernel, us in per.items():
            print(f"   device {us:9.2f} us/call  {kernel}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="chiprun_out")
    ap.add_argument("--kernels", action="store_true",
                    help="profile the redesigned kernels alone")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_port: needs a CUDA device")
    dev = torch.device("cuda", 0)
    card = torch.cuda.get_device_name(0)
    if args.kernels:
        _kernels(dev, card)
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
    for name, make in cases.items():
        vg, steps = make()
        _window(f"{name}_value_and_grad", vg, 20, args.out, card)
        _window(f"{name}_lbfgs10", steps, 2, args.out, card)


if __name__ == "__main__":
    main()
