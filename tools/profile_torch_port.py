"""Where the time of the PyTorch port's solve goes, on a CUDA card.

Profiles (``torch.profiler``, CPU and CUDA activities) a window of L-BFGS
steps and of energy value-and-grad calls on the example-4 plate and on
the 922K-class plate, after a warm-up, and prints for each window: the
wall time per call, the device-busy time per call (the union of kernel
intervals), the idle share, and the top operators by device and by host
time.  Chrome traces go to ``--out`` (default ``chiprun_out/``).

Run from the repository root:  ``python -m tools.profile_torch_port``
"""

import argparse
import os
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
    ka = prof.key_averages()
    print(ka.table(sort_by="self_cuda_time_total", row_limit=15))
    print(ka.table(sort_by="self_cpu_time_total", row_limit=12))
    prof.export_chrome_trace(os.path.join(out_dir, f"trace_{name}.json"))


def _case(mesh, dev):
    model = ht.TriangleP1()
    energy = ht.PlaneStressEnergy(model=model)
    u0 = 1e-5 * np.random.default_rng(0).standard_normal((mesh.n_nodes, 2))
    params = ht.params_from_numpy(
        {"coords": mesh.coords.cpu().numpy(), "u": u0}, device=dev)

    def vg():
        p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        v = energy.total(p, mesh)
        torch.autograd.grad(v, [p["coords"], p["u"]])

    def steps():
        ht.run_lbfgs(energy.total, params, num_steps=10, loss_args=(mesh,))
    return vg, steps


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="chiprun_out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_port: needs a CUDA device")
    os.makedirs(args.out, exist_ok=True)
    dev = torch.device("cuda", 0)
    card = torch.cuda.get_device_name(0)
    meshes = {
        "ex4": ht.generate_mesh(nx=200, ny=100, keep_dead_nodes=True,
                                device=dev),
        "922k": ht.generate_mesh(nx=961, ny=481, keep_dead_nodes=True,
                                 device=dev),
    }
    for name, mesh in meshes.items():
        vg, steps = _case(mesh, dev)
        _window(f"{name}_value_and_grad", vg, 20, args.out, card)
        _window(f"{name}_lbfgs10", steps, 2, args.out, card)


if __name__ == "__main__":
    main()
