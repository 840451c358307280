"""Example 5 through the PyTorch port: the million-element plate (the
port of ``examples/example5_scaling.py``).

The 2D plate under traction with the three reference holes on a
``generate_mesh`` lattice of 1000x500 nodes (922,250 elements): the
value-and-grad step of the energy timed by slope timing
(``utils.profiling.slope_time_scan``, 5 and 55 steps), then 200 L-BFGS
steps twice (cold, then warm).

With one process it runs on one card, on the route the port's routing
picks for the plate, which is the JAX package's: ``generate_mesh`` drops
the nodes inside the holes, so the detected lattice is renumbered and
the energy takes the lattice route in plain torch (the stencil kernels
take identity-numbered lattices only), as the JAX package takes it in
XLA.  Launched as one of ``WORLD_SIZE > 1`` ranks (``torchrun``, or
``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK`` set by hand), it
joins the group (``parallel.initialize_multihost``), pads and shards the
element axis (``parallel.shard_mesh``) and runs ``shard_map_energy``, as
the JAX package shards its mesh over the devices.

It prints quadrature-point evaluations per second and ms per step beside
the card's name and power limit, and the ratio to the reference's CPU
baseline (8.36e5 qp/s), labelled as that.

The initial displacement is 1e-5 N(0, 1) from
``np.random.default_rng(seed)``, or the ``u0`` given.

Run: ``python -m examples.example5_scaling_torch`` (on the card;
``--device cpu`` for the CPU)
"""

import argparse
import os
import subprocess
import time

import numpy as np
import torch

import hidenn_fem_tpu_torch as ht
from hidenn_fem_tpu_torch.parallel import sharding as sh
from hidenn_fem_tpu_torch.parallel.multihost import initialize_multihost
from hidenn_fem_tpu_torch.utils.profiling import slope_time_scan

HOLES = ((0.5, 0.7, 0.12), (1.0, 0.3, 0.15), (1.4, 0.6, 0.1))
REFERENCE_CPU_QPS = 8.36e5


def card_line(device) -> str:
    """The card's name and power limit, or "cpu"."""
    if torch.device(device).type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def main(nx=1000, ny=500, lbfgs_steps=200, device="cuda", seed=0,
         u0=None):
    """Returns (params after the warm L-BFGS run, its loss history
    [lbfgs_steps]), as the JAX package's example does."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1:
        initialize_multihost(
            backend="nccl" if torch.device(device).type == "cuda"
            else "gloo")
        dmesh = sh.device_mesh(device=None if torch.device(device).type
                               == "cuda" else device)
        device = dmesh.device
    t0 = time.time()
    mesh = ht.generate_mesh(length=2.0, height=1.0, holes=HOLES, nx=nx,
                            ny=ny, device=device)
    route = mesh.lattice
    print(f"mesh: {mesh.n_elements} elements, {mesh.n_nodes} nodes "
          f"({time.time() - t0:.1f}s host gen; lattice route: "
          f"{route is not None}, identity numbering: "
          f"{route is not None and route.identity}; banded tables: "
          f"{mesh.banded is not None or mesh.banded_paired is not None})")

    model = ht.TriangleP1(u_fixed=0.0)
    if u0 is None:
        u0 = 1e-5 * np.random.default_rng(seed).standard_normal(
            (mesh.n_nodes, 2))
    params = ht.params_from_numpy({"coords": mesh.coords.cpu().numpy(),
                                   "u": u0}, device=device)
    energy = ht.PlaneStressEnergy(model=model, E=10e9, nu=0.3)

    if world > 1:
        mesh_run = sh.shard_mesh(mesh, dmesh)
        params = sh.replicate(params, dmesh)
        loss = sh.shard_map_energy(energy, dmesh)
        print(f"sharded over {world} ranks (element axis)")
    else:
        mesh_run, loss = mesh, energy.total

    # throughput probe (slope-timed energy fwd+bwd); the mesh rides as a
    # loop-invariant argument, not in the carry
    def step(p, m):
        q = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        val = loss(q, m)
        grads = torch.autograd.grad(val, [q[k] for k in sorted(q)])
        return ({k: (q[k] - 1e-15 * g).detach()
                 for k, g in zip(sorted(q), grads)}, val.detach())

    card = card_line(device)
    dt = slope_time_scan(step, params, n1=5, n2=55, args=(mesh_run,))
    nqp = mesh.n_elements * 4
    print(f"energy fwd+bwd: {dt * 1e3:.3f} ms/step -> {nqp / dt:.3e} qp/s "
          f"[{card}] ({nqp / dt / REFERENCE_CPU_QPS:.0f}x the reference "
          "CPU baseline)")

    # a short L-BFGS solve (full solves just scale num_steps)
    _sync(device)
    t0 = time.time()
    _, losses = ht.run_lbfgs(loss, params, num_steps=lbfgs_steps,
                             loss_args=(mesh_run,))
    losses = losses.cpu().numpy()
    print(f"L-BFGS {lbfgs_steps} iters: {time.time() - t0:.3f}s wall "
          f"(cold), energy {losses[0]:.4e} -> {losses[-1]:.4e} [{card}]")
    _sync(device)
    t0 = time.time()
    params, losses = ht.run_lbfgs(loss, params, num_steps=lbfgs_steps,
                                  loss_args=(mesh_run,))
    losses = losses.cpu().numpy()
    print(f"L-BFGS {lbfgs_steps} iters: {time.time() - t0:.3f}s wall "
          f"(warm) [{card}]")
    return params, losses


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nx", type=int, default=1000)
    ap.add_argument("--ny", type=int, default=500)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args()
    main(a.nx, a.ny, a.steps, a.device, a.seed)
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
