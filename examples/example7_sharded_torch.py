"""Example 7 on the PyTorch port: the element-sharded plate solve over a
``torch.distributed`` group (the port of ``examples/example7_sharded.py``).

The plate of example 4 at 129x65 nodes, its banded tables rebuilt so that
their block counts divide by the rank count (``reband_for_shards``), and
200 L-BFGS steps on ``shard_map_banded_energy``: each rank walks its slice
of the element and node blocks (K4's row variant on the card), the partial
energies and the placed node gradients are summed over the ranks, and
every rank runs the same L-BFGS on identical parameters.  Rank 0 then
holds the sharded energy at the solution to the single-rank energy.

    python -m examples.example7_sharded_torch                # 4 ranks
    python -m examples.example7_sharded_torch --ranks 2 --device cpu

The ranks are processes started here, joined over ``tcp://localhost``.
With ``--backend gloo`` (the default) several ranks share one card
(``cuda:0`` on a machine with one) or run on the CPU; ``--backend nccl``
needs a card a rank.
"""

from __future__ import annotations

import argparse
import multiprocessing as mp
import socket
import time

HOLES = [(0.5, 0.7, 0.12), (1.0, 0.3, 0.15), (1.4, 0.6, 0.1)]
BOUNDARIES = {"up": 0, "down": 0, "right": 2, "left": 1}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_device(device: str, rank: int) -> str:
    import torch

    if device == "cpu":
        return "cpu"
    return f"cuda:{rank % torch.cuda.device_count()}"


def run_rank(rank, ranks, port, nx, ny, steps, backend, device, queue):
    """One rank: join the group, solve, and report to ``queue``."""
    import torch

    import hidenn_fem_tpu_torch as pt
    from hidenn_fem_tpu_torch.parallel import (device_mesh,
                                               initialize_multihost,
                                               reband_for_shards, replicate,
                                               shard_map_banded_energy)

    try:
        initialize_multihost(f"localhost:{port}", ranks, rank, backend)
        dev = _rank_device(device, rank)
        dmesh = device_mesh(device=dev)
        mesh = pt.generate_mesh(length=2.0, height=1.0, holes=HOLES,
                                boundaries=BOUNDARIES, nx=nx, ny=ny,
                                device=dev)
        banded = reband_for_shards(mesh, ranks, window_limit=50_000)
        tbl = (banded.banded_paired if banded.banded_paired is not None
               else banded.banded)
        model = pt.TriangleP1()
        params = replicate(model.init(torch.Generator().manual_seed(0),
                                      mesh, device=dev), dmesh)
        energy = pt.PlaneStressEnergy(model=model, E=10e9, nu=0.3)
        loss_fn = shard_map_banded_energy(energy, dmesh)
        t0 = time.perf_counter()
        params, losses = pt.run_lbfgs(loss_fn, params, num_steps=steps,
                                      loss_args=(banded,))
        if dev != "cpu":
            torch.cuda.synchronize(dev)
        seconds = time.perf_counter() - t0
        with torch.no_grad():
            sharded = float(loss_fn(params, banded))
            single = float(energy.total(params, mesh))
        out = dict(rank=rank, losses=losses.cpu().numpy(), single=single,
                   sharded=sharded, seconds=seconds,
                   blocks=(tbl.k, tbl.starts.shape[0],
                           tbl.re_nstarts.shape[0]),
                   sizes=(mesh.n_nodes, mesh.n_elements), device=dev)
        queue.put(out)
    except Exception as e:          # report, then fail this rank
        queue.put(dict(rank=rank, error=repr(e)))
        raise
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def main(nx: int = 129, ny: int = 65, ranks: int = 4,
         lbfgs_steps: int = 200, backend: str = "gloo",
         device: str = "cuda"):
    """Solve with ``ranks`` processes; returns rank 0's (losses, single,
    sharded) after checking every rank's history is bit-equal to rank 0's
    and the sharded energy at the solution is within rtol 1e-4 of the
    single-rank energy."""
    import numpy as np

    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=run_rank,
                         args=(r, ranks, port, nx, ny, lbfgs_steps, backend,
                               device, queue)) for r in range(ranks)]
    for p in procs:
        p.start()
    results = [queue.get(timeout=1800) for _ in procs]   # drain, then join
    for p in procs:
        p.join(timeout=120)
    failed = [r for r in results if "error" in r]
    codes = [p.exitcode for p in procs]
    if failed or any(codes):
        raise RuntimeError(f"ranks failed: {failed or codes}")
    results.sort(key=lambda r: r["rank"])
    r0 = results[0]
    for r in results[1:]:
        if not np.array_equal(r["losses"], r0["losses"]):
            raise AssertionError(f"rank {r['rank']}'s history differs")
    k, b, br = r0["blocks"]
    print(f"Nodes: {r0['sizes'][0]}  elements: {r0['sizes'][1]}")
    print(f"{ranks} ranks ({backend}) on {[r['device'] for r in results]}")
    print(f"banded blocks (k={k}): fwd {b}, bwd {br} ({ranks} ranks x "
          "contiguous slices)")
    losses = r0["losses"]
    print(f"energy: first {losses[0]:.4e}  last {losses[-1]:.6e}  "
          f"({1e3 * r0['seconds'] / lbfgs_steps:.3f} ms/step)")
    print(f"single-rank energy {r0['single']:.6e}  sharded "
          f"{r0['sharded']:.6e}")
    if not np.isclose(r0["single"], r0["sharded"], rtol=1e-4):
        raise AssertionError("sharded energy off the single-rank energy")
    return losses, r0["single"], r0["sharded"]


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--backend", choices=("gloo", "nccl"), default="gloo")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--nx", type=int, default=129)
    ap.add_argument("--ny", type=int, default=65)
    a = ap.parse_args()
    main(a.nx, a.ny, a.ranks, a.steps, a.backend, a.device)
