"""One rank of a gloo group running the port's sharded energies.

    python tests/torch_sharded_worker.py RANK WORLD PORT DIR [DEVICE]

Reads the cases of ``DIR/spec.json`` (meshes and params as numpy arrays in
``DIR/<case>.npz``, written by ``tests/torch_sharded_common.py``), runs
each through its sharded function (or, for an "aux" case, the sharded
auxiliary-space PCG solve; for an "mg" case, the sharded multigrid-PCG
solve of a structured grid) as rank RANK of WORLD ranks (gloo,
``tcp://localhost:PORT``) on DEVICE (default ``cpu``; ``cuda:0`` puts
every rank on the one card), and writes this rank's energies, gradients,
loss histories (aux and mg: solutions and residual histories; mg: the
``all_reduce`` calls of the solve as well), errors and kernel launch
counts to ``DIR/rank<RANK>.npz``.
Imports the port only (never JAX), as the ranks of a real run do.
"""

import json
import os
import sys
import traceback

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import hidenn_fem_tpu_torch as pt  # noqa: E402
from hidenn_fem_tpu_torch.ops import banded_energy  # noqa: E402
from hidenn_fem_tpu_torch.ops import element_energy  # noqa: E402
from hidenn_fem_tpu_torch.ops import lattice_slab  # noqa: E402
from hidenn_fem_tpu_torch.parallel import (  # noqa: E402
    aux_pcg_solve_sharded, device_mesh, initialize_multihost,
    mg_pcg_solve_sharded, pad_mesh, process_summary, reband_for_shards,
    shard_map_banded_energy, shard_map_energy, shard_map_lattice_slab,
    sharded_lattice_energy, sharding)

KERNELS = (banded_energy, element_energy, lattice_slab)
DTYPES = {"float32": torch.float32, "float64": torch.float64}
FUNCTIONS = {"energy": shard_map_energy, "banded": shard_map_banded_energy,
             "lattice": sharded_lattice_energy,
             "slab": shard_map_lattice_slab}


def body_force(x):
    """The body force of the body-force cases (the tests give JAX the
    same function)."""
    return torch.stack([torch.sin(x[:, 0]) * 1e4, x[:, 1] * 2e4], dim=1)


def build(case, arrays, world, dev):
    dtype = DTYPES[case["dtype"]]
    if "hybrid" in case:
        mesh = pt.generate_mesh_hybrid(device=dev, dtype=dtype,
                                       **case["hybrid"])
        np.testing.assert_array_equal(mesh.coords.cpu().numpy(),
                                      arrays["coords"].astype(
                                          mesh.coords.cpu().numpy().dtype))
    else:
        mesh = pt.TriMesh.from_arrays(
            arrays["coords"], arrays["connectivity"],
            arrays["geom_boundary_mask"], arrays["dirichlet_mask"],
            arrays["neumann_mask"], arrays["neumann_edges"], dtype=dtype,
            device=dev, build_banded=False,
            build_lattice=case["fn"] in ("lattice", "slab")
            or case.get("lattice", False))
    if case["fn"] == "energy":
        mesh = pad_mesh(mesh, world)
    elif case["fn"] == "banded":
        mesh = reband_for_shards(mesh, world,
                                 window_limit=case["window_limit"])
    params = {"coords": torch.tensor(arrays["p_coords"], dtype=dtype,
                                     device=dev),
              "u": torch.tensor(arrays["p_u"], dtype=dtype, device=dev)}
    energy = pt.PlaneStressEnergy(
        model=pt.TriangleP1(dtype=dtype), E=10e9, nu=0.3,
        body_force=body_force if case.get("body_force") else None)
    return mesh, params, energy


def run_mg(case, arrays, dmesh, out):
    """The sharded MG-PCG solve of the ``nx`` x ``ny`` plate
    (``generate_structured_grid`` with the case's ``split`` and ``holes``,
    default "up" and none; the tests build the JAX package's from the same
    arrays) from the case's u0."""
    name, dtype = case["name"], DTYPES[case["dtype"]]
    grid = pt.grid_from_numpy(pt.generate_structured_grid(
        length=2.0, height=1.0, nx=case["nx"], ny=case["ny"],
        split=case.get("split", "up"), holes=case.get("holes", ()),
        device="cpu"), device=dmesh.device, dtype=dtype)
    model = pt.StructuredGridP1(E=10e9, nu=0.3, dtype=dtype)
    params = {"coords": grid.coords,
              "u": torch.tensor(arrays["p_u"], dtype=dtype,
                                device=dmesh.device)}
    sharding.reset_collective_counts()
    sol, hist = mg_pcg_solve_sharded(model, grid, params, dmesh=dmesh,
                                     max_iters=case["max_iters"],
                                     tol=case["tol"], engine=case["engine"])
    out[f"{name}__all_reduce"] = np.asarray(
        sharding.collective_counts["all_reduce"])
    out[f"{name}__u"] = sol["u"].cpu().numpy()
    out[f"{name}__hist"] = hist.cpu().numpy()


def run_case(case, arrays, world, dmesh, out):
    name = case["name"]
    if case["fn"] == "mg":
        return run_mg(case, arrays, dmesh, out)
    mesh, params, energy = build(case, arrays, world, dmesh.device)
    if case["fn"] == "aux":
        sol, hist = aux_pcg_solve_sharded(energy, mesh, params, dmesh=dmesh,
                                          max_iters=case["max_iters"],
                                          tol=case["tol"])
        out[f"{name}__u"] = sol["u"].cpu().numpy()
        out[f"{name}__hist"] = hist.cpu().numpy()
        return
    loss_fn = FUNCTIONS[case["fn"]](energy, dmesh)
    p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    value = loss_fn(p, mesh)
    g_coords, g_u = torch.autograd.grad(value, [p["coords"], p["u"]])
    out[f"{name}__energy"] = value.detach().cpu().numpy()
    out[f"{name}__g_coords"] = g_coords.cpu().numpy()
    out[f"{name}__g_u"] = g_u.cpu().numpy()
    if case.get("steps"):
        _, losses = pt.run_lbfgs(loss_fn, params, num_steps=case["steps"],
                                 loss_args=(mesh,))
        out[f"{name}__losses"] = losses.cpu().numpy()


def main():
    rank, world, port, folder = (int(sys.argv[1]), int(sys.argv[2]),
                                 int(sys.argv[3]), sys.argv[4])
    device = sys.argv[5] if len(sys.argv) > 5 else "cpu"
    torch.set_num_threads(1)
    initialize_multihost(f"localhost:{port}", world, rank, backend="gloo")
    dmesh = device_mesh(device=device)
    with open(os.path.join(folder, "spec.json")) as f:
        cases = json.load(f)
    out = {"summary": np.asarray(json.dumps(process_summary()))}
    for m in KERNELS:
        m.reset_launch_counts()
    for case in cases:
        if world not in case.get("worlds", [world]):
            continue
        arrays = dict(np.load(os.path.join(folder, case["name"] + ".npz")))
        try:
            run_case(case, arrays, world, dmesh, out)
        except ValueError as e:        # the errors the JAX package raises
            out[f"{case['name']}__error"] = np.asarray(str(e))
            traceback.print_exc()
    launches = {}
    for m in KERNELS:
        launches.update(m.launch_counts)
    out["launches"] = np.asarray(json.dumps(launches))
    np.savez(os.path.join(folder, f"rank{rank}.npz"), **out)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
