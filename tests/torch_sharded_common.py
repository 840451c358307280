"""Spawned gloo groups for the port's sharded-energy tests
(``tests/test_torch_sharding.py``, ``tests/test_torch_sharded_slab.py``,
``tests/test_torch_cuda.py``).  Imports neither JAX package.

A group is WORLD processes of ``tests/torch_sharded_worker.py`` (the port
only, no JAX), one a rank, joined over ``tcp://localhost`` on the CPU (or
all on one card, ``tests/test_torch_cuda.py``), the multi-process pattern
of ``tests/test_multihost.py``.  The test writes each
case's numpy mesh and params, starts its groups before computing the JAX
references (so the ranks run meanwhile), then reads every rank's results.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_sharded_worker.py")
TIMEOUT_S = 240


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def mesh_arrays(mesh, params) -> dict:
    """The six mesh arrays (``astuple`` order, by name) and the numpy params
    of one case."""
    names = ("coords", "connectivity", "geom_boundary_mask",
             "dirichlet_mask", "neumann_mask", "neumann_edges")
    out = {k: np.asarray(v) for k, v in zip(names, mesh.astuple())}
    out["p_coords"] = np.asarray(params["coords"], dtype=np.float64)
    out["p_u"] = np.asarray(params["u"], dtype=np.float64)
    return out


class Groups:
    """Groups of each size in ``worlds``, started at once on the cases
    ``[(case dict, arrays), ...]`` (see the worker for the case keys), every
    rank on ``device``."""

    def __init__(self, folder, cases, worlds, device="cpu"):
        self.runs = {}
        specs = [c for c, _ in cases]
        for world in worlds:
            sub = os.path.join(str(folder), f"world{world}")
            os.makedirs(sub)
            with open(os.path.join(sub, "spec.json"), "w") as f:
                json.dump(specs, f)
            for case, arrays in cases:
                np.savez(os.path.join(sub, case["name"] + ".npz"), **arrays)
            port = free_port()
            env = dict(os.environ, OMP_NUM_THREADS="1")
            procs = [subprocess.Popen(
                [sys.executable, WORKER, str(r), str(world), str(port), sub,
                 device],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                env=env) for r in range(world)]
            self.runs[world] = (sub, procs)
        self.results = {}

    def ranks(self, world):
        """Every rank's results (a dict each), after the group ended;
        raises with a rank's stderr if it failed."""
        if world not in self.results:
            sub, procs = self.runs[world]
            errs = []
            for r, p in enumerate(procs):
                try:
                    _, err = p.communicate(timeout=TIMEOUT_S)
                except subprocess.TimeoutExpired:
                    for q in procs:
                        q.kill()
                    raise AssertionError(f"rank {r} of {world} timed out")
                if p.returncode != 0:
                    errs.append(f"rank {r} of {world}: rc {p.returncode}\n"
                                f"{err[-3000:]}")
            if errs:
                raise AssertionError("\n".join(errs))
            self.results[world] = [
                dict(np.load(os.path.join(sub, f"rank{r}.npz")))
                for r in range(world)]
        return self.results[world]

    def case(self, world, name):
        """{field: value} of case ``name`` on each rank, after holding
        every rank's values bit-equal to rank 0's."""
        ranks = self.ranks(world)
        fields = {k.split("__", 1)[1] for k in ranks[0]
                  if k.startswith(name + "__")}
        for r in ranks[1:]:
            for f in fields:
                np.testing.assert_array_equal(
                    r[f"{name}__{f}"], ranks[0][f"{name}__{f}"],
                    err_msg=f"{name}: {f} differs across ranks")
        return {f: ranks[0][f"{name}__{f}"] for f in fields}

    def close(self):
        for _, procs in self.runs.values():
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
