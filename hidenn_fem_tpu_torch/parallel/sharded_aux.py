"""Auxiliary-space PCG with sharded matvecs (port of
``hidenn_fem_tpu/parallel/sharded_aux.py``).

The composition of the sharded energies (``parallel/sharding.py``,
``parallel/sharded_lattice.py``) with the single-device preconditioner
(``solve/auxspace.py``):

* the matvec, each iteration's O(Ne) part, is a sharded gradient: the
  banded route with every rank's slice of the element blocks and its rows
  placed at its ``row_start`` (K4 on the card), or the lattice route over
  row blocks for lattice and hybrid meshes; the partial energies and the
  node gradients are summed over the ranks (``all_reduce``);
* the preconditioner runs replicated.  The PCG vectors come out of the
  reduced matvec alike on every rank, so the Jacobi term, the transfers
  and the background V-cycle compute the same values on every rank with
  no communication.

Every rank then reads the same stop flag, computed from the same
scalars, after the same number of iterations (``solve/loop.py``: one NCCL
rank records the iteration in a CUDA graph, gloo ranks run it eagerly),
so no rank leaves the loop while another waits in a collective, and the
histories are equal across ranks.  The sharded matvec equals the
single-device one up to float reassociation, so iteration counts and
solutions follow the single-device ``aux_pcg_solve``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..models.structured_grid import StructuredGridP1
from ..solve.auxspace import _aux_pcg, build_aux_preconditioner
from .sharded_lattice import sharded_lattice_energy
from .sharding import (DeviceMesh, device_mesh, reband_for_shards,
                       shard_map_banded_energy)

__all__ = ["aux_pcg_solve_sharded"]


def _u_loss(loss):
    """The displacement-only adapter ``u_loss(pu, coords, tri)`` of a
    sharded ``loss(params, tri)``."""
    def u_loss(pu, coords, tri):
        return loss({"u": pu["u"], "coords": coords}, tri)
    return u_loss


def _sharded_u_loss(energy, dmesh: DeviceMesh):
    """The adapter over the element-sharded banded energy."""
    return _u_loss(shard_map_banded_energy(energy, dmesh))


def _sharded_lattice_u_loss(energy, dmesh: DeviceMesh):
    """The adapter over the row-sharded lattice energy: the matvec of
    lattice-topology and hybrid lattice+collar meshes."""
    return _u_loss(sharded_lattice_energy(energy, dmesh))


def aux_pcg_solve_sharded(energy, mesh, params,
                          dmesh: Optional[DeviceMesh] = None,
                          n_devices: Optional[int] = None,
                          bg_model: Optional[StructuredGridP1] = None,
                          bg_shape: Optional[Tuple[int, int]] = None,
                          pre=None, max_iters: int = 200,
                          tol: float = 1e-6
                          ) -> Tuple[dict, torch.Tensor]:
    """Auxiliary-space-preconditioned CG for the displacement problem,
    every matvec sharded over the ranks (module doc).  Run it on every
    rank of the group.

    Args:
      energy: a ``PlaneStressEnergy`` (the quadratic fine operator; its E
        and nu also default the background operator).
      mesh: the ``TriMesh``; a mesh without a lattice or hybrid route
        takes the banded route, its tables rebuilt with block counts
        divisible by the rank count when they are not
        (``reband_for_shards``).
      params: ``{"coords", "u"}``, coordinates frozen, ``u`` the start.
      dmesh / n_devices: the ranks (default: ``device_mesh(n_devices)``,
        the initialized group on the card).
      pre: a prebuilt ``build_aux_preconditioner`` product built against
        the same sharded loss and background model.

    Returns (solved params, per-iteration relative residual norms).
    """
    if dmesh is None:
        dmesh = device_mesh(n_devices)
    size = dmesh.size
    if mesh.lattice is not None or getattr(mesh, "hybrid", None) \
            is not None:
        # lattice and hybrid meshes: row blocks of the lattice route, no
        # banded tables needed
        u_loss = _sharded_lattice_u_loss(energy, dmesh)
    else:
        # gate on the table shard_map_banded_energy will select (paired
        # preferred), so a non-divisible paired table triggers a reband
        ba = (mesh.banded_paired if mesh.banded_paired is not None
              else mesh.banded)
        if (ba is None or ba.re_conn_rel is None
                or ba.starts.shape[0] % size
                or ba.re_nstarts.shape[0] % size):
            mesh = reband_for_shards(mesh, size)
        u_loss = _sharded_u_loss(energy, dmesh)
    coords0 = params["coords"]
    up = {"u": params["u"]}
    args = (coords0, mesh)

    if bg_model is None:
        bg_model = StructuredGridP1(E=energy.E, nu=energy.nu)
    if pre is None:
        pre = build_aux_preconditioner(u_loss, up, args, mesh,
                                       bg_model=bg_model, bg_shape=bg_shape)
    sol, hist = _aux_pcg(u_loss, pre.bg_model or bg_model, int(max_iters),
                         float(tol), "u", up, args, pre)
    return {"coords": coords0, "u": sol["u"]}, hist
