"""The lattice-route energy over row blocks, one a rank (port of
``hidenn_fem_tpu/parallel/sharded_lattice.py``), in plain torch.

The JAX package row-shards the [nx, ny, 4] node lattice under GSPMD and
lets XLA insert the halo exchange of the stencil's shifted slices.  Here
each rank holds the whole (replicated) lattice and evaluates the quad rows
of its own block from the block's node rows and the one node row below it
(the halo), with the route's masks cut to the same quad rows; the partial
energies are summed over the ranks and the node gradients summed by the
replicated input's backward (``parallel/sharding.py``).  Lattice, hybrid
(the collar evaluated on every rank alike, outside the sum) and body-force
meshes are covered; the traction work reads the whole lattice's faces on
every rank alike.  The JAX package runs XLA here, so this stays plain
torch: no kernel.
"""

from __future__ import annotations

import dataclasses

from ..ops import quadrature as quad
from ..ops.lattice_energy import (_domain_from_lat, _edge_work, _lat,
                                  body_work_from_lat, collar_energy)
from .sharded_slab import row_window
from .sharding import ELEM_AXIS, DeviceMesh, replicated, sum_over_ranks

__all__ = ["sharded_lattice_energy"]


def _quad_rows(route, q0: int, q1: int):
    """The route of quad rows [q0, q1) (node rows [q0, q1]): masks cut to
    those rows, no faces."""
    return dataclasses.replace(route, sel=route.sel[q0:q1],
                               t1=route.t1[q0:q1], t2=route.t2[q0:q1],
                               edge_masks={}, nx=q1 - q0 + 1)


def sharded_lattice_energy(energy, dmesh: DeviceMesh, axis: str = ELEM_AXIS):
    """``loss_fn(params, tri)`` == ``energy.total`` with the lattice's quad
    rows split over the ranks (module doc).

    ``tri.lattice`` must be present, or ``tri.hybrid`` (whose lattice part
    is split the same way).  The energy must be lattice-routable: fused
    assembly, exact compat, the default traction (a body force rides the
    row blocks)."""

    def loss_fn(params, tri):
        route = tri.lattice
        hy = tri.hybrid
        if route is None and hy is not None:
            route = hy.lattice
        if route is None:
            raise ValueError("mesh has no lattice route (gmsh-style "
                             "meshes: use shard_map_banded_energy)")
        if (energy.assembly != "fused" or energy.compat != "exact"
                or energy.traction is not None):
            raise ValueError("energy configuration is not "
                             "lattice-routable (see docstring)")
        node = energy.model.packed_nodes(params, tri)
        t_x = energy.F_total / energy.traction_length
        work = _edge_work(_lat(node, route), route, float(t_x))
        q0, q1 = row_window(route.nx - 1, dmesh.rank, dmesh.size)
        lat = _lat(replicated(node, dmesh), route)[q0:q1 + 1]
        rows = _quad_rows(route, q0, q1)
        w_sum = quad.triangle_weight_sum(energy.gauss_order)
        part = _domain_from_lat(lat, rows, float(energy.E),
                                float(energy.nu), w_sum)
        pts = w = None
        if energy.body_force is not None:
            pts, w = energy._domain_rule(node.device)
            part = part - body_work_from_lat(lat, rows, energy.body_force,
                                             pts, w)
        e = sum_over_ranks(part, dmesh) - work
        if hy is not None and tri.lattice is None and \
                hy.extra_conn.shape[0]:
            e = e + collar_energy(node, hy, float(energy.E),
                                  float(energy.nu), w_sum,
                                  body_force=energy.body_force, pts=pts,
                                  w=w)
        return e

    return loss_fn
