"""The lattice stencil kernels K6/K7 over row windows, one a rank (port of
``hidenn_fem_tpu/parallel/sharded_slab.py``).

Each rank holds the whole packed node table (replicated) and runs K6 over
its own window of node rows (K7 when no gradient is wanted): the energy of
the quads whose n00 row lies in the window, and the complete gradient of
the window's nodes (every quad touching them is recomputed from the
one-row halo, so no halo exchange is needed), placed in an [N, 4] table
whose other rows are 0 (on the card K6 writes them in the same launch).
The partial energies are summed
over the ranks and the placed gradients summed by the replicated input's
backward (``parallel/sharding.py``).  The traction edge term runs outside,
on every rank alike, as in the JAX package.  On the CPU the windows run
the kernels' plain versions.
"""

from __future__ import annotations

import torch

from ..ops import quadrature as quad
from ..ops.lattice_slab import (_edge_work_from_node,
                                lattice_stencil_fwd_rows,
                                lattice_stencil_fwd_rows_plain,
                                lattice_stencil_vg_rows,
                                lattice_stencil_vg_rows_plain, route_stencil,
                                slab_supported)
from .sharding import ELEM_AXIS, DeviceMesh, replicated, sum_over_ranks

__all__ = ["shard_map_lattice_slab", "row_window"]


def row_window(nx: int, rank: int, size: int):
    """The rows [lo, hi) of ``rank`` when ``size`` ranks split ``nx`` rows
    (node rows here, quad rows in ``sharded_lattice``): blocks of
    ceil(nx / size) rows; the last ranks' blocks may be short or empty."""
    per = -(-nx // size)
    lo = min(rank * per, nx)
    return lo, min(lo + per, nx)


class _WindowEnergy(torch.autograd.Function):
    """The energy of a row window's quads.  When a gradient is wanted the
    forward runs K6 over the window and keeps the placed gradient, else K7
    over the window (their plain versions on the CPU), as the single-rank
    route does.  An empty window gives 0 and a zero gradient."""

    @staticmethod
    def forward(ctx, node, want_grad, nx, ny, E, nu, w_sum, lo, hi, kw):
        args = (node, nx, ny, E, nu, w_sum, lo, hi)
        if lo < hi and not want_grad:
            ctx.save_for_backward(None)
            return (lattice_stencil_fwd_rows(*args, **kw) if node.is_cuda
                    else lattice_stencil_fwd_rows_plain(*args, **kw))
        if lo >= hi:
            e, g = node.new_zeros(()), torch.zeros_like(node)
        elif node.is_cuda:
            e, g = lattice_stencil_vg_rows(*args, **kw)
        else:
            e, g = lattice_stencil_vg_rows_plain(*args, **kw)
        ctx.save_for_backward(g)
        return e

    @staticmethod
    def backward(ctx, ct):
        (g,) = ctx.saved_tensors
        if g is None:
            raise RuntimeError("the window energy ran without its "
                               "gradient (want_grad=False)")
        return (ct * g,) + (None,) * 9


def shard_map_lattice_slab(energy, dmesh: DeviceMesh, axis: str = ELEM_AXIS):
    """``loss_fn(params, tri)`` == ``energy.total`` with the stencil
    kernel's node rows split over the ranks (module doc).

    Requires a lattice-routable energy (fused assembly, exact compat, no
    traction or body force) on an identity-numbered lattice mesh in
    float32, the set ``lattice_slab.slab_supported`` takes; raises as the
    JAX package does otherwise."""

    def loss_fn(params, tri):
        route = tri.lattice
        node = energy.model.packed_nodes(params, tri)
        if not slab_supported(route, node.dtype):
            raise ValueError("mesh/dtype outside the slab-kernel set "
                             "(identity lattice, f32); use "
                             "sharded_lattice_energy or "
                             "shard_map_banded_energy")
        if (energy.assembly != "fused" or energy.compat != "exact"
                or energy.traction is not None
                or energy.body_force is not None):
            raise ValueError("energy configuration is not "
                             "lattice-routable")
        nx, ny = route.nx, route.ny
        lo, hi = row_window(nx, dmesh.rank, dmesh.size)
        w_sum = quad.triangle_weight_sum(energy.gauss_order)
        node_r = replicated(node, dmesh).contiguous()
        want = torch.is_grad_enabled() and node_r.requires_grad
        part = _WindowEnergy.apply(node_r, want, nx, ny, float(energy.E),
                                   float(energy.nu), float(w_sum), lo, hi,
                                   route_stencil(route))
        t_x = energy.F_total / energy.traction_length
        return (sum_over_ranks(part, dmesh)
                - _edge_work_from_node(node, route, float(t_x)))

    return loss_fn
