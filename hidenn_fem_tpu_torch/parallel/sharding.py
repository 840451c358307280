"""Element-sharded energies over a ``torch.distributed`` group (port of
``hidenn_fem_tpu/parallel/sharding.py``).

The JAX package shards the element axis over a device mesh: the element
tables (``connectivity``, ``neumann_edges``, the banded tables' block
axes) are cut in contiguous blocks, one a device, and the nodal arrays are
replicated; each device computes the energy of its block and a ``psum``
adds the scalars, while ``shard_map``'s transpose of the replicated input
adds the devices' zero-placed node gradients.  Here a device is a rank of
the default process group (``multihost.initialize_multihost``), each rank
holds the whole (padded) mesh and takes its own block, and two autograd
Functions carry the collectives with the same semantics:

* ``sum_over_ranks``: forward ``all_reduce(SUM)`` of a rank's partial
  energy, backward the identity;
* ``replicated``: forward the identity, backward ``all_reduce(SUM)`` of
  the rank's gradient of a replicated input (the node table, or the flat
  params).

Only ``all_reduce`` and ``broadcast`` are used, so a gloo group can run
its ranks on CUDA tensors, several ranks on one card.  Every collective of
the port goes through ``all_reduce`` and ``broadcast`` here, which count
the calls this process issues by kind (``collective_counts``; the census
of ``sharded_mg.count_collectives`` is held to them).  Every rank runs the
same loss on identical parameters and receives the same reduced values,
so an optimizer run on each rank (``run_lbfgs``, unchanged) stays
identical across ranks.  Without an initialized group the functions run
as a group of one rank.

Padding: ``pad_mesh`` appends degenerate elements (all three nodes = node
0) and edges (both nodes = node 0); they contribute exactly zero to the
energy and to every gradient (the det guard of the element energy, and
ds = 0), as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..mesh.banded import (WINDOW_LIMIT, BandedAssembly,
                           build_banded_assembly, build_paired_assembly)
from ..mesh.types import TriMesh, build_incidence_table
from ..ops import quadrature as quad
from ..ops.banded_energy import banded_element_energy
from ..solve.optimizers import ravel_params, unravel_params

__all__ = ["ELEM_AXIS", "DeviceMesh", "device_mesh", "pad_mesh",
           "shard_mesh", "replicate", "shard_map_energy",
           "reband_for_shards", "shard_map_banded_energy", "rank_tables",
           "sum_over_ranks", "replicated", "all_reduce", "broadcast",
           "collective_counts", "reset_collective_counts"]

ELEM_AXIS = "elem"


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    """The ranks of a process group along one axis, seen from one rank.

    ``group`` is the process group (None: the default group, or no group
    at all when ``size`` is 1 and none is initialized), ``device`` the
    card this rank computes on."""

    group: Optional[object]
    rank: int
    size: int
    device: torch.device
    axis: str = ELEM_AXIS


def device_mesh(n_devices: Optional[int] = None, axis: str = ELEM_AXIS,
                device=None) -> DeviceMesh:
    """The 1D mesh of the initialized default group's ranks along the
    element axis, as this rank sees it.  ``device`` defaults to the card
    ``cuda:{local rank % device count}`` (``LOCAL_RANK``, else the rank):
    there is no CPU fallback; CPU runs name ``device="cpu"``.  Without an
    initialized group the mesh is this process alone."""
    if dist.is_initialized():
        rank, size = dist.get_rank(), dist.get_world_size()
    else:
        rank, size = 0, 1
    if n_devices is not None and n_devices != size:
        raise ValueError(f"the process group has {size} ranks, not "
                         f"{n_devices}: a rank is a device here")
    if device is None:
        local = int(os.environ.get("LOCAL_RANK", rank))
        device = torch.device("cuda",
                              local % max(torch.cuda.device_count(), 1))
    return DeviceMesh(group=None, rank=rank, size=size,
                      device=torch.device(device), axis=axis)


def _collective(dmesh: DeviceMesh) -> bool:
    return dmesh.size > 1 or dist.is_initialized()


# collectives this process issued since the last reset, by kind
collective_counts = {"all_reduce": 0, "broadcast": 0}


def reset_collective_counts() -> None:
    for k in collective_counts:
        collective_counts[k] = 0


def all_reduce(t: torch.Tensor, dmesh: DeviceMesh) -> torch.Tensor:
    """In-place ``all_reduce(SUM)`` of ``t`` over the mesh's ranks (none
    for a lone process), counted in ``collective_counts``."""
    if _collective(dmesh):
        dist.all_reduce(t, group=dmesh.group)
        collective_counts["all_reduce"] += 1
    return t


def broadcast(t: torch.Tensor, dmesh: DeviceMesh, src: int = 0
              ) -> torch.Tensor:
    """In-place ``broadcast`` of rank ``src``'s ``t``, counted."""
    if _collective(dmesh):
        dist.broadcast(t, src=src, group=dmesh.group)
        collective_counts["broadcast"] += 1
    return t


class _SumOverRanks(torch.autograd.Function):
    """all_reduce(SUM) forward (every rank gets the total), identity
    backward: the JAX package's ``psum`` of a partial energy."""

    @staticmethod
    def forward(ctx, x, dmesh):
        return all_reduce(x.detach().clone(), dmesh)

    @staticmethod
    def backward(ctx, ct):
        return ct, None


class _Replicated(torch.autograd.Function):
    """Identity forward, all_reduce(SUM) of the gradient backward: the
    transpose of a replicated input under ``shard_map``."""

    @staticmethod
    def forward(ctx, x, dmesh):
        ctx.dmesh = dmesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        return all_reduce(ct.detach().contiguous().clone(), ctx.dmesh), None


def sum_over_ranks(x: torch.Tensor, dmesh: DeviceMesh) -> torch.Tensor:
    """The sum of every rank's ``x`` (on every rank), differentiable."""
    return _SumOverRanks.apply(x, dmesh)


def replicated(x: torch.Tensor, dmesh: DeviceMesh) -> torch.Tensor:
    """``x``, an input every rank holds alike, whose gradient is summed
    over the ranks."""
    return _Replicated.apply(x, dmesh)


def _ceil_to(n: int, k: int) -> int:
    return -(-n // k) * k


def pad_mesh(tri: TriMesh, n_shards: int) -> TriMesh:
    """Pad the element and edge tables to multiples of ``n_shards`` with
    degenerate (zero-contribution) rows of node 0; the node arrays are
    untouched and the lattice route is dropped."""
    conn = tri.connectivity
    ne = tri.n_elements
    if _ceil_to(ne, n_shards) != ne:
        conn = torch.cat([conn, conn.new_zeros(
            (_ceil_to(ne, n_shards) - ne, 3))])
    edges = tri.neumann_edges
    nedg = tri.n_neumann_edges
    if nedg and _ceil_to(nedg, n_shards) != nedg:
        edges = torch.cat([edges, edges.new_zeros(
            (_ceil_to(nedg, n_shards) - nedg, 2))])
    return dataclasses.replace(tri, connectivity=conn, neumann_edges=edges,
                               lattice=None)


def _strip(tri: TriMesh) -> TriMesh:
    """The mesh without its derived single-device tables: the sharded
    paths own their distribution, and the scatter-add backward their
    gradient reduction."""
    return dataclasses.replace(tri, incidence=None, banded=None,
                               banded_paired=None, fused_connectivity=None,
                               fused_incidence=None, lattice=None,
                               hybrid=None)


def shard_mesh(tri: TriMesh, dmesh: DeviceMesh,
               axis: str = ELEM_AXIS) -> TriMesh:
    """Pad the mesh to the rank count, strip its derived tables, and put
    it on this rank's device.  Each rank keeps the whole padded mesh and
    ``shard_map_energy`` takes the rank's element block from it (there
    are no global sharded tensors in torch)."""
    return _strip(pad_mesh(tri, dmesh.size)).to(dmesh.device)


def replicate(pytree, dmesh: DeviceMesh):
    """Rank 0's params (a dict of tensors, or a tensor) on every rank, on
    its device: a ``broadcast`` from rank 0."""
    def bcast(x):
        return broadcast(x.detach().to(dmesh.device).clone().contiguous(),
                         dmesh)

    if isinstance(pytree, torch.Tensor):
        return bcast(pytree)
    return {k: bcast(v) for k, v in pytree.items()}


def _block(t: torch.Tensor, dmesh: DeviceMesh) -> torch.Tensor:
    """This rank's contiguous block of the leading axis of ``t``, whose
    length the rank count must divide."""
    if t.shape[0] % dmesh.size:
        raise ValueError(f"{t.shape[0]} rows do not divide over "
                         f"{dmesh.size} ranks; pad with pad_mesh")
    b = t.shape[0] // dmesh.size
    return t[dmesh.rank * b:(dmesh.rank + 1) * b]


def shard_map_energy(energy, dmesh: DeviceMesh, axis: str = ELEM_AXIS):
    """``loss_fn(params, tri)``: each rank computes the domain and edge
    energy of its element block against the replicated nodal arrays (the
    gather route with ``incidence=None``: on the card K1 and K2 and the
    scatter-add node sum), and the partial energies are summed over the
    ranks.  ``tri`` must be padded (``pad_mesh`` or ``shard_mesh``)."""

    def loss_fn(params, tri):
        loc = dataclasses.replace(
            _strip(tri), connectivity=_block(tri.connectivity, dmesh),
            neumann_edges=(_block(tri.neumann_edges, dmesh)
                           if tri.n_neumann_edges else tri.neumann_edges))
        p = unravel_params(replicated(ravel_params(params), dmesh), params)
        part = energy.domain_energy(p, loc) - energy.edge_energy(p, loc)
        return sum_over_ranks(part, dmesh)

    return loss_fn


def reband_for_shards(tri: TriMesh, n_shards: int,
                      window_limit: Optional[int] = None,
                      pair: bool = True) -> TriMesh:
    """The mesh with its banded tables rebuilt so that every block count
    divides by ``n_shards`` (``block_multiple``), for
    ``shard_map_banded_energy``: the quad-paired tables unless ``pair`` is
    False or ``HDNN_NO_PAIR`` is set (then the triangle tables), as in the
    JAX package.  Raises when the mesh does not band so."""
    conn = tri.connectivity.cpu().numpy()
    wl = window_limit or WINDOW_LIMIT
    if pair and not os.environ.get("HDNN_NO_PAIR"):
        paired = build_paired_assembly(conn, tri.n_nodes, window_limit=wl,
                                       block_multiple=n_shards,
                                       device=tri.device)
        if paired is not None and paired.re_conn_rel is not None:
            return dataclasses.replace(tri, banded=None,
                                       banded_paired=paired)
    inc = (tri.incidence.cpu().numpy() if tri.incidence is not None
           else build_incidence_table(conn, tri.n_nodes))
    ba = build_banded_assembly(conn, tri.n_nodes, np.asarray(inc),
                               window_limit=wl, block_multiple=n_shards,
                               device=tri.device)
    if ba is None or ba.re_conn_rel is None:
        raise ValueError(
            f"mesh not bandable with block counts divisible by {n_shards} "
            "(try reorder_mesh or a larger window_limit)")
    return dataclasses.replace(tri, banded=ba, banded_paired=None)


def rank_tables(ba: BandedAssembly, rank: int, size: int):
    """(this rank's slice of the banded tables, its row_start): the
    contiguous blocks ``rank`` of the forward tables and of the recompute
    tables; the slice's node rows start at global row ``row_start``."""
    if ba.starts.shape[0] % size or ba.re_nstarts.shape[0] % size:
        raise ValueError("banded block counts not divisible by the "
                         "device count; rebuild with reband_for_shards")
    b = ba.starts.shape[0] // size
    br = ba.re_nstarts.shape[0] // size
    fwd = slice(rank * b, (rank + 1) * b)
    re = slice(rank * br, (rank + 1) * br)
    has_own = ba.re_own_lo is not None
    loc = BandedAssembly(
        starts=ba.starts[fwd], conn_rel=ba.conn_rel[fwd],
        ct_starts=None, inc_rel=None,
        re_nstarts=ba.re_nstarts[re], re_estarts=None,
        re_conn_rel=ba.re_conn_rel[re], re_inc_rel=ba.re_inc_rel[re],
        re_own_lo=ba.re_own_lo[re] if has_own else None,
        re_own_hi=ba.re_own_hi[re] if has_own else None,
        wnode=ba.wnode, wct=0, re_wnode=ba.re_wnode, re_ew=ba.re_ew,
        k=ba.k)
    return loc, rank * br * ba.re_inc_rel.shape[1]


def shard_map_banded_energy(energy, dmesh: DeviceMesh,
                            axis: str = ELEM_AXIS):
    """``loss_fn(params, tri)`` on the banded tables with their block axes
    sharded over the ranks: each rank walks its contiguous slice of the
    element blocks (forward) and of the recompute node blocks (gradient),
    with K4's and K5's row variants placing its gradient rows at its
    ``row_start`` (K4 with ownership intervals; K3, then K5 without).
    Gradients need no halo exchange: a node block recomputes its incident
    element window.  Requires tables built by ``reband_for_shards(tri,
    n_ranks)``."""

    def loss_fn(params, tri):
        # the single-device route's preference: the quad-paired tables
        ba = (tri.banded_paired if tri.banded_paired is not None
              else tri.banded)
        if ba is None or ba.re_conn_rel is None:
            raise ValueError("mesh has no recompute banded tables; "
                             "build with reband_for_shards")
        loc, row_start = rank_tables(ba, dmesh.rank, dmesh.size)
        node = energy.model.packed_nodes(params, tri)
        w_sum = quad.triangle_weight_sum(energy.gauss_order)
        part = banded_element_energy(replicated(node, dmesh), loc,
                                     energy.E, energy.nu, w_sum, row_start)
        return (sum_over_ranks(part, dmesh)
                - energy.edge_energy(params, tri))

    return loss_fn
