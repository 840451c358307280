"""Gather assembly with a deterministic backward (port of
``hidenn_fem_tpu/ops/assembly.py``).

The reverse of a connectivity gather is a scatter-add of per-corner
cotangents into nodes.  On the card a scatter-add with duplicate indices
runs on atomics, whose order (and so whose f32 rounding) changes from run
to run.  ``gather_with_incidence`` instead gathers the cotangents back
through a node -> corner incidence table (``mesh.types``):

    grad_node[n] = sum_k ct_flat[incidence[n, k]]

Slots of -1 read a zero row appended to the cotangent, so padding needs
no masks and nodes referenced by no element get exactly zero.
"""

from __future__ import annotations

import torch

__all__ = ["flat_gather", "gather_with_incidence", "incidence_gather_sum",
           "weighted_incidence_gather_sum"]


def flat_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx] for an index array of any shape: [*idx.shape, F]."""
    out = table.index_select(0, idx.reshape(-1).long())
    return out.reshape(*idx.shape, table.shape[-1])


def _pad_zero_row(table: torch.Tensor) -> torch.Tensor:
    return torch.cat([table, table.new_zeros((1, table.shape[-1]))], dim=0)


def _slot_index(inc: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Incidence slots with -1 pointed at the appended zero row."""
    inc = inc.long()
    return torch.where(inc < 0, n_rows, inc)


def incidence_gather_sum(table: torch.Tensor,
                         inc: torch.Tensor) -> torch.Tensor:
    """sum_k table[inc[:, k]] for a table whose last row is the zero row
    (slots of -1 read it).  The sum runs over the degree axis in slot
    order, so the result does not change from run to run."""
    idx = _slot_index(inc, table.shape[0] - 1)
    return flat_gather(table, idx).sum(dim=1)


def weighted_incidence_gather_sum(table: torch.Tensor, inc: torch.Tensor,
                                  w: torch.Tensor) -> torch.Tensor:
    """sum_k w[:, k, None] * table[inc[:, k]] (same -1 convention)."""
    idx = _slot_index(inc, table.shape[0] - 1)
    return (w[..., None] * flat_gather(table, idx)).sum(dim=1)


def assemble_node_grad(ct: torch.Tensor, conn: torch.Tensor, incidence,
                       n_nodes: int) -> torch.Tensor:
    """Node gradient [N, F] from per-corner cotangents ct [Ne, 3, F]:
    through the incidence table when there is one, else by scatter-add."""
    f = ct.shape[-1]
    ct_flat = ct.reshape(-1, f)
    if incidence is not None:
        return incidence_gather_sum(_pad_zero_row(ct_flat), incidence)
    out = ct.new_zeros((n_nodes, f))
    return out.index_add_(0, conn.reshape(-1).long(), ct_flat)


class _GatherWithIncidence(torch.autograd.Function):
    @staticmethod
    def forward(ctx, node, conn, incidence):
        ctx.save_for_backward(conn, incidence)
        ctx.n_nodes = node.shape[0]
        return flat_gather(node, conn)

    @staticmethod
    def backward(ctx, ct):
        conn, incidence = ctx.saved_tensors
        return (assemble_node_grad(ct, conn, incidence, ctx.n_nodes),
                None, None)


def gather_with_incidence(node: torch.Tensor, conn: torch.Tensor,
                          incidence: torch.Tensor) -> torch.Tensor:
    """node[conn] ([Ne, V, F]) whose backward is the incidence
    gather-sum instead of a scatter-add."""
    return _GatherWithIncidence.apply(node, conn, incidence)
