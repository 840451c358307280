"""Banded plane-stress energy, the large-mesh path (port of
``hidenn_fem_tpu/ops/banded_energy.py``).

The JAX package evaluated the energy of a mesh with banded tables
(``mesh/banded.py``) by scanning element blocks over node windows (the
forward, Pallas kernel K3), and took its gradient by scanning node blocks
over element windows that recompute their cotangents in-block (K5; or,
without recompute tables, over windows of the element scan's flat
cotangents), or, when the recompute tables carry ownership intervals,
computed the value and the gradient in that one node-block scan (K4).  On
the card the three are the CUDA kernels of
``hidenn_fem_tpu_torch/csrc/banded_energy.cu``.  K3 runs one thread per
table row, reading its node rows straight from the [N, 4] table.  K4 and
K5 run one thread per node for the gradient: each node walks its
incidence slots in slot order, decodes each slot to a table row and a
vertex (on the recompute windows, or on the two-pass windows), and adds
that vertex's corner cotangents recomputed from the row, in one launch
with no cotangent buffer; K4 adds the owned rows' energy in the same
launch.  The source's header says what bounds them and how a slot
decodes.  The TPU's lane-major [k*4, 2048] blocks, transposes and zero
padding are not reproduced.

In this module:

* ``banded_fwd`` (K3), ``banded_vg`` (K4), ``banded_bwd`` (K5): the kernel
  wrappers (CUDA float32 tensors only; each launch adds one to
  ``launch_counts``).  ``banded_vg`` and ``banded_bwd`` return node
  gradients: their kernels include the incidence sum over the windows.
  ``kernel_occupancy``: the registers and resident CTAs of K4 and K5.
* ``banded_vg_rows`` (K4), ``banded_bwd_rows`` (K5): the same kernels on
  one rank's contiguous slice of the recompute tables
  (``parallel/sharding.py``), the gradient rows placed at global row
  ``row_start`` of an [N, 4] table whose other rows are 0, as the TPU
  package's ``_recompute_vg``/``_recompute_bwd`` place them (each writes
  those zeros in its own launch).
* ``banded_fwd_plain``, ``banded_vg_plain``, ``banded_bwd_plain``: the
  same functions in plain torch, walking the same tables (window gather,
  the per-layout energy of ``element_energy_plain``'s algebra and the
  cotangents of ``element_cotangent_plain``, the ownership mask, the
  block-relative incidence sum), ``row_start`` included.
* ``banded_element_energy``: node table -> energy as an autograd Function,
  as the JAX package's custom_vjp does: with a gradient wanted and
  ownership intervals present, the forward runs K4 and keeps its gradient;
  otherwise the forward is K3 and the backward K5 (over the recompute
  windows, or, without recompute tables, the two-pass windows).  Tensors
  on the CPU run the plain versions.

Row layouts (``BandedAssembly.k``): 3 a triangle, 4 an edge pair
(triangles (0,1,2) and (0,1,3)), 6 a strip (triangle i is slots i..i+2).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from .assembly import flat_gather, window_incidence_sum
from .cuda_build import library, raise_on
from .element_energy import _abs_jax, _constants, _strain, \
    element_cotangent_plain

__all__ = ["banded_element_energy", "banded_fwd", "banded_vg", "banded_bwd",
           "banded_vg_rows", "banded_bwd_rows",
           "banded_fwd_plain", "banded_vg_plain", "banded_bwd_plain",
           "kernel_occupancy", "launch_counts", "reset_launch_counts"]

# the triangles (slot triples) of each row layout
_TRIS = {3: ((0, 1, 2),),
         4: ((0, 1, 2), (0, 1, 3)),
         6: ((0, 1, 2), (1, 2, 3), (2, 3, 4), (3, 4, 5))}

# launches of each kernel wrapper since the last reset
launch_counts = {"banded_fwd": 0, "banded_vg": 0, "banded_bwd": 0,
                 "banded_vg_rows": 0, "banded_bwd_rows": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


# ------------------------------------------------------------ plain torch
def _rows(node, starts, rel):
    """Gathered table rows [B*EB, k, 4]: node[starts[b] + rel[b, e, s]]."""
    idx = starts.long()[:, None, None] + rel.long()
    return flat_gather(node, idx.reshape(-1, rel.shape[-1]))


def _row_energies(g, E, nu, w_sum) -> torch.Tensor:
    """Energy of each row [R] of gathered rows g [R, k, 4]."""
    total = None
    for tri in _TRIS[g.shape[1]]:
        s = _strain(g[:, list(tri)], E, nu)
        e = w_sum * _abs_jax(s["det"]) * s["dens"]
        total = e if total is None else total + e
    return total


def _row_cotangents(g, E, nu, w_sum) -> torch.Tensor:
    """d(row energy)/d(slot rows) [R, k, 4] by the hand-derived triangle
    cotangents, summed over the row's triangles."""
    cot = torch.zeros_like(g)
    one = g.new_ones(())
    for tri in _TRIS[g.shape[1]]:
        cot[:, list(tri)] += element_cotangent_plain(g[:, list(tri)], one, E,
                                                     nu, w_sum)
    return cot


def _placed_rows(n_rows: int, row_start: int, n_nodes: int) -> int:
    """How many of ``n_rows`` table rows placed at ``row_start`` land below
    ``n_nodes`` (the rest are table padding)."""
    return max(0, min(n_rows, n_nodes - row_start))


def _recompute_sum(cot, ba, n_nodes, row_start=0):
    """Node gradients [n_nodes, 4] from the recompute windows' row
    cotangents cot [Br*EW, k, 4] through ``re_inc_rel`` (sentinel k*EW),
    the table's node rows placed at ``row_start``."""
    kew = ba.k * ba.re_ew
    base = torch.arange(ba.re_inc_rel.shape[0], device=cot.device) * kew
    rows = window_incidence_sum(cot.reshape(-1, cot.shape[-1]),
                                ba.re_inc_rel, base, kew,
                                ba.re_inc_rel.shape[0]
                                * ba.re_inc_rel.shape[1])
    if row_start == 0 and rows.shape[0] >= n_nodes:
        return rows[:n_nodes]
    take = _placed_rows(rows.shape[0], row_start, n_nodes)
    out = rows.new_zeros((n_nodes, rows.shape[-1]))
    out[row_start:row_start + take] = rows[:take]
    return out


def banded_fwd_plain(node, ba, E, nu, w_sum) -> torch.Tensor:
    """The function K3 computes, in plain torch (differentiable): the
    energy of the forward tables' rows."""
    return torch.sum(_row_energies(_rows(node, ba.starts, ba.conn_rel),
                                   E, nu, w_sum))


def banded_vg_plain(node, ba, E, nu, w_sum, row_start: int = 0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The function K4 computes, in plain torch: (energy of the owned rows
    of the recompute windows, node gradient [N, 4] with the tables' node
    rows placed at ``row_start``)."""
    with torch.no_grad():
        g = _rows(node.detach(), ba.re_nstarts, ba.re_conn_rel)
        e = _row_energies(g, E, nu, w_sum).reshape(-1, ba.re_ew)
        col = torch.arange(ba.re_ew, device=node.device)[None, :]
        owned = (col >= ba.re_own_lo[:, None]) & (col < ba.re_own_hi[:, None])
        energy = torch.sum(torch.where(owned, e, torch.zeros_like(e)))
        grad = _recompute_sum(_row_cotangents(g, E, nu, w_sum), ba,
                              node.shape[0], row_start)
        return energy, grad


def banded_bwd_plain(node, ba, ct, E, nu, w_sum,
                     row_start: int = 0) -> torch.Tensor:
    """The function K5 computes, in plain torch: ``ct`` times the node
    gradient [N, 4], from the recompute windows when the tables have them
    (their node rows placed at ``row_start``), else from the forward
    tables' cotangents through the two-pass windows (``ct_starts``,
    ``inc_rel``, sentinel ``wct``)."""
    with torch.no_grad():
        node = node.detach()
        n = node.shape[0]
        if ba.re_conn_rel is not None:
            g = _rows(node, ba.re_nstarts, ba.re_conn_rel)
            grad = _recompute_sum(_row_cotangents(g, E, nu, w_sum), ba, n,
                                  row_start)
        else:
            if row_start:
                raise ValueError("row_start needs the recompute tables")
            cot = _row_cotangents(_rows(node, ba.starts, ba.conn_rel), E, nu,
                                  w_sum)
            grad = window_incidence_sum(cot.reshape(-1, 4), ba.inc_rel,
                                        ba.ct_starts, ba.wct, n)
        return grad * ct


# ----------------------------------------------------------- CUDA kernels
@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = library("banded_energy")
    vp, ll, fl, i = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float,
                     ctypes.c_int)
    mat = [fl, fl, fl, fl]
    lib.hdnn_banded_threads_per_block.argtypes = []
    lib.hdnn_banded_threads_per_block.restype = i
    lib.hdnn_banded_fwd.argtypes = [i, vp, vp, vp, ll, ll, i] + mat + [
        vp, i, vp, vp]
    lib.hdnn_banded_fwd.restype = i
    lib.hdnn_banded_vg.argtypes = [i, vp, vp, vp, vp, vp, ll, ll, i] + mat + [
        i, vp, vp, ll, i, ll, ll, ll, vp, vp]
    lib.hdnn_banded_vg.restype = i
    lib.hdnn_banded_bwd.argtypes = [i, vp, vp, vp, ll, i] + mat + [
        vp, ll, i, vp, i, ll, ll, ll, vp, vp, vp]
    lib.hdnn_banded_bwd.restype = i
    pi = ctypes.POINTER(ctypes.c_int)
    lib.hdnn_banded_occupancy.argtypes = [i, i, i, pi, pi]
    lib.hdnn_banded_occupancy.restype = i
    return lib


def _check(node: torch.Tensor, ba, rel, *tables) -> None:
    if not node.is_cuda:
        raise ValueError("the banded kernels take CUDA tensors")
    if node.dtype != torch.float32 or node.dim() != 2 \
            or node.shape[1] != 4 or not node.is_contiguous():
        raise ValueError("node must be a contiguous float32 [N, 4] table, "
                         f"got {node.dtype} {tuple(node.shape)}")
    if node.data_ptr() % 16:
        raise ValueError("node rows must be 16-byte aligned (float4)")
    if ba.k not in _TRIS:
        raise ValueError(f"no banded kernel for k={ba.k}")
    for t in (rel,) + tables:
        if t is None or t.device != node.device or t.dtype != torch.int32 \
                or not t.is_contiguous():
            raise ValueError("the banded tables must be contiguous int32 "
                             "tensors on the node table's device (move the "
                             "mesh with TriMesh.to)")
    if rel.data_ptr() % (16 if ba.k == 4 else 8):
        raise ValueError("the row table must be aligned for its vector "
                         "loads (16 B for k=4, 8 B otherwise)")


def _head(node, ba, starts, rel, E, nu, w_sum):
    f, shear = _constants(E, nu)
    return (node.device.index, node.data_ptr(), starts.data_ptr(),
            rel.data_ptr(), rel.shape[1], rel.shape[0] * rel.shape[1], ba.k,
            f, float(nu), shear, float(w_sum))


def banded_fwd(node, ba, E, nu, w_sum) -> torch.Tensor:
    """K3 on the card: the energy (0-dim float32 tensor) of the forward
    tables ``ba.starts``/``ba.conn_rel`` over the node table."""
    _check(node, ba, ba.conn_rel, ba.starts)
    lib = _library()
    n_rows = ba.conn_rel.shape[0] * ba.conn_rel.shape[1]
    n_part = -(-n_rows // lib.hdnn_banded_threads_per_block())
    partials = torch.empty(n_part, dtype=torch.float32, device=node.device)
    out = torch.empty((), dtype=torch.float32, device=node.device)
    stream = torch.cuda.current_stream(node.device).cuda_stream
    err = lib.hdnn_banded_fwd(
        *_head(node, ba, ba.starts, ba.conn_rel, E, nu, w_sum),
        partials.data_ptr(), n_part, out.data_ptr(), stream)
    raise_on(lib, err, "banded_fwd")
    launch_counts["banded_fwd"] += 1
    return out


def _output(node, grad):
    """The [N, 4] output a launch writes whole: ``grad``, checked, or a new
    tensor like ``node``."""
    if grad is None:
        return torch.empty_like(node)
    if grad.shape != node.shape or grad.dtype != node.dtype \
            or grad.device != node.device or not grad.is_contiguous():
        raise ValueError("grad must be a contiguous tensor like node")
    return grad


def _vg_launch(name, node, ba, E, nu, w_sum, row_start, grad=None):
    """K4 in one launch, writing every row of ``grad`` (a new [N, 4]
    tensor when None), whatever it held: the tables' node rows at
    ``row_start``, 0 elsewhere."""
    _check(node, ba, ba.re_conn_rel, ba.re_nstarts, ba.re_own_lo,
           ba.re_own_hi, ba.re_inc_rel)
    lib = _library()
    rel = ba.re_conn_rel
    inc = ba.re_inc_rel
    n_rows = rel.shape[0] * rel.shape[1]
    n_nodes = _placed_rows(inc.shape[0] * inc.shape[1], row_start,
                           node.shape[0])
    # one thread per recompute row (its energy) and per node (its gradient)
    n_part = -(-max(n_rows, n_nodes) // lib.hdnn_banded_threads_per_block())
    dev = node.device
    out = torch.empty((), dtype=torch.float32, device=dev)
    grad = _output(node, grad)
    stream = torch.cuda.current_stream(dev).cuda_stream
    head = _head(node, ba, ba.re_nstarts, rel, E, nu, w_sum)
    err = lib.hdnn_banded_vg(
        *head[:4], ba.re_own_lo.data_ptr(), ba.re_own_hi.data_ptr(),
        *head[4:], n_part, out.data_ptr(), inc.data_ptr(), inc.shape[1],
        inc.shape[2], n_nodes, row_start, node.shape[0], grad.data_ptr(),
        stream)
    raise_on(lib, err, name)
    launch_counts[name] += 1
    return out, grad


def banded_vg(node, ba, E, nu, w_sum) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4 on the card: (energy of the owned rows of the recompute windows,
    node gradient [N, 4]) in one launch, the energy summed by its last
    block, with no cotangent buffer.  Needs the recompute tables with
    ownership."""
    return _vg_launch("banded_vg", node, ba, E, nu, w_sum, 0)


def banded_vg_rows(node, ba, E, nu, w_sum, row_start: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4 on the card over one rank's slice of the recompute tables:
    (energy of the slice's owned rows, node gradient [N, 4] with the
    slice's node rows placed at ``row_start``, every other row 0), in one
    launch that writes the zeros too, also for a slice that places no row.
    The placed rows equal the unsharded K4's bit for bit."""
    return _vg_launch("banded_vg_rows", node, ba, E, nu, w_sum,
                      int(row_start))


def banded_bwd(node, ba, ct, E, nu, w_sum) -> torch.Tensor:
    """K5 on the card: ``ct`` (a one-element float32 tensor on the card)
    times the node gradient [N, 4], in one launch with no cotangent
    buffer, over the recompute windows when the tables have them, else
    over the two-pass windows."""
    return _bwd_launch("banded_bwd", node, ba, ct, E, nu, w_sum, 0)


def banded_bwd_rows(node, ba, ct, E, nu, w_sum, row_start: int
                    ) -> torch.Tensor:
    """K5 on the card over one rank's slice of the recompute tables:
    ``ct`` times the node gradient [N, 4] with the slice's node rows
    placed at ``row_start``, every other row 0 (bit-equal to the
    unsharded K5's rows), in one launch that writes the zeros too, also
    for a slice that places no row."""
    if ba.re_conn_rel is None:
        raise ValueError("banded_bwd_rows needs the recompute tables")
    return _bwd_launch("banded_bwd_rows", node, ba, ct, E, nu, w_sum,
                       int(row_start))


def _bwd_launch(name, node, ba, ct, E, nu, w_sum, row_start, grad=None):
    """K5 in one launch, writing every row of ``grad`` (a new [N, 4] tensor
    when None), whatever it held: ``ct`` times the tables' node rows at
    ``row_start``, 0 elsewhere."""
    if ba.re_conn_rel is not None:
        starts, rel, inc = ba.re_nstarts, ba.re_conn_rel, ba.re_inc_rel
        ct_starts, sentinel = None, ba.k * ba.re_ew
    else:
        starts, rel, inc = ba.starts, ba.conn_rel, ba.inc_rel
        ct_starts, sentinel = ba.ct_starts, ba.wct
    _check(node, ba, rel, starts, inc,
           *(() if ct_starts is None else (ct_starts,)))
    ct = ct.reshape(()).to(dtype=torch.float32).contiguous()
    if ct.device != node.device:
        raise ValueError("ct must lie on the node table's device")
    lib = _library()
    dev = node.device
    n_nodes = _placed_rows(inc.shape[0] * inc.shape[1], row_start,
                           node.shape[0])
    grad = _output(node, grad)
    stream = torch.cuda.current_stream(dev).cuda_stream
    head = _head(node, ba, starts, rel, E, nu, w_sum)
    err = lib.hdnn_banded_bwd(
        *head[:5], *head[6:], inc.data_ptr(), inc.shape[1], inc.shape[2],
        None if ct_starts is None else ct_starts.data_ptr(), sentinel,
        n_nodes, row_start, node.shape[0], ct.data_ptr(), grad.data_ptr(),
        stream)
    raise_on(lib, err, name)
    launch_counts[name] += 1
    return grad


def kernel_occupancy(which: str, k: int,
                     device: torch.device) -> Tuple[int, int]:
    """(registers per thread, resident CTAs per SM) of K4 (``"vg"``), K5
    over the recompute windows (``"grad"``) or over the two-pass windows
    (``"grad_two_pass"``) for rows of ``k`` slots, on the CUDA
    ``device``."""
    lib = _library()
    regs, ctas = ctypes.c_int(), ctypes.c_int()
    index = device.index
    err = lib.hdnn_banded_occupancy(
        torch.cuda.current_device() if index is None else index,
        ("vg", "grad", "grad_two_pass").index(which), k, ctypes.byref(regs),
        ctypes.byref(ctas))
    raise_on(lib, err, "banded_occupancy")
    return regs.value, ctas.value


# ------------------------------------------------------- autograd wrapper
def _single_pass(ba) -> bool:
    return ba.re_conn_rel is not None and ba.re_own_lo is not None


class _BandedEnergy(torch.autograd.Function):
    """Energy of the node table over the banded tables ``ba``.  With
    ``want_grad`` and ownership intervals the forward runs K4 and keeps
    its gradient; otherwise it runs K3 and the backward K5.  With a
    ``row_start`` (one rank's slice of the tables) the gradient rows are
    placed there (K4 and K5's row variants).  Tensors on the CPU run the
    plain versions."""

    @staticmethod
    def forward(ctx, node, want_grad, ba, E, nu, w_sum, row_start):
        ctx.ba, ctx.args, ctx.row_start = ba, (E, nu, w_sum), row_start
        if want_grad and _single_pass(ba):
            if not node.is_cuda:
                e, g = banded_vg_plain(node, ba, E, nu, w_sum, row_start or 0)
            elif row_start is None:
                e, g = banded_vg(node, ba, E, nu, w_sum)
            else:
                e, g = banded_vg_rows(node, ba, E, nu, w_sum, row_start)
            ctx.single_pass = True
            ctx.save_for_backward(g)
            return e
        ctx.single_pass = False
        ctx.save_for_backward(node)
        return (banded_fwd(node, ba, E, nu, w_sum) if node.is_cuda
                else banded_fwd_plain(node, ba, E, nu, w_sum))

    @staticmethod
    def backward(ctx, ct):
        (saved,) = ctx.saved_tensors
        row_start = ctx.row_start
        if ctx.single_pass:
            grad = ct * saved
        elif not saved.is_cuda:
            grad = banded_bwd_plain(saved, ctx.ba, ct, *ctx.args,
                                    row_start or 0)
        elif row_start is None:
            grad = banded_bwd(saved, ctx.ba, ct, *ctx.args)
        else:
            grad = banded_bwd_rows(saved, ctx.ba, ct, *ctx.args, row_start)
        return grad, None, None, None, None, None, None


def banded_element_energy(node: torch.Tensor, ba, E: float, nu: float,
                          w_sum: float, row_start=None) -> torch.Tensor:
    """Total elastic energy of the packed node table ``node`` [N, 4] over
    the banded tables ``ba`` (``mesh.banded_paired`` or ``mesh.banded``),
    differentiable in ``node``.

    When a gradient will be taken (grad mode on and ``node`` requiring
    grad) the forward is the single-pass K4, as ``jax.value_and_grad``
    picks the JAX package's; under ``torch.no_grad()`` it is K3.

    ``row_start``: ``ba`` is one rank's slice of the tables (the TPU
    package's ``_banded_energy_rows``); the energy is the slice's part and
    the gradient has the slice's node rows placed at global row
    ``row_start``, every other row 0."""
    want_grad = torch.is_grad_enabled() and node.requires_grad
    if node.is_cuda:
        node = node.contiguous()
    return _BandedEnergy.apply(node, want_grad, ba, float(E), float(nu),
                               float(w_sum),
                               None if row_start is None else int(row_start))
