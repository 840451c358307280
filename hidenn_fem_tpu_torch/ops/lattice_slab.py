"""Lattice stencil kernels K6/K7 (port of
``hidenn_fem_tpu/ops/lattice_slab.py``; the module keeps its name so that
a reader finds the counterpart).

The JAX package evaluated the lattice route's domain energy in one Pallas
pass per direction: K7 (``_pallas_fwd``) the energy, K6 (``_pallas_vg``)
the energy and the full node gradient, the gradient by ``jax.grad``
inside the kernel.  Its layouts were the TPU's: a channel-major
``[4, R, ceil128(ny)]`` slab that puts mesh columns on the 128 lanes,
8-row-aligned windows with halo rows, a ``bi = 128/64`` grid sized to
the scoped VMEM, and manual double-buffered DMA of the windows, plus the
roll-wrap masks that the padding needed.  The port reproduces none of
them: the CUDA kernels of ``hidenn_fem_tpu_torch/csrc/lattice_stencil.cu``
work on node tiles staged in shared memory, evaluate each quad of a tile
once, and write the gradient straight into node layout, with a gradient
derived by hand (the source's header says what bounds them on the H100
and how).

In this module:

* ``lattice_stencil_fwd`` / ``lattice_stencil_vg``: the kernel wrappers
  (CUDA float32 tensors only; each launch adds one to ``launch_counts``);
* ``lattice_stencil_fwd_plain`` / ``lattice_stencil_vg_plain``: their
  plain torch versions, the energy and the hand-derived node gradient;
* ``lattice_stencil_fwd_rows`` / ``lattice_stencil_vg_rows``: the same
  kernels over a window of node rows ``[row_lo, row_hi)`` (the TPU
  kernels' ``row0``, which ``parallel/sharded_slab.py`` gives each rank):
  the energy of the quads whose n00 row lies in the window and the
  gradient of the window's nodes, placed in an [nx*ny, 4] table whose
  other rows the same launch writes 0;
  ``lattice_stencil_{fwd,vg}_rows_plain`` their plain versions;
* ``lattice_total_slab``: domain - traction work of an identity-numbered
  float32 route, whose domain term is an autograd Function that runs K6
  when a gradient is wanted and K7 otherwise (their plain versions for a
  tensor on the CPU);
* ``structured_domain_slab``: ``StructuredGridP1``'s domain energy on the
  same kernels, the zigzag parity computed in the kernel;
* ``slab_supported``: which routes the kernels take (identity numbering,
  float32), as in the JAX package.

A diagonal is given as ``diag``: 0 every quad "up", 1 every quad "down",
2 per quad from a ``sel`` mask (> 0: up), 3 the zigzag parity (quad (i, j)
is up when i + j + ``phase`` is even).  ``t1``/``t2`` are the per-quad
presence weights of the two triangles, or None when all are present.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from .cuda_build import library, raise_on
from .element_energy import _constants, element_cotangent_plain
from .lattice_energy import _families, _tri_energy, face_work, lattice_face

__all__ = ["lattice_total_slab", "slab_supported", "structured_domain_slab",
           "lattice_stencil_fwd", "lattice_stencil_vg",
           "lattice_stencil_fwd_plain", "lattice_stencil_vg_plain",
           "lattice_stencil_fwd_rows", "lattice_stencil_vg_rows",
           "lattice_stencil_fwd_rows_plain", "lattice_stencil_vg_rows_plain",
           "route_stencil", "structured_stencil", "launch_counts",
           "reset_launch_counts",
           "UP", "DOWN", "SEL_MASK", "PARITY"]

UP, DOWN, SEL_MASK, PARITY = 0, 1, 2, 3
_UNIFORM = {UP: "up", DOWN: "down"}

# launches of each kernel wrapper since the last reset
launch_counts = {"lattice_stencil_vg": 0, "lattice_stencil_fwd": 0,
                 "lattice_stencil_vg_rows": 0, "lattice_stencil_fwd_rows": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def slab_supported(route, dtype) -> bool:
    """True when the stencil kernels cover this route: identity node
    numbering and float32."""
    return (route is not None and route.identity
            and dtype == torch.float32)


def route_stencil(route) -> dict:
    """The stencil arguments (diag, phase, sel, t1, t2) of a route."""
    diag = {"up": UP, "down": DOWN}.get(route.uniform_sel, SEL_MASK)
    return dict(diag=diag, phase=0,
                sel=route.sel if diag == SEL_MASK else None,
                t1=None if route.all_present else route.t1,
                t2=None if route.all_present else route.t2)


def structured_stencil(quad_mask, split: str, zigzag_phase: int,
                       dtype) -> dict:
    """The stencil arguments of a ``StructuredGridP1`` lattice: the split
    as the diagonal (zigzag: the parity), ``quad_mask`` as both presence
    weights."""
    qm = quad_mask.to(dtype).contiguous()
    return dict(diag={"up": UP, "down": DOWN, "zigzag": PARITY}[split],
                phase=zigzag_phase, t1=qm, t2=qm)


# ------------------------------------------------------------ plain torch
def _up_mask(diag, phase, sel, nx, ny, device) -> Optional[torch.Tensor]:
    """[nx-1, ny-1] bool "quad splits up", or None for a uniform split."""
    if diag == SEL_MASK:
        return sel > 0
    if diag == PARITY:
        ii = torch.arange(nx - 1, device=device)[:, None]
        jj = torch.arange(ny - 1, device=device)[None, :]
        return (ii + jj + phase) % 2 == 0
    return None


def lattice_stencil_fwd_plain(node, nx, ny, E, nu, w_sum, diag=UP,
                              phase=0, sel=None, t1=None, t2=None
                              ) -> torch.Tensor:
    """The function K7 computes, in plain torch (differentiable):
    w_sum * sum over quads of t1 E(T1) + t2 E(T2)."""
    f = E / (1.0 - nu ** 2)
    lat = node.reshape(nx, ny, 4)
    up = _up_mask(diag, phase, sel, nx, ny, node.device)
    e1, e2 = _families(lambda a, b, c: _tri_energy(a, b, c, f, nu), lat,
                       _UNIFORM.get(diag, ""), up)
    if t1 is None:
        return w_sum * (torch.sum(e1) + torch.sum(e2))
    return w_sum * torch.sum(t1 * e1 + t2 * e2)


# where each corner slice of the quads lies in the [nx, ny] lattice
_AT = {"n00": (slice(None, -1), slice(None, -1)),
       "n10": (slice(1, None), slice(None, -1)),
       "n11": (slice(1, None), slice(1, None)),
       "n01": (slice(None, -1), slice(1, None))}
_UP_TRIS = (("n00", "n10", "n11"), ("n00", "n11", "n01"))
_DOWN_TRIS = (("n00", "n10", "n01"), ("n10", "n11", "n01"))


def lattice_stencil_vg_plain(node, nx, ny, E, nu, w_sum, diag=UP,
                             phase=0, sel=None, t1=None, t2=None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The function K6 computes, in plain torch: (energy, node gradient
    [nx*ny, 4]), the gradient by the hand-derived triangle cotangents
    (``element_cotangent_plain``) summed into node layout."""
    with torch.no_grad():
        node = node.detach()
        energy = lattice_stencil_fwd_plain(node, nx, ny, E, nu, w_sum, diag,
                                           phase, sel, t1, t2)
        lat = node.reshape(nx, ny, 4)
        up = _up_mask(diag, phase, sel, nx, ny, node.device)
        grad = torch.zeros_like(lat)
        ct = torch.ones((), dtype=node.dtype, device=node.device)
        if diag == UP:
            families = ((_UP_TRIS, None),)
        elif diag == DOWN:
            families = ((_DOWN_TRIS, None),)
        else:
            families = ((_UP_TRIS, up), (_DOWN_TRIS, ~up))
        for tris, keep in families:
            for names, t in zip(tris, (t1, t2)):
                g = torch.stack([lat[_AT[k]] for k in names], dim=-2)
                cot = element_cotangent_plain(
                    g.reshape(-1, 3, 4), ct, E, nu, w_sum
                ).reshape(nx - 1, ny - 1, 3, 4)
                w = torch.ones_like(cot[..., 0, 0]) if t is None else t
                if keep is not None:
                    w = torch.where(keep, w, torch.zeros_like(w))
                for k, name in enumerate(names):
                    grad[_AT[name]] += w[..., None] * cot[..., k, :]
        return energy, grad.reshape(nx * ny, 4)


def _window_lattice(node, nx, ny, lo, hi, diag, phase, sel, t1, t2):
    """The sub-lattice of node rows [lo, hi) as (node, nx, stencil
    arguments): masks cut to its quad rows, the parity phase moved by
    ``lo``."""
    sub = lambda m: None if m is None else m[lo:hi - 1]
    return (node[lo * ny:hi * ny], hi - lo,
            dict(diag=diag, phase=phase + lo, sel=sub(sel), t1=sub(t1),
                 t2=sub(t2)))


def _check_rows(nx, row_lo, row_hi) -> None:
    if not 0 <= row_lo < row_hi <= nx:
        raise ValueError(f"row window [{row_lo}, {row_hi}) is not a "
                         f"non-empty window of the {nx} node rows")


def lattice_stencil_fwd_rows_plain(node, nx, ny, E, nu, w_sum, row_lo,
                                   row_hi, diag=UP, phase=0, sel=None,
                                   t1=None, t2=None) -> torch.Tensor:
    """The function K7 computes over the node rows [row_lo, row_hi), in
    plain torch: the energy of the quads whose n00 row lies there."""
    _check_rows(nx, row_lo, row_hi)
    hi = min(row_hi + 1, nx)
    if hi - row_lo < 2:          # the window is the last row: no quads
        return node.new_zeros(())
    n, m, kw = _window_lattice(node, nx, ny, row_lo, hi, diag, phase, sel,
                               t1, t2)
    return lattice_stencil_fwd_plain(n, m, ny, E, nu, w_sum, **kw)


def lattice_stencil_vg_rows_plain(node, nx, ny, E, nu, w_sum, row_lo,
                                  row_hi, diag=UP, phase=0, sel=None,
                                  t1=None, t2=None
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The function K6 computes over the node rows [row_lo, row_hi), in
    plain torch: (that energy, the node gradient [nx*ny, 4] with the
    window's rows complete and every other row 0).  The gradient comes
    from the sub-lattice of the window and its one-row halo on each side,
    which holds every quad that touches a window node."""
    energy = lattice_stencil_fwd_rows_plain(node.detach(), nx, ny, E, nu,
                                            w_sum, row_lo, row_hi, diag,
                                            phase, sel, t1, t2)
    lo, hi = max(row_lo - 1, 0), min(row_hi + 1, nx)
    n, m, kw = _window_lattice(node.detach(), nx, ny, lo, hi, diag, phase,
                               sel, t1, t2)
    _, g = lattice_stencil_vg_plain(n, m, ny, E, nu, w_sum, **kw)
    grad = torch.zeros((nx * ny, 4), dtype=node.dtype, device=node.device)
    grad[row_lo * ny:row_hi * ny] = g[(row_lo - lo) * ny:(row_hi - lo) * ny]
    return energy, grad


# ----------------------------------------------------------- CUDA kernels
@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = library("lattice_stencil")
    vp, fl, i = ctypes.c_void_p, ctypes.c_float, ctypes.c_int
    head = [i, vp, i, i, i, i, vp, vp, vp, fl, fl, fl, fl]
    lib.hdnn_lattice_stencil_fwd.argtypes = head + [vp, vp]
    lib.hdnn_lattice_stencil_fwd.restype = i
    lib.hdnn_lattice_stencil_vg.argtypes = head + [vp, vp, vp]
    lib.hdnn_lattice_stencil_vg.restype = i
    rows = head[:4] + [i, i] + head[4:]
    lib.hdnn_lattice_stencil_fwd_rows.argtypes = rows + [vp, vp]
    lib.hdnn_lattice_stencil_fwd_rows.restype = i
    lib.hdnn_lattice_stencil_vg_rows.argtypes = rows + [vp, vp, vp]
    lib.hdnn_lattice_stencil_vg_rows.restype = i
    lib.hdnn_lattice_launch_floor.argtypes = [i, i, i, vp]
    lib.hdnn_lattice_launch_floor.restype = i
    return lib


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _check(node, nx, ny, diag, sel, t1, t2) -> None:
    if not node.is_cuda:
        raise ValueError("the lattice stencil kernels take CUDA tensors")
    if node.dtype != torch.float32 or node.dim() != 2 \
            or node.shape != (nx * ny, 4) or not node.is_contiguous():
        raise ValueError("node must be a contiguous float32 [nx*ny, 4] "
                         f"table, got {node.dtype} {tuple(node.shape)} for "
                         f"a {nx}x{ny} lattice")
    if nx < 2 or ny < 2:
        raise ValueError(f"a lattice needs nx, ny >= 2, got {nx}x{ny}")
    if node.data_ptr() % 16:
        raise ValueError("node rows must be 16-byte aligned (float4)")
    if diag not in (UP, DOWN, SEL_MASK, PARITY):
        raise ValueError(f"unknown diag {diag!r}")
    if (diag == SEL_MASK) != (sel is not None) or (t1 is None) != (t2 is None):
        raise ValueError("sel goes with diag=SEL_MASK only, and t1 with t2")
    for name, m in (("sel", sel), ("t1", t1), ("t2", t2)):
        if m is not None and (m.device != node.device
                              or m.dtype != torch.float32
                              or m.shape != (nx - 1, ny - 1)
                              or not m.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 "
                             f"[{nx - 1}, {ny - 1}] tensor on the node "
                             "table's device")


def _launch(vg, node, nx, ny, E, nu, w_sum, diag, phase, sel, t1, t2,
            rows=None, grad=None):
    """K6 (``vg``) or K7 over the whole lattice, or over the node rows
    ``rows = (row_lo, row_hi)`` (then the gradient's other rows are 0), in
    one launch.  K6 writes every row of ``grad`` (a new [nx*ny, 4] tensor
    when None), whatever it held."""
    _check(node, nx, ny, diag, sel, t1, t2)
    lib = _library()
    f, shear = _constants(E, nu)
    if rows is not None:
        _check_rows(nx, *rows)
    dev = node.device
    out = torch.empty((), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    head = (dev.index, node.data_ptr(), nx, ny) + (
        () if rows is None else tuple(rows)) + (
        diag, int(phase) % 2, _ptr(sel), _ptr(t1), _ptr(t2), f, nu, shear,
        w_sum)
    name = "lattice_stencil_" + ("vg" if vg else "fwd") + (
        "" if rows is None else "_rows")
    entry = getattr(lib, "hdnn_" + name)
    if vg:
        if grad is None:
            grad = torch.empty_like(node)
        elif grad.shape != node.shape or grad.dtype != node.dtype \
                or grad.device != dev or not grad.is_contiguous():
            raise ValueError("grad must be a contiguous tensor like node")
        err = entry(*head, grad.data_ptr(), out.data_ptr(), stream)
    else:
        err = entry(*head, out.data_ptr(), stream)
    raise_on(lib, err, name)
    launch_counts[name] += 1
    return (out, grad) if vg else out


def lattice_stencil_fwd(node, nx, ny, E, nu, w_sum, diag=UP, phase=0,
                        sel=None, t1=None, t2=None) -> torch.Tensor:
    """K7 on the card: the lattice energy (0-dim float32 tensor)."""
    return _launch(False, node, nx, ny, float(E), float(nu), float(w_sum),
                   diag, phase, sel, t1, t2)


def lattice_stencil_vg(node, nx, ny, E, nu, w_sum, diag=UP, phase=0,
                       sel=None, t1=None, t2=None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6 on the card: (energy, node gradient [nx*ny, 4]) in one launch."""
    return _launch(True, node, nx, ny, float(E), float(nu), float(w_sum),
                   diag, phase, sel, t1, t2)


def lattice_stencil_fwd_rows(node, nx, ny, E, nu, w_sum, row_lo, row_hi,
                             diag=UP, phase=0, sel=None, t1=None, t2=None
                             ) -> torch.Tensor:
    """K7 on the card over the node rows [row_lo, row_hi): the energy of
    the quads whose n00 row lies there."""
    return _launch(False, node, nx, ny, float(E), float(nu), float(w_sum),
                   diag, phase, sel, t1, t2, rows=(row_lo, row_hi))


def lattice_stencil_vg_rows(node, nx, ny, E, nu, w_sum, row_lo, row_hi,
                            diag=UP, phase=0, sel=None, t1=None, t2=None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6 on the card over the node rows [row_lo, row_hi): (that energy,
    node gradient [nx*ny, 4] with the window's rows, every other row 0);
    the window's rows equal the whole-lattice K6's bit for bit."""
    return _launch(True, node, nx, ny, float(E), float(nu), float(w_sum),
                   diag, phase, sel, t1, t2, rows=(row_lo, row_hi))


# ------------------------------------------------------- autograd wrapper
class _StencilEnergy(torch.autograd.Function):
    """Energy of the node table; forward runs K6 and keeps its gradient
    when one is wanted (``want_grad``), else K7.  The plain versions run
    for a tensor on the CPU."""

    @staticmethod
    def forward(ctx, node, want_grad, nx, ny, E, nu, w_sum, diag, phase,
                sel, t1, t2):
        args = (node, nx, ny, E, nu, w_sum, diag, phase, sel, t1, t2)
        if not want_grad:
            ctx.save_for_backward(None)
            return (lattice_stencil_fwd(*args) if node.is_cuda
                    else lattice_stencil_fwd_plain(*args))
        e, g = (lattice_stencil_vg(*args) if node.is_cuda
                else lattice_stencil_vg_plain(*args))
        ctx.save_for_backward(g)
        return e

    @staticmethod
    def backward(ctx, ct):
        (g,) = ctx.saved_tensors
        if g is None:
            raise RuntimeError("the stencil energy ran without its "
                               "gradient (want_grad=False)")
        return (ct * g,) + (None,) * 11


def _stencil_energy(node, nx, ny, E, nu, w_sum, diag, phase=0, sel=None,
                    t1=None, t2=None):
    want = torch.is_grad_enabled() and node.requires_grad
    return _StencilEnergy.apply(node.contiguous(), want, nx, ny, float(E),
                                float(nu), float(w_sum), diag, phase, sel,
                                t1, t2)


def _edge_work_from_node(node, route, t_x: float, t_y: float = 0.0):
    """Uniform-traction edge work from the [N, 4] node table viewed as the
    lattice (identity numbering only); the same exact integral as
    ``lattice_energy._edge_work``."""
    lat = node.reshape(route.nx, route.ny, 4)
    return face_work(lambda face, k: lattice_face(lat, face, k),
                     route.edge_masks, t_x, t_y, node.new_zeros(()))


def lattice_total_slab(node, route, E, nu, w_sum, t_x, t_y=0.0):
    """domain - traction work of an identity-numbered route, the domain
    term on the stencil kernels.  Caller checks :func:`slab_supported`."""
    dom = _stencil_energy(node, route.nx, route.ny, E, nu, w_sum,
                          **route_stencil(route))
    return dom - _edge_work_from_node(node, route, t_x, t_y)


def structured_domain_slab(node3, quad_mask, split, zigzag_phase, E, nu):
    """``StructuredGridP1._domain_from_node`` on the stencil kernels: 0.5
    sum(quad_mask * (E(T1) + E(T2))) over the [nx, ny, 4] node lattice,
    the zigzag parity in the kernel."""
    nx, ny = node3.shape[0], node3.shape[1]
    return _stencil_energy(node3.reshape(nx * ny, 4), nx, ny, E, nu, 0.5,
                           **structured_stencil(quad_mask, split,
                                                zigzag_phase, node3.dtype))
