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
  float32), as in the JAX package;
* ``lattice_level_step``, ``lattice_restrict``, ``lattice_bottom_cycle``
  and ``lattice_level_cycle``: the multigrid level steps on a
  ``LatticeLevel`` (K6's level epilogues, restriction, and the bottom
  levels' V-cycle in one CTA; each launch adds one to
  ``launch_counts`` under the wrapper's name), with their plain versions
  ``lattice_level_step_plain``, ``restrict_plain`` and
  ``lattice_level_cycle_plain`` (the composition of
  ``solve/multigrid.py``, bit for bit), ``prolong``, and
  ``cycle_launches``, the launches of a ``lattice_level_cycle``.

A diagonal is given as ``diag``: 0 every quad "up", 1 every quad "down",
2 per quad from a ``sel`` mask (> 0: up), 3 the zigzag parity (quad (i, j)
is up when i + j + ``phase`` is even).  ``t1``/``t2`` are the per-quad
presence weights of the two triangles, or None when all are present.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
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
           "reset_launch_counts", "prolong", "restrict_plain",
           "LatticeLevel", "lattice_level_step", "lattice_level_step_plain",
           "lattice_restrict", "lattice_bottom_cycle", "lattice_level_cycle",
           "lattice_level_cycle_plain", "cycle_launches", "LEVEL_KERNELS",
           "UP", "DOWN", "SEL_MASK", "PARITY",
           "MATVEC", "RESIDUAL", "STEP", "FROM_ZERO", "POST_FIRST"]

UP, DOWN, SEL_MASK, PARITY = 0, 1, 2, 3
_UNIFORM = {UP: "up", DOWN: "down"}

# the multigrid level steps (stencil_vg_kernel's level epilogues)
MATVEC, RESIDUAL, STEP, FROM_ZERO, POST_FIRST = 1, 2, 3, 4, 5
# the one-CTA bottom kernel's limits (kBottom* in csrc/lattice_stencil.cu):
# levels, smoothing degree, nodes and quads of a level, and its shared
# memory: a fixed part and the levels' vectors, within the block's 227 KB
_BOTTOM_LEVELS, _BOTTOM_STEPS, _BOTTOM_NODES, _BOTTOM_QUADS = 6, 32, 2304, 2048
_BOTTOM_SMEM_FIXED, _BOTTOM_SMEM_MAX = 135168, 232448 - 256

# the multigrid level kernels' wrappers, as ``launch_counts`` names them
LEVEL_KERNELS = ("lattice_level_step", "lattice_restrict",
                 "lattice_bottom_cycle")
# launches of each kernel wrapper since the last reset
launch_counts = {"lattice_stencil_vg": 0, "lattice_stencil_fwd": 0,
                 "lattice_stencil_vg_rows": 0, "lattice_stencil_fwd_rows": 0,
                 **dict.fromkeys(LEVEL_KERNELS, 0)}


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


# ------------------------------------------------- multigrid level steps
@dataclasses.dataclass(frozen=True)
class LatticeLevel:
    """A multigrid level on the stencil: its operator K v, the displacement
    columns of the stencil gradient (w_sum 0.5) at (``coords``, v with the
    ``pinned`` rows 0), 0 on the pinned rows, which is the level operator
    grad E(v) - grad E(0) wherever the pinned rows hold 0; and, for a
    cycle, its Chebyshev-Jacobi smoother: ``dinv``, ``free``, ``theta``
    and ``coeffs`` ((c1, c2) of each step after the first)."""

    coords: torch.Tensor                  # [nx, ny, 2] pinned coordinates
    pinned: torch.Tensor                  # [nx, ny] bool
    E: float
    nu: float
    stencil: dict                         # diag, phase, t1, t2
    dinv: Optional[torch.Tensor] = None   # [nx, ny, 2]
    free: Optional[torch.Tensor] = None   # [nx, ny, 2]
    theta: float = 1.0
    coeffs: tuple = ()

    @property
    def nx(self) -> int:
        return self.coords.shape[0]

    @property
    def ny(self) -> int:
        return self.coords.shape[1]


def prolong(cu: torch.Tensor) -> torch.Tensor:
    """Bilinear lattice interpolation [nxc, nyc, C] -> [2nxc-1, 2nyc-1, C]
    (split-agnostic and symmetric): a row pass, then a column pass."""
    nxc, nyc, c = cu.shape
    rows = torch.stack([cu[:-1], 0.5 * (cu[:-1] + cu[1:])], dim=1)
    rows = torch.cat([rows.reshape(2 * (nxc - 1), nyc, c), cu[-1:]], dim=0)
    cols = torch.stack([rows[:, :-1], 0.5 * (rows[:, :-1] + rows[:, 1:])],
                       dim=2)
    return torch.cat([cols.reshape(2 * nxc - 1, 2 * (nyc - 1), c),
                      rows[:, -1:]], dim=1)


def _restrict_axis(r: torch.Tensor, dim: int) -> torch.Tensor:
    """The transpose of one interpolation pass of ``prolong`` along
    ``dim`` (length 2n-1 -> n): coarse entry i takes half of fine entries
    2i-1 and 2i+1, then fine entry 2i, added in the order of the JAX
    package's ``jax.linear_transpose`` (so the two agree bit for bit)."""
    r = r.movedim(dim, 0)
    half = 0.5 * r[1::2]
    out = torch.zeros_like(r[0::2])
    out[1:] = half
    out[:-1] += half
    return (out + r[0::2]).movedim(0, dim)


def restrict_plain(r: torch.Tensor) -> torch.Tensor:
    """Full-weighting restriction, the exact adjoint of ``prolong``: the
    transposed column pass, then the transposed row pass (the function
    ``lattice_restrict`` computes)."""
    return _restrict_axis(_restrict_axis(r, 1), 0)


def _level_product_plain(lv: LatticeLevel, v: torch.Tensor) -> torch.Tensor:
    """K v on ``lv`` (``LatticeLevel``), in plain torch: the level
    operator's own stencil gradient, its pinned rows 0."""
    pin = lv.pinned[..., None]
    node = torch.cat([lv.coords, torch.where(pin, 0.0, v)], dim=-1)
    _, g = lattice_stencil_vg_plain(node.reshape(lv.nx * lv.ny, 4), lv.nx,
                                    lv.ny, lv.E, lv.nu, 0.5, **lv.stencil)
    return torch.where(pin, 0.0,
                       g.reshape(lv.nx, lv.ny, 4)[..., 2:]).to(v.dtype)


def lattice_level_step_plain(kind: int, lv: LatticeLevel, v: torch.Tensor,
                             b=None, r=None, x=None, xc=None,
                             c=(0.0, 0.0)):
    """The function each level epilogue of K6 computes, in plain torch:
    the ops of ``solve/multigrid.py``'s composition, bit for bit.

    ``MATVEC``: K v.  ``RESIDUAL``: b - K v (v = x).  ``STEP``: one
    Chebyshev step from (r, d = v, x) with ``c`` = (c1, c2): r - K d,
    c1 d + c2 dinv r, x + d, returned as (r, d, x).  ``FROM_ZERO``: the
    smoother's first two steps from x = 0 on b = v (the first with no
    stencil: K 0 = 0), (r, d, x).  ``POST_FIRST``: the prolonged
    correction x + free prolong(xc) of x = v and the smoother's first
    step on b, (r, d, x)."""
    c1, c2 = c
    if kind == FROM_ZERO:
        d0 = (lv.dinv * v) / lv.theta
        x0 = torch.zeros_like(v) + d0
        r = v - _level_product_plain(lv, d0)
        d = c1 * d0 + c2 * (lv.dinv * r)
        return r, d, x0 + d
    if kind == POST_FIRST:
        xp = v + lv.free * prolong(xc)
        r = b - _level_product_plain(lv, xp)
        d = (lv.dinv * r) / lv.theta
        return r, d, xp + d
    w = _level_product_plain(lv, v)
    if kind == MATVEC:
        return w
    if kind == RESIDUAL:
        return b - w
    if kind == STEP:
        r = r - w
        d = c1 * v + c2 * (lv.dinv * r)
        return r, d, x + d
    raise ValueError(f"unknown level step {kind!r}")


def _smooth_from_zero(step, lv: LatticeLevel, b):
    """The level's smoothing of K x = b from x = 0, to its degree."""
    r, d, x = step(FROM_ZERO, lv, b, c=lv.coeffs[0])
    for c in lv.coeffs[1:]:
        r, d, x = step(STEP, lv, d, r=r, x=x, c=c)
    return x


def _cycle(levels, b, plain: bool):
    """V(nu, nu) from ``levels[0]`` (module doc of ``solve/multigrid.py``):
    the level steps, and on the card the bottom kernel once the levels
    fit it."""
    step = lattice_level_step_plain if plain else lattice_level_step
    if not plain and _fits_bottom(levels):
        return lattice_bottom_cycle(levels, b)
    lv = levels[0]
    x = _smooth_from_zero(step, lv, b)
    if len(levels) == 1:
        return x
    res = step(RESIDUAL, lv, x, b=b)
    bc = restrict_plain(res) if plain else lattice_restrict(res)
    xc = _cycle(levels[1:], bc, plain)
    r, d, x = step(POST_FIRST, lv, x, b=b, xc=xc)
    for c in lv.coeffs:
        r, d, x = step(STEP, lv, d, r=r, x=x, c=c)
    return x


def lattice_level_cycle_plain(levels, b: torch.Tensor) -> torch.Tensor:
    """One V(nu, nu) cycle from ``levels[0]`` (``LatticeLevel``s with
    their smoothers, finest first; each level's degree is
    ``len(coeffs) + 1``, at least 2) on the right-hand side b, in plain
    torch: ``solve/multigrid.py``'s composition bit for bit, and the
    function the bottom kernel computes over its levels."""
    return _cycle(levels, b, plain=True)


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
    lib.hdnn_lattice_level_step.argtypes = (
        [i, i, i, i, i, i, vp, vp, fl, fl, fl, fl] + [vp] * 9 + [i]
        + [vp] * 3 + [fl, fl, fl, vp])
    lib.hdnn_lattice_level_step.restype = i
    lib.hdnn_lattice_restrict.argtypes = [i, i, i, vp, vp, vp]
    lib.hdnn_lattice_restrict.restype = i
    lib.hdnn_lattice_bottom.argtypes = [i, i, i, fl, fl, fl, fl, vp, vp, vp,
                                        vp]
    lib.hdnn_lattice_bottom.restype = i
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


def _check_level(lv: LatticeLevel, *vectors) -> torch.device:
    """The level and its vectors as the level kernels take them."""
    dev = lv.coords.device
    if not lv.coords.is_cuda:
        raise ValueError("the level step kernels take CUDA tensors")
    st = lv.stencil
    if st["diag"] not in (UP, DOWN, PARITY) or st.get("sel") is not None \
            or st["t1"] is None or st["t2"] is None:
        raise ValueError("the level step kernels take a structured level: "
                         "its quad mask as both weights, a uniform or "
                         "zigzag diagonal")
    shape = (lv.nx, lv.ny, 2)
    for name, t, want in (("coords", lv.coords, shape),
                          ("dinv", lv.dinv, shape), ("free", lv.free, shape),
                          ("t1", st["t1"], (lv.nx - 1, lv.ny - 1)),
                          ("t2", st["t2"], (lv.nx - 1, lv.ny - 1))) + tuple(
                              ("vector", v, shape) for v in vectors):
        if t is None:
            continue
        if t.device != dev or t.dtype != torch.float32 \
                or tuple(t.shape) != want or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 {want} "
                             f"tensor on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if lv.pinned.dtype != torch.bool or tuple(lv.pinned.shape) != shape[:2] \
            or not lv.pinned.is_contiguous() or lv.pinned.device != dev:
        raise ValueError(f"pinned must be a contiguous bool {shape[:2]} "
                         f"tensor on {dev}")
    return dev


def _inv(theta: float) -> float:
    """1 / theta in float32, as torch divides a float32 CUDA tensor by a
    Python scalar (a product with the reciprocal)."""
    return float(np.float32(1.0) / np.float32(theta))


def lattice_level_step(kind: int, lv: LatticeLevel, v: torch.Tensor,
                       b=None, r=None, x=None, xc=None, c=(0.0, 0.0)):
    """A multigrid level step on the card, in one launch of K6's level
    epilogue: ``lattice_level_step_plain``'s function and returns, bit for
    bit where the stencil sums keep K6's order.  ``STEP`` updates r and x
    in place (each node reads and writes only its own entries) and returns
    them with a new d; every other output is a new tensor."""
    dev = _check_level(lv, v, b, r, x)
    if kind == POST_FIRST:
        want = ((lv.nx + 1) // 2, (lv.ny + 1) // 2, 2)
        if lv.nx % 2 == 0 or lv.ny % 2 == 0 or xc is None \
                or tuple(xc.shape) != want or xc.dtype != torch.float32 \
                or xc.device != dev or not xc.is_contiguous():
            raise ValueError(f"xc must be a contiguous float32 {want} tensor "
                             f"on {dev} of an odd-sized level")
    need = {MATVEC: (), RESIDUAL: (b,), STEP: (r, x), FROM_ZERO: (),
            POST_FIRST: (b,)}
    if kind not in need:
        raise ValueError(f"unknown level step {kind!r}")
    if any(t is None for t in need[kind]):
        raise ValueError(f"level step {kind} misses one of its vectors")
    lib = _library()
    f, shear = _constants(lv.E, lv.nu)
    out_r = r if kind == STEP else torch.empty_like(v)
    out_d = out_x = None
    if kind in (STEP, FROM_ZERO, POST_FIRST):
        out_d = torch.empty_like(v)
        out_x = x if kind == STEP else torch.empty_like(v)
    st = lv.stencil
    err = lib.hdnn_lattice_level_step(
        dev.index, kind, lv.nx, lv.ny, st["diag"], int(st["phase"]) % 2,
        _ptr(st["t1"]), _ptr(st["t2"]), f, lv.nu, shear, 0.5,
        _ptr(lv.coords), _ptr(lv.pinned), _ptr(lv.dinv), _ptr(lv.free),
        _ptr(v), _ptr(b), _ptr(r), _ptr(x), _ptr(xc),
        0 if xc is None else xc.shape[1], _ptr(out_r), _ptr(out_d),
        _ptr(out_x), float(c[0]), float(c[1]), _inv(lv.theta),
        torch.cuda.current_stream(dev).cuda_stream)
    raise_on(lib, err, "lattice_level_step")
    launch_counts["lattice_level_step"] += 1
    if kind in (MATVEC, RESIDUAL):
        return out_r
    return out_r, out_d, out_x


def lattice_restrict(r: torch.Tensor) -> torch.Tensor:
    """``restrict_plain`` on the card in one launch, bit for bit: r
    [nx, ny, 2] float32 (nx, ny odd) -> [(nx + 1) / 2, (ny + 1) / 2, 2]."""
    nx, ny = r.shape[0], r.shape[1]
    if not r.is_cuda or r.dtype != torch.float32 or r.dim() != 3 \
            or r.shape[2] != 2 or not r.is_contiguous() or nx % 2 == 0 \
            or ny % 2 == 0 or nx < 3 or ny < 3:
        raise ValueError("lattice_restrict takes a contiguous float32 CUDA "
                         f"[nx, ny, 2] tensor of odd nx, ny >= 3, got "
                         f"{r.dtype} {tuple(r.shape)} on {r.device}")
    lib = _library()
    out = r.new_empty(((nx + 1) // 2, (ny + 1) // 2, 2))
    err = lib.hdnn_lattice_restrict(
        r.device.index, nx, ny, r.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(r.device).cuda_stream)
    raise_on(lib, err, "lattice_restrict")
    launch_counts["lattice_restrict"] += 1
    return out


def _fits_bottom(levels) -> bool:
    """Whether the one-CTA bottom kernel takes these levels: its vectors
    (level 0's x, r, d, every other level's b, x, r, d) in shared memory
    beside its fixed part."""
    top = levels[0]
    vectors = 8 * sum((4 if k else 3) * lv.nx * lv.ny
                      for k, lv in enumerate(levels))
    return (len(levels) <= _BOTTOM_LEVELS
            and top.nx * top.ny <= _BOTTOM_NODES
            and (top.nx - 1) * (top.ny - 1) <= _BOTTOM_QUADS
            and _BOTTOM_SMEM_FIXED + vectors <= _BOTTOM_SMEM_MAX
            and all(2 <= len(lv.coeffs) + 1 <= _BOTTOM_STEPS
                    for lv in levels))


def lattice_bottom_cycle(levels, b: torch.Tensor) -> torch.Tensor:
    """``lattice_level_cycle_plain(levels, b)`` on the card in one launch
    of one CTA (``level_bottom_kernel``): the levels' vectors in its
    shared memory, the answer a new tensor."""
    if not _fits_bottom(levels):
        raise ValueError("the bottom kernel takes at most "
                         f"{_BOTTOM_LEVELS} levels of at most "
                         f"{_BOTTOM_NODES} nodes, degrees 2-{_BOTTOM_STEPS}")
    dev = _check_level(levels[0], b)
    diag = levels[0].stencil["diag"]
    out = torch.empty_like(b)
    ptrs, ints, coefs = [], [], []
    for k, lv in enumerate(levels):
        _check_level(lv)
        if lv.stencil["diag"] != diag:
            raise ValueError("the bottom levels share one diagonal")
        st = lv.stencil
        ptrs += [_ptr(lv.coords), _ptr(lv.pinned), _ptr(lv.dinv),
                 _ptr(lv.free), _ptr(st["t1"]), _ptr(st["t2"]),
                 _ptr(b) if k == 0 else 0, _ptr(out) if k == 0 else 0]
        ints += [lv.nx, lv.ny, int(st["phase"]) % 2, len(lv.coeffs) + 1]
        pad = [0.0] * (_BOTTOM_STEPS - 1 - len(lv.coeffs))
        coefs += ([_inv(lv.theta)] + [c1 for c1, _ in lv.coeffs] + pad
                  + [c2 for _, c2 in lv.coeffs] + pad)
    lib = _library()
    f, shear = _constants(levels[0].E, levels[0].nu)
    err = lib.hdnn_lattice_bottom(
        dev.index, len(levels), diag, f, levels[0].nu, shear, 0.5,
        (ctypes.c_uint64 * len(ptrs))(*ptrs),
        (ctypes.c_int * len(ints))(*ints),
        (ctypes.c_float * len(coefs))(*coefs),
        torch.cuda.current_stream(dev).cuda_stream)
    raise_on(lib, err, "lattice_bottom_cycle")
    launch_counts["lattice_bottom_cycle"] += 1
    return out


def lattice_level_cycle(levels, b: torch.Tensor) -> torch.Tensor:
    """``lattice_level_cycle_plain`` on the card: each level above the
    bottom in level steps and one restriction, the bottom levels in one
    launch of ``lattice_bottom_cycle`` (``cycle_launches`` counts them)."""
    return _cycle(levels, b, plain=False)


def cycle_launches(levels) -> dict:
    """The launches of ``lattice_level_cycle(levels, b)`` by wrapper (the
    ``LEVEL_KERNELS`` keys of ``launch_counts``), as ``_cycle`` decides
    them: on each level above the bottom 2 nu level steps (the first two
    smoothing steps from x = 0 in one, nu - 2 more, the residual, the
    prolonged correction with the first post-smoothing step, nu - 1 more)
    and one restriction; then one bottom cycle from the first level whose
    levels fit it (``_fits_bottom``), or else the coarsest level's
    degree - 1 steps."""
    out = dict.fromkeys(LEVEL_KERNELS, 0)
    for k, lv in enumerate(levels):
        if _fits_bottom(levels[k:]):
            out["lattice_bottom_cycle"] += 1
            break
        if k == len(levels) - 1:
            out["lattice_level_step"] += len(lv.coeffs)
            break
        out["lattice_level_step"] += 2 * len(lv.coeffs) + 2
        out["lattice_restrict"] += 1
    return out


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
