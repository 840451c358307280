"""Fused P1 plane-stress element energy (port of
``hidenn_fem_tpu/ops/pallas_energy.py``).

The TPU package gathered the corners into a lane-major [12, Ne] copy and
ran two Pallas kernels on it: K1 (``_forward``, the energy sum) and K2
(``_bwd_rule``, the corner cotangents via ``jax.grad`` inside the kernel).
Here the same two functions are one CUDA source,
``hidenn_fem_tpu_torch/csrc/element_energy.cu``, whose kernels read the
connectivity and the [N, 4] node table themselves (the gather is fused)
and whose gradient is derived by hand.  A third kernel of the source,
``incidence_sum``, assembles the corner cotangents into node gradients
(the JAX package left that gather to XLA; on the H100 the plain torch
gather was the largest cost of the backward).  The source's header says
what bounds them on the H100 and what the design does about it.

Beside the kernels, in this module:

* ``element_energy_plain``: the energy in plain torch on gathered corners
  g [Ne, 3, 4], differentiable by autograd.
* ``element_cotangent_plain``: the hand-derived cotangent formula of the
  backward kernel, in plain torch.
* ``element_energy``: node table -> energy as an autograd Function.  For a
  tensor on the card it launches the kernels (or raises); for a tensor on
  the CPU it runs the two plain functions above and the plain incidence
  gather-sum (``ops/assembly.py``).
* ``launch_counts``: how often each kernel wrapper launched its kernel.

Energy per element (the formula of ``pallas_energy.py:19-28``)::

    a = v0 - v2, b = v1 - v2, det = ax*by - bx*ay
    exx = ( by*d0x - ay*d1x) / det         d0 = u0 - u2
    eyy = (-bx*d0y + ax*d1y) / det         d1 = u1 - u2
    gxy = (by*d0y - ay*d1y - bx*d0x + ax*d1x) / det
    dens = f/2 (exx^2 + eyy^2 + 2 nu exx eyy) + f(1-nu)/4 gxy^2
    E_elem = w_sum * |det| * dens

|det| < 1e-12 is guarded to -1e-12 if det < 0, else +1e-12, so zero and
degenerate elements give exactly 0.  d|det|/d det is +1 at det == 0, as
``jax.grad(jnp.abs)(0.0)`` is (``torch.abs`` would give 0).  Elements at
index >= ``edge_start`` are Neumann edge pseudo-elements (n0, n1, n1) that
add ``tw * ds * (u0x + u1x) / 2`` with ``ds = sqrt(max(|v0-v1|^2, 1e-30))``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from .assembly import assemble_node_grad, flat_gather
from .cuda_build import library, raise_on

__all__ = ["element_energy", "element_energy_plain",
           "element_cotangent_plain", "element_energy_fwd",
           "element_energy_bwd", "incidence_sum", "launch_counts",
           "reset_launch_counts"]

_EPS_DET = 1e-12
_DS_FLOOR = 1e-30

# launches of each kernel wrapper since the last reset
launch_counts = {"element_energy_fwd": 0, "element_energy_bwd": 0,
                 "incidence_sum": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


# ------------------------------------------------------------ plain torch
def _constants(E: float, nu: float):
    f = E / (1.0 - nu ** 2)
    return f, f * (1.0 - nu) / 2.0


def _strain(g: torch.Tensor, E: float, nu: float):
    """Intermediates of the element algebra on g [Ne, 3, 4]."""
    f, shear = _constants(E, nu)
    v0, v1, v2 = g[:, 0], g[:, 1], g[:, 2]
    ax = v0[:, 0] - v2[:, 0]
    ay = v0[:, 1] - v2[:, 1]
    bx = v1[:, 0] - v2[:, 0]
    by = v1[:, 1] - v2[:, 1]
    d0x = v0[:, 2] - v2[:, 2]
    d0y = v0[:, 3] - v2[:, 3]
    d1x = v1[:, 2] - v2[:, 2]
    d1y = v1[:, 3] - v2[:, 3]
    det = ax * by - bx * ay
    eps = torch.full_like(det, _EPS_DET)
    tiny = det.abs() < _EPS_DET
    inv = 1.0 / torch.where(tiny, torch.where(det < 0, -eps, eps), det)
    P = by * d0x - ay * d1x
    Q = -bx * d0y + ax * d1y
    R = (by * d0y - ay * d1y) + (-bx * d0x + ax * d1x)
    exx = P * inv
    eyy = Q * inv
    gxy = R * inv
    dens = 0.5 * (f * (exx * exx + eyy * eyy + 2.0 * nu * exx * eyy)
                  + shear * gxy * gxy)
    return dict(ax=ax, ay=ay, bx=bx, by=by, d0x=d0x, d0y=d0y, d1x=d1x,
                d1y=d1y, det=det, tiny=tiny, inv=inv, P=P, Q=Q, R=R,
                exx=exx, eyy=eyy, gxy=gxy, dens=dens, f=f, shear=shear)


def _abs_jax(x: torch.Tensor) -> torch.Tensor:
    """|x| whose derivative at 0 is +1, as JAX differentiates jnp.abs."""
    return torch.where(x >= 0, x, -x)


def element_energy_plain(g: torch.Tensor, E: float, nu: float,
                         w_sum: float, edge_start: Optional[int] = None,
                         tw: float = 0.0) -> torch.Tensor:
    """Total energy of gathered corners g [Ne, 3, 4] (plain torch,
    differentiable by autograd with the JAX conventions)."""
    s = _strain(g, E, nu)
    total = torch.sum(w_sum * _abs_jax(s["det"]) * s["dens"])
    if edge_start is not None:
        e = g[edge_start:]
        sx = e[:, 0, 0] - e[:, 1, 0]
        sy = e[:, 0, 1] - e[:, 1, 1]
        s2 = sx * sx + sy * sy
        ds = torch.sqrt(torch.maximum(s2, torch.full_like(s2, _DS_FLOOR)))
        total = total + tw * torch.sum(ds * 0.5 * (e[:, 0, 2] + e[:, 1, 2]))
    return total


def element_cotangent_plain(g: torch.Tensor, ct: torch.Tensor, E: float,
                            nu: float, w_sum: float,
                            edge_start: Optional[int] = None,
                            tw: float = 0.0) -> torch.Tensor:
    """ct * d(element_energy_plain)/d(g) [Ne, 3, 4] by the hand-derived
    formula of the backward kernel (``csrc/element_energy.cu``)."""
    s = _strain(g, E, nu)
    det, inv = s["det"], s["inv"]
    A = w_sum * det.abs()
    gexx = A * (s["f"] * (s["exx"] + nu * s["eyy"]))
    geyy = A * (s["f"] * (s["eyy"] + nu * s["exx"]))
    ggxy = A * (s["shear"] * s["gxy"])
    gP, gQ, gR = gexx * inv, geyy * inv, ggxy * inv
    ginv = gexx * s["P"] + geyy * s["Q"] + ggxy * s["R"]
    sgn = torch.where(det >= 0, 1.0, -1.0).to(det.dtype)
    gdet = w_sum * sgn * s["dens"]
    gdet = torch.where(s["tiny"], gdet, gdet - ginv * inv * inv)
    ax, ay, bx, by = s["ax"], s["ay"], s["bx"], s["by"]
    d0x, d0y, d1x, d1y = s["d0x"], s["d0y"], s["d1x"], s["d1y"]
    g_ax = gQ * d1y + gR * d1x + gdet * by
    g_ay = -gP * d1x - gR * d1y - gdet * bx
    g_bx = -gQ * d0y - gR * d0x - gdet * ay
    g_by = gP * d0x + gR * d0y + gdet * ax
    g_d0x = gP * by - gR * bx
    g_d0y = -gQ * bx + gR * by
    g_d1x = -gP * ay + gR * ax
    g_d1y = gQ * ax - gR * ay
    c0 = torch.stack([g_ax, g_ay, g_d0x, g_d0y], dim=1)
    c1 = torch.stack([g_bx, g_by, g_d1x, g_d1y], dim=1)
    c2 = -(c0 + c1)
    if edge_start is not None:
        e = g[edge_start:]
        sx = e[:, 0, 0] - e[:, 1, 0]
        sy = e[:, 0, 1] - e[:, 1, 1]
        s2 = sx * sx + sy * sy
        ds = torch.sqrt(torch.maximum(s2, torch.full_like(s2, _DS_FLOOR)))
        gds = tw * (0.5 * (e[:, 0, 2] + e[:, 1, 2]))
        gate = torch.where(s2 > _DS_FLOOR, 1.0,
                           torch.where(s2 == _DS_FLOOR, 0.5, 0.0))
        gs2 = gds * (0.5 / ds) * gate.to(s2.dtype)
        zero = torch.zeros_like(ds)
        gu = tw * (ds * 0.5)
        edge = torch.stack([2.0 * gs2 * sx, 2.0 * gs2 * sy, gu, zero], dim=1)
        flip = torch.stack([-2.0 * gs2 * sx, -2.0 * gs2 * sy, gu, zero],
                           dim=1)
        pad = g.shape[0] - e.shape[0]
        c0 = c0 + torch.nn.functional.pad(edge, (0, 0, pad, 0))
        c1 = c1 + torch.nn.functional.pad(flip, (0, 0, pad, 0))
    return torch.stack([c0, c1, c2], dim=1) * ct


# ----------------------------------------------------------- CUDA kernels
@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = library("element_energy")
    vp, ll, fl, i = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float,
                     ctypes.c_int)
    lib.hdnn_threads_per_block.argtypes = []
    lib.hdnn_threads_per_block.restype = i
    lib.hdnn_element_energy_fwd.argtypes = [
        i, vp, vp, ll, ll, fl, fl, fl, fl, fl, vp, i, vp, vp]
    lib.hdnn_element_energy_fwd.restype = i
    lib.hdnn_element_energy_bwd.argtypes = [
        i, vp, vp, ll, ll, fl, fl, fl, fl, fl, vp, vp, vp]
    lib.hdnn_element_energy_bwd.restype = i
    lib.hdnn_incidence_sum.argtypes = [i, vp, vp, ll, i, vp, vp]
    lib.hdnn_incidence_sum.restype = i
    return lib


def _check_inputs(node: torch.Tensor, conn: torch.Tensor) -> None:
    if not node.is_cuda:
        raise ValueError("the element-energy kernels take CUDA tensors")
    if node.dtype != torch.float32 or node.dim() != 2 \
            or node.shape[1] != 4 or not node.is_contiguous():
        raise ValueError("node must be a contiguous float32 [N, 4] table, "
                         f"got {node.dtype} {tuple(node.shape)}")
    if node.data_ptr() % 16:
        raise ValueError("node rows must be 16-byte aligned (float4)")
    if conn.device != node.device or conn.dtype != torch.int32 \
            or conn.dim() != 2 or conn.shape[1] != 3 \
            or not conn.is_contiguous():
        raise ValueError("conn must be a contiguous int32 [Ne, 3] tensor "
                         "on the node table's device")
    if conn.shape[0] == 0:
        raise ValueError("no elements")


def _scalars(conn, E, nu, w_sum, edge_start, tw):
    f, shear = _constants(E, nu)
    ne = conn.shape[0]
    return (ne, ne if edge_start is None else int(edge_start),
            f, nu, shear, w_sum, tw)


def element_energy_fwd(node: torch.Tensor, conn: torch.Tensor, E: float,
                       nu: float, w_sum: float,
                       edge_start: Optional[int] = None,
                       tw: float = 0.0) -> torch.Tensor:
    """K1 on the card: total energy (0-dim float32 tensor) of the
    elements ``conn`` over the node table ``node``.  ``conn`` must index
    rows of ``node`` (``TriMesh.from_arrays`` checks its tables)."""
    _check_inputs(node, conn)
    lib = _library()
    ne = conn.shape[0]
    n_part = -(-ne // lib.hdnn_threads_per_block())
    partials = torch.empty(n_part, dtype=torch.float32, device=node.device)
    out = torch.empty((), dtype=torch.float32, device=node.device)
    stream = torch.cuda.current_stream(node.device).cuda_stream
    err = lib.hdnn_element_energy_fwd(
        node.device.index, node.data_ptr(), conn.data_ptr(),
        *_scalars(conn, E, nu, w_sum, edge_start, tw),
        partials.data_ptr(), n_part, out.data_ptr(), stream)
    raise_on(lib, err, "element_energy_fwd")
    launch_counts["element_energy_fwd"] += 1
    return out


def element_energy_bwd(node: torch.Tensor, conn: torch.Tensor,
                       ct: torch.Tensor, E: float, nu: float, w_sum: float,
                       edge_start: Optional[int] = None,
                       tw: float = 0.0) -> torch.Tensor:
    """K2 on the card: corner cotangents [Ne, 3, 4] times the upstream
    scalar ``ct`` (a one-element float32 tensor on the card)."""
    _check_inputs(node, conn)
    ct = ct.reshape(()).to(dtype=torch.float32).contiguous()
    if ct.device != node.device:
        raise ValueError("ct must lie on the node table's device")
    lib = _library()
    cot = torch.empty((conn.shape[0], 3, 4), dtype=torch.float32,
                      device=node.device)
    stream = torch.cuda.current_stream(node.device).cuda_stream
    err = lib.hdnn_element_energy_bwd(
        node.device.index, node.data_ptr(), conn.data_ptr(),
        *_scalars(conn, E, nu, w_sum, edge_start, tw),
        ct.data_ptr(), cot.data_ptr(), stream)
    raise_on(lib, err, "element_energy_bwd")
    launch_counts["element_energy_bwd"] += 1
    return cot


def incidence_sum(cot: torch.Tensor,
                  incidence: torch.Tensor) -> torch.Tensor:
    """Node gradients [N, 4] on the card: grad[n] = sum over the slots k of
    ``cot`` row ``incidence[n, k]`` (slots of -1 skipped), with ``cot`` the
    [Ne, 3, 4] corner cotangents.  The plain version is
    ``ops.assembly.incidence_gather_sum`` over the zero-padded rows."""
    if not cot.is_cuda:
        raise ValueError("the incidence_sum kernel takes CUDA tensors")
    if cot.dtype != torch.float32 or cot.shape[-1] != 4 \
            or not cot.is_contiguous() or cot.data_ptr() % 16:
        raise ValueError("cot must be a contiguous, 16-byte aligned "
                         "float32 tensor of 4-wide rows")
    if incidence.device != cot.device or incidence.dtype != torch.int32 \
            or incidence.dim() != 2 or not incidence.is_contiguous() \
            or incidence.shape[0] == 0:
        raise ValueError("incidence must be a contiguous int32 [N, K] "
                         "tensor on cot's device")
    lib = _library()
    n, k = incidence.shape
    grad = torch.empty((n, 4), dtype=torch.float32, device=cot.device)
    stream = torch.cuda.current_stream(cot.device).cuda_stream
    err = lib.hdnn_incidence_sum(cot.device.index, cot.data_ptr(),
                                 incidence.data_ptr(), n, k,
                                 grad.data_ptr(), stream)
    raise_on(lib, err, "incidence_sum")
    launch_counts["incidence_sum"] += 1
    return grad


# ------------------------------------------------------- autograd wrapper
class _ElementEnergy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, node, conn, incidence, E, nu, w_sum, edge_start, tw):
        ctx.save_for_backward(node, conn, incidence)
        ctx.args = (E, nu, w_sum, edge_start, tw)
        if node.is_cuda:
            return element_energy_fwd(node, conn, E, nu, w_sum,
                                      edge_start, tw)
        return element_energy_plain(flat_gather(node, conn), E, nu, w_sum,
                                    edge_start, tw)

    @staticmethod
    def backward(ctx, ct):
        node, conn, incidence = ctx.saved_tensors
        if node.is_cuda:
            cot = element_energy_bwd(node, conn, ct, *ctx.args)
            if incidence is not None:
                grad = incidence_sum(cot, incidence)
            else:
                grad = assemble_node_grad(cot, conn, None, node.shape[0])
        else:
            cot = element_cotangent_plain(flat_gather(node, conn), ct,
                                          *ctx.args)
            grad = assemble_node_grad(cot, conn, incidence, node.shape[0])
        return grad, None, None, None, None, None, None, None


def element_energy(node: torch.Tensor, conn: torch.Tensor,
                   incidence: Optional[torch.Tensor], E: float, nu: float,
                   w_sum: float, edge_start: Optional[int] = None,
                   tw: float = 0.0) -> torch.Tensor:
    """Total energy of the elements ``conn`` over the packed node table
    ``node`` [N, 4], differentiable in ``node``.

    On the card the forward is kernel K1 and the backward kernel K2
    followed by the ``incidence_sum`` kernel (a scatter-add when
    ``incidence`` is None); on the CPU all three run their plain
    versions.
    """
    if node.is_cuda:
        node = node.contiguous()
    return _ElementEnergy.apply(node, conn, incidence, float(E), float(nu),
                                float(w_sum), edge_start, float(tw))
