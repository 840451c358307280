"""The compact L-BFGS's two passes over its [2m, P] history
(``solve/optimizers.py``, ``CompactLBFGS.update``), as two kernels.

The JAX package leaves both products to XLA
(``hidenn_fem_tpu/solve/optimizers.py``: ``SY @ jnp.stack([y, s, g], 1)``
and ``gamma * g + coef @ SY``, at ``precision="highest"``); at the
~900K-element plates the history is ~1.5 GB of float32 and the two
products take most of a captured step's device time.  On the card they
are ``hidenn_fem_tpu_torch/csrc/lbfgs_history.cu`` (whose header gives
the design), float32 and float64 alike; on the CPU the wrappers run the
plain versions, which are the JAX package's expressions in torch.

* ``history_dots(SY, y, s, g)``: B [2m, 3] = SY @ [y, s, g];
* ``history_combine(SY, g, coef, gamma, scale)``: the [P] vector
  ``scale * (gamma * g + coef @ SY)`` (``scale`` a host float, 1 for the
  direction alone, ``-learning_rate`` for a fixed step; ``gamma`` a
  0-dim tensor on the history's device);
* ``history_dots_plain``, ``history_combine_plain``: the same in plain
  torch;
* ``launch_counts`` / ``reset_launch_counts``: one count a kernel
  launch, keys ``lbfgs_history_dots`` and ``lbfgs_history_combine``.

A wrapper takes the plain version only when its tensors lie on the CPU;
on CUDA tensors it launches its kernel (on the current stream, with no
host sync, so it records in a CUDA graph) or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .cuda_build import library, raise_on

__all__ = ["history_dots", "history_dots_plain", "history_combine",
           "history_combine_plain", "launch_counts", "reset_launch_counts"]

# launches of each kernel wrapper since the last reset
launch_counts = {"lbfgs_history_dots": 0, "lbfgs_history_combine": 0}

_DTYPES = (torch.float32, torch.float64)


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def history_dots_plain(SY, y, s, g) -> torch.Tensor:
    """B [2m, 3] = SY @ [y, s, g] in plain torch."""
    return SY @ torch.stack([y, s, g], dim=1)


def history_combine_plain(SY, g, coef, gamma, scale: float = 1.0
                          ) -> torch.Tensor:
    """``scale * (gamma * g + coef @ SY)`` in plain torch (no multiply
    when ``scale`` is 1)."""
    hg = gamma * g + coef @ SY
    return hg if scale == 1.0 else scale * hg


def _on_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _matrix(name, SY) -> tuple:
    """(2m, P) of SY; raises unless it is a contiguous, non-empty CUDA
    float32 or float64 matrix."""
    if SY.device.type != "cuda":
        raise ValueError(f"the {name} kernel takes CUDA tensors (SY is on "
                         f"{SY.device})")
    if SY.dtype not in _DTYPES or SY.dim() != 2 or not SY.is_contiguous() \
            or SY.numel() == 0:
        raise ValueError(f"{name}: SY must be a contiguous, non-empty "
                         "float32 or float64 [2m, P] tensor")
    return SY.shape


def _operands(name, SY, vectors, scalars=None) -> None:
    """Raise unless each of ``vectors`` ({name: (tensor, length)}) is a
    contiguous 1-D tensor of its length and each of ``scalars`` a 0-dim
    tensor, all of SY's dtype on SY's device."""
    for vname, (t, length) in vectors.items():
        if t.device != SY.device or t.dtype != SY.dtype \
                or t.shape != (length,) or not t.is_contiguous():
            raise ValueError(f"{name}: {vname} must be a contiguous "
                             f"[{length}] tensor of SY's dtype on SY's "
                             "device")
    for sname, t in (scalars or {}).items():
        if t.device != SY.device or t.dtype != SY.dtype or t.dim() != 0:
            raise ValueError(f"{name}: {sname} must be a 0-dim tensor of "
                             "SY's dtype on SY's device")


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = library("lbfgs_history")
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.hdnn_lbfgs_dots_blocks.argtypes = [i, ll, i]
    lib.hdnn_lbfgs_dots_blocks.restype = i
    lib.hdnn_lbfgs_history_dots.argtypes = [i, i, vp, vp, vp, vp, ll, i, vp,
                                            i, vp, vp]
    lib.hdnn_lbfgs_history_dots.restype = i
    lib.hdnn_lbfgs_history_combine.argtypes = [i, i, vp, vp, vp, vp,
                                               ctypes.c_double, ll, i, vp,
                                               vp]
    lib.hdnn_lbfgs_history_combine.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def _dots_blocks(device: int, p: int, is_double: int) -> int:
    return _library().hdnn_lbfgs_dots_blocks(device, p, is_double)


def history_dots(SY, y, s, g) -> torch.Tensor:
    """B [2m, 3] = SY @ [y, s, g]: the plain version on the CPU, else the
    dots kernel (columns B[:, 0] = SY y, B[:, 1] = SY s, B[:, 2] = SY g)."""
    if _on_cpu(SY, y, s, g):
        return history_dots_plain(SY, y, s, g)
    rows, p = _matrix("history_dots", SY)
    _operands("history_dots", SY, {"y": (y, p), "s": (s, p), "g": (g, p)})
    dev = SY.device
    is_double = int(SY.dtype == torch.float64)
    n_blocks = _dots_blocks(dev.index, p, is_double)
    partials = torch.empty(n_blocks * rows * 3, dtype=SY.dtype, device=dev)
    out = torch.empty((rows, 3), dtype=SY.dtype, device=dev)
    lib = _library()
    err = lib.hdnn_lbfgs_history_dots(
        dev.index, is_double, SY.data_ptr(), y.data_ptr(), s.data_ptr(),
        g.data_ptr(), p, rows, partials.data_ptr(), n_blocks,
        out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    raise_on(lib, err, "lbfgs_history_dots")
    launch_counts["lbfgs_history_dots"] += 1
    return out


def history_combine(SY, g, coef, gamma, scale: float = 1.0) -> torch.Tensor:
    """The [P] vector ``scale * (gamma * g + coef @ SY)``: the plain
    version on the CPU, else the combination kernel (the 2m rows summed
    in ascending order; gamma read on the device)."""
    if _on_cpu(SY, g, coef, gamma):
        return history_combine_plain(SY, g, coef, gamma, scale)
    rows, p = _matrix("history_combine", SY)
    _operands("history_combine", SY, {"g": (g, p), "coef": (coef, rows)},
              {"gamma": gamma})
    dev = SY.device
    out = torch.empty(p, dtype=SY.dtype, device=dev)
    lib = _library()
    err = lib.hdnn_lbfgs_history_combine(
        dev.index, int(SY.dtype == torch.float64), SY.data_ptr(),
        g.data_ptr(), coef.data_ptr(), gamma.data_ptr(), float(scale), p,
        rows, out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    raise_on(lib, err, "lbfgs_history_combine")
    launch_counts["lbfgs_history_combine"] += 1
    return out
