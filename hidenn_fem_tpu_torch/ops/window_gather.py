"""Windowed-gather probe K8 (port of ``tools/microbench_gather.py``:
``build_subblocks_pallas`` and the Pallas kernel ``pallas_masked_sq``).

The probe asks one question of a banded mesh: does reading each element's
corner rows through a small per-sub-block node window beat one flat
gather of the same rows?  It computes the sum of the squares of every
gathered row.  On the card the kernel is
``hidenn_fem_tpu_torch/csrc/window_gather.cu`` (whose header says how it
differs from the TPU's one-hot select); ``window_sq_plain`` is its plain
torch version and ``flat_sq_plain`` the flat-gather sum it is held to.

In this module:

* ``build_subblocks``: the sub-block tables (relT [S, 3, eb] int32
  relative to window block ``wblk`` [S] of ``wp`` rows, the padded row
  count ``npad``), as numpy, the JAX package's algorithm;
* ``pad_nodes``: the node table zero-padded to ``npad`` rows;
* ``window_sq`` (K8, CUDA float32 tensors only; each launch adds one to
  ``launch_counts``), ``window_sq_plain``, ``flat_sq_plain``.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .assembly import flat_gather
from .cuda_build import library, raise_on

__all__ = ["build_subblocks", "pad_nodes", "window_sq", "window_sq_plain",
           "flat_sq_plain", "launch_counts", "reset_launch_counts"]

# launches of the kernel wrapper since the last reset
launch_counts = {"window_sq": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def build_subblocks(conn: np.ndarray, n: int, eb: int):
    """Tables of the windowed gather for sub-blocks of ``eb`` elements
    (``Ne`` must be a multiple of ``eb``): (relT [S, 3, eb] int32, wblk [S]
    int32, wp, npad, S).  Sub-block i reads rows ``wblk[i]*wp + relT``
    (< 2 wp past its window block) of a node table padded to ``npad``
    rows."""
    conn = np.asarray(conn)
    ne = conn.shape[0]
    if ne % eb:
        raise ValueError(f"{ne} elements do not split into sub-blocks of "
                         f"{eb}")
    s = ne // eb
    c = conn.reshape(s, eb, 3)
    starts = c.min(axis=(1, 2)).astype(np.int32)
    span = int((c.max(axis=(1, 2)) - starts).max()) + 1
    wp = max(128, -(-span // 128) * 128)
    wblk = (starts // wp).astype(np.int32)
    rel = (c - (wblk * wp)[:, None, None]).astype(np.int32)
    assert rel.max() < 2 * wp
    relT = np.ascontiguousarray(np.swapaxes(rel, 1, 2))  # [S, 3, eb]
    npad = (-(-n // wp) + 1) * wp
    return relT, wblk, wp, npad, s


def pad_nodes(node: torch.Tensor, npad: int) -> torch.Tensor:
    """The [N, 4] node table zero-padded to [npad, 4]."""
    out = node.new_zeros((npad, node.shape[1]))
    out[:node.shape[0]] = node
    return out


def window_sq_plain(node_pad, relT, wblk, wp) -> torch.Tensor:
    """The function K8 computes, in plain torch: the sum of squares of the
    rows ``node_pad[wblk[i]*wp + relT[i, v, j]]``."""
    idx = wblk.long()[:, None, None] * wp + relT.long()
    g = flat_gather(node_pad, idx)
    return torch.sum(g * g)


def flat_sq_plain(node, conn) -> torch.Tensor:
    """The same sum through one flat gather ``node[conn]``."""
    g = flat_gather(node, conn)
    return torch.sum(g * g)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = library("window_gather")
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.hdnn_window_threads_per_block.argtypes = []
    lib.hdnn_window_threads_per_block.restype = i
    lib.hdnn_window_sq.argtypes = [i, vp, vp, vp, ll, i, i, vp, i, vp, vp]
    lib.hdnn_window_sq.restype = i
    return lib


def window_sq(node_pad, relT, wblk, wp) -> torch.Tensor:
    """K8 on the card: the sum of squares (0-dim float32 tensor) of the
    windowed rows.  The kernel reads the rows unchecked: the tables must
    come from ``build_subblocks`` and ``node_pad`` from ``pad_nodes`` with
    its ``npad``."""
    if not node_pad.is_cuda:
        raise ValueError("the window_sq kernel takes CUDA tensors")
    if node_pad.dtype != torch.float32 or node_pad.dim() != 2 \
            or node_pad.shape[1] != 4 or not node_pad.is_contiguous() \
            or node_pad.data_ptr() % 16:
        raise ValueError("node_pad must be a contiguous, 16-byte aligned "
                         "float32 [npad, 4] table")
    for name, t in (("relT", relT), ("wblk", wblk)):
        if t.device != node_pad.device or t.dtype != torch.int32 \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int32 tensor on "
                             "node_pad's device")
    n_sub, three, eb = relT.shape
    if three != 3 or wblk.shape != (n_sub,):
        raise ValueError("relT must be [S, 3, eb] and wblk [S]")
    lib = _library()
    n_part = -(-n_sub * eb // lib.hdnn_window_threads_per_block())
    dev = node_pad.device
    partials = torch.empty(n_part, dtype=torch.float32, device=dev)
    out = torch.empty((), dtype=torch.float32, device=dev)
    err = lib.hdnn_window_sq(dev.index, node_pad.data_ptr(), relT.data_ptr(),
                             wblk.data_ptr(), n_sub, eb, int(wp),
                             partials.data_ptr(), n_part, out.data_ptr(),
                             torch.cuda.current_stream(dev).cuda_stream)
    raise_on(lib, err, "window_sq")
    launch_counts["window_sq"] += 1
    return out
