"""The precision a reference computation runs in.

"float64" judges.  "tf32" is the control: the configuration states
float32 with TF32 off, and the nearest precision below is float32 whose
matrix products take TF32 operands, as an H100's tensor cores do when
``torch.backends.cuda.matmul.allow_tf32`` is on.  The rounding is done
here (round to nearest, ties away from zero, to TF32's 10 mantissa bits,
in the forward and the backward products), so the control does not hang
on which kernel cuBLAS picks for a shape.
"""

from __future__ import annotations

import torch


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 (10 explicit mantissa bits)."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


class _TF32MatMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ra, rb = round_tf32(a), round_tf32(b)
        ctx.save_for_backward(ra, rb)
        return torch.matmul(ra, rb)

    @staticmethod
    def backward(ctx, g):
        ra, rb = ctx.saved_tensors
        rg = round_tf32(g)
        return (torch.matmul(rg, rb.transpose(-1, -2)),
                torch.matmul(ra.transpose(-1, -2), rg))


class Precision:
    """``dtype`` and ``mm`` (a matrix product) of a reference run."""

    def __init__(self, name: str = "float64"):
        if name not in ("float64", "tf32"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name
        self.dtype = torch.float64 if name == "float64" else torch.float32

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.name == "tf32":
            return _TF32MatMul.apply(a, b)
        return torch.matmul(a, b)
