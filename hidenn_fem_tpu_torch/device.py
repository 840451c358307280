"""Where the port's entry points put their tensors.

The JAX package puts its arrays on the default backend, the accelerator;
the port's entry points (mesh generators, ``TriMesh.from_arrays``, the
converters, the models' ``init``) put theirs on the card unless the caller
names another device.  There is no fallback: without a card, making a
tensor there raises torch's own error.  Internal helpers follow the device
of the tensors they are given.
"""

from __future__ import annotations

import functools

import torch

__all__ = ["resolve_device", "constant"]


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means the card (``cuda``)."""
    return torch.device("cuda" if device is None else device)


@functools.lru_cache(maxsize=None)
def constant(values: tuple, dtype: torch.dtype,
             device: torch.device) -> torch.Tensor:
    """A device copy of a tuple of host constants (a model's fixed grid
    or mask, a quadrature rule), made once per (values, dtype, device).

    A copy from pageable host memory waits for the card's stream to
    drain, so one made on every call would serialize a training loop.
    Every caller gets the same tensor: never write to it."""
    return torch.tensor(values, dtype=dtype, device=device)
