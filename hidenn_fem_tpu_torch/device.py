"""Where the port's entry points put their tensors.

The JAX package puts its arrays on the default backend, the accelerator;
the port's entry points (mesh generators, ``TriMesh.from_arrays``, the
converters, the models' ``init``) put theirs on the card unless the caller
names another device.  There is no fallback: without a card, making a
tensor there raises torch's own error.  Internal helpers follow the device
of the tensors they are given.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means the card (``cuda``)."""
    return torch.device("cuda" if device is None else device)
