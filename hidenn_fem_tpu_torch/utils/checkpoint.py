"""Checkpoint and resume for solve state (port of
``hidenn_fem_tpu/utils/checkpoint.py``).

``save_checkpoint`` writes ``(params, opt_state, step, metadata)`` to one
file by an atomic rename; ``restore_checkpoint`` reads it back, into the
structure of templates when they are given (checking every tensor's
shape); ``latest_checkpoint`` finds the highest step in a directory.

The JAX package writes flax msgpack (``ckpt_<step>.msgpack``).  The port
imports neither flax nor msgpack: it writes its own format with
``torch.save``, a dict of a magic string, a format version and the state
flattened to nested dicts of CPU tensors and Python scalars (named-tuple
fields by name, sequence entries by index, as flax's ``to_state_dict``
names them), read back with ``torch.load(weights_only=True)``.  The
files are ``ckpt_<step>.pt``.  Reading the JAX package's checkpoint files
is not supported.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Any, Optional, Tuple

import torch

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_checkpoint"]

_MAGIC = "HDNNTORCH"
_VERSION = 1
SUFFIX = ".pt"


def _to_state(tree):
    """Nested dicts of CPU tensors and Python scalars."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()
    if isinstance(tree, dict):
        return {str(k): _to_state(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {k: _to_state(getattr(tree, k)) for k in tree._fields}
    if isinstance(tree, (list, tuple)):
        return {str(i): _to_state(v) for i, v in enumerate(tree)}
    if tree is None or isinstance(tree, (bool, int, float, str)):
        return tree
    raise TypeError(f"cannot checkpoint a {type(tree).__name__}")


def _from_state(template, state, path="state"):
    """``state`` restored into the structure of ``template``: tensors on
    the template's device and dtype, shapes checked."""
    if isinstance(template, torch.Tensor):
        t = torch.as_tensor(state)
        if tuple(t.shape) != tuple(template.shape):
            raise ValueError(f"{path}: shape {tuple(t.shape)} in the "
                             f"checkpoint, {tuple(template.shape)} in the "
                             "template")
        return t.to(device=template.device, dtype=template.dtype)
    if isinstance(template, dict):
        return {k: _from_state(v, state[str(k)], f"{path}[{k!r}]")
                for k, v in template.items()}
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(**{
            k: _from_state(getattr(template, k), state[k], f"{path}.{k}")
            for k in template._fields})
    if isinstance(template, (list, tuple)):
        if len(state) != len(template):
            raise ValueError(f"{path}: {len(state)} entries in the "
                             f"checkpoint, {len(template)} in the template")
        return type(template)(_from_state(v, state[str(i)], f"{path}[{i}]")
                              for i, v in enumerate(template))
    if isinstance(template, (int, float)) and not isinstance(template, bool):
        return type(template)(state)
    return state


def save_checkpoint(path: str, params: Any, opt_state: Any = None,
                    step: int = 0, metadata: Optional[dict] = None) -> str:
    """Serialize solve state to ``path`` (atomic rename)."""
    payload = {
        "magic": _MAGIC, "version": _VERSION,
        "params": _to_state(params),
        "opt_state": (_to_state(opt_state) if opt_state is not None
                      else {}),
        "step": int(step),
        "metadata": json.dumps(metadata or {}),
    }
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def restore_checkpoint(path: str, params_template: Any = None,
                       opt_state_template: Any = None
                       ) -> Tuple[Any, Any, int, dict]:
    """Load (params, opt_state, step, metadata).

    If templates are given, the stored tensors are restored *into* their
    structure (the params dict, an optimizer state of the port such as
    ``CompactLBFGSState``, ``AdamState`` or the line-search L-BFGS
    state), on the templates' devices, validating shapes; otherwise the
    raw nested dicts are returned.
    """
    try:
        payload = torch.load(path, map_location="cpu", weights_only=True)
    except (RuntimeError, EOFError, pickle.UnpicklingError) as e:
        raise ValueError(f"{path} is not a hidenn_fem_tpu_torch "
                         f"checkpoint ({e})") from e
    if not isinstance(payload, dict) or payload.get("magic") != _MAGIC:
        raise ValueError(f"{path} is not a hidenn_fem_tpu_torch checkpoint")
    if payload["version"] != _VERSION:
        raise ValueError(f"{path}: checkpoint format version "
                         f"{payload['version']}, this package reads "
                         f"{_VERSION}")
    params = payload["params"]
    opt_state = payload["opt_state"]
    if params_template is not None:
        params = _from_state(params_template, params, "params")
    if opt_state_template is not None and opt_state:
        opt_state = _from_state(opt_state_template, opt_state, "opt_state")
    return (params, opt_state, int(payload["step"]),
            json.loads(payload["metadata"]))


def latest_checkpoint(directory: str, prefix: str = "ckpt_"
                      ) -> Optional[str]:
    """Highest-step ``{prefix}{step}.pt`` in ``directory`` (or None)."""
    if not os.path.isdir(directory):
        return None
    best, best_step = None, -1
    for name in os.listdir(directory):
        if name.startswith(prefix) and name.endswith(SUFFIX):
            try:
                step = int(name[len(prefix):-len(SUFFIX)])
            except ValueError:
                continue
            if step > best_step:
                best, best_step = os.path.join(directory, name), step
    return best
